"""How the benchmark drives the program's own path for each model family:
one module a family (`<family>.py`, named by a configuration's
`family`)."""
