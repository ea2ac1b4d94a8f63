"""The plain references that decide whether a run is correct: plain
PyTorch in float32, independent of the measured program. One module a
model family (`<family>.py`, named by a configuration's `family`), and
what the families share (`common`)."""
