"""The plain reference that decides whether a run is correct: plain
PyTorch in float32, independent of the measured program (see `model`)."""
