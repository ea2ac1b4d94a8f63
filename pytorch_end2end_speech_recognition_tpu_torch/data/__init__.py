"""Data: the host-side batch the Solver takes."""
