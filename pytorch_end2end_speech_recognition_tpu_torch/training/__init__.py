"""Training: the hybrid loss, schedules and optimizers, and the Solver."""
