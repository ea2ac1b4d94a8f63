"""Device milliseconds a traced step in the `train.backward` phase: the
backward of the whole step; phase time: by the outermost `train.*` span
open when each operation was launched (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train", ["train.backward"], by="phase")
