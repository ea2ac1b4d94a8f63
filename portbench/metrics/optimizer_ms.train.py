"""Device milliseconds a traced step in the `train.optimizer` phase: global
norm, clip and AdamW; phase time: by the outermost `train.*` span open
when each operation was launched (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train", ["train.optimizer"], by="phase")
