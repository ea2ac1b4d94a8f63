"""Device milliseconds a traced step in the `train.put` phase: the batch's
copies to the card; phase time: by the outermost `train.*` span open
when each operation was launched (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train", ["train.put"], by="phase")
