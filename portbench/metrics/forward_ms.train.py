"""Device milliseconds a traced step in the `train.forward` and
`train.loss` phases: encoder, heads, decoder and the hybrid loss,
forward only; phase time: by the outermost `train.*` span open when each
operation was launched (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train", ["train.forward", "train.loss"],
                       by="phase")
