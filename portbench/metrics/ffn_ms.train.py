"""Device milliseconds a traced step in both FFN halves of every block
(`asr.ffn`), forward and backward; self time: by the innermost span
whose code launched each operation; the backward's by the forward
operation's span (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train", ["asr.ffn"])
