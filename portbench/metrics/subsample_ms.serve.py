"""Device milliseconds a traced request in the x4 convolution subsampling
and its projection (`asr.subsample`); self time: by the innermost span
whose code launched each operation (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.subsample"])
