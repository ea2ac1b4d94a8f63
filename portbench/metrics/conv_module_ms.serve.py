"""Device milliseconds a traced request in every block's convolution module
(`asr.conv`: pointwise and GLU, depthwise, layer norm, pointwise); self
time: by the innermost span whose code launched each operation
(`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.conv"])
