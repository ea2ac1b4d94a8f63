"""Device milliseconds a traced request in every E-Branchformer block's
cgMLP branch (`asr.cgmlp`: layer norm, the first linear and GELU, the gate
half's layer norm, mask and depthwise convolution, the gate product, the
second linear); self time: by the innermost span whose code launched each
operation (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.cgmlp"])
