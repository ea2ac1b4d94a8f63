"""Device milliseconds a traced request in every E-Branchformer block's
merge (`asr.merge`: the branches' concatenation, mask and depthwise
convolution, the residual inside, the projection, the block's residual
add); self time: by the innermost span whose code launched each operation
(`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.merge"])
