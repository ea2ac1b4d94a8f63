"""The model FLOPs of the traced requests or steps (the configuration's
`serve` count, from real lengths) over the traced spans' seconds, as a
percent of the H100's bf16 peak."""

from portbench.roofline import mfu


def read(ctx):
    if ctx.mix["mode"] != "serve":
        return None
    return mfu(ctx)
