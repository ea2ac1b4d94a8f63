"""Device milliseconds a traced request in the self time of `asr.block`:
each block's final layer norm and cast, outside its four modules; self
time: by the innermost span whose code launched each operation
(`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.block"])
