"""Device milliseconds a traced request in both FFN halves of every block
(`asr.ffn`); self time: by the innermost span whose code launched each
operation (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.ffn"])
