"""Device milliseconds a traced request in self-attention: every block's
`asr.mhsa` (layer norm, q, k, v, o, the attention kernel) and the
relative bias's expansion (`asr.rel_bias`); self time: by the innermost
span whose code launched each operation (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.mhsa", "asr.rel_bias"])
