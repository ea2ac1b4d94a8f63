"""Device milliseconds a traced request in the log-mel frontend and CMVN
(`asr.frontend`); self time: by the innermost span whose code launched
each operation (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.frontend"])
