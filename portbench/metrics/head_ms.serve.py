"""Device milliseconds a traced request in the float32 CTC head
(`asr.ctc_head`) and greedy decoding (`asr.greedy`); self time: by the
innermost span whose code launched each operation
(`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["asr.ctc_head", "asr.greedy"])
