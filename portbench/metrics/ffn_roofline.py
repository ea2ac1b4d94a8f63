"""Percent of their roofline of both FFN halves of every block, read by
the span `asr.ffn` whatever kernels run inside it: `counts/ffn` of the
traced cycle's requests over the span's self device time
(`portbench/spans.py`). Only a cycle that ran to its end is read: where
the window closed inside it, nothing."""

from portbench.roofline import least_seconds
from portbench.spans import cycle_of


def read(ctx):
    if ctx.mix["mode"] != "serve":
        return None
    cyc = cycle_of(ctx)
    if (cyc is None or cyc.self_us.get("asr.ffn", 0.0) <= 0
            or not ctx.tracer.finished.issuperset(cyc.steps)):
        return None
    least = sum(least_seconds(ctx.count("ffn", ctx.batches[k]))
                for k in cyc.steps)
    return 100.0 * least / (cyc.self_us["asr.ffn"] / 1e6)
