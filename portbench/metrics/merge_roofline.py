"""Percent of its roofline of the merge of every E-Branchformer block,
read by the span `asr.merge` whatever kernels run inside it:
`counts/merge` of the traced cycle's requests over the span's self
device time (`portbench/spans.py`), as `ffn_roofline` reads the FFN.
Only a cycle that ran to its end is read: where the window closed
inside it, or the program has no such span, nothing."""

from portbench.roofline import least_seconds
from portbench.spans import cycle_of


def read(ctx):
    if ctx.mix["mode"] != "serve":
        return None
    cyc = cycle_of(ctx)
    if (cyc is None or cyc.self_us.get("asr.merge", 0.0) <= 0
            or not ctx.tracer.finished.issuperset(cyc.steps)):
        return None
    least = sum(least_seconds(ctx.count("merge", ctx.batches[k]))
                for k in cyc.steps)
    return 100.0 * least / (cyc.self_us["asr.merge"] / 1e6)
