"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W limit) and the share of a roofline: the least time the chip could
take for the counted work, max(operations / peak of their precision,
bytes / HBM bandwidth), over the device time the work took."""

from __future__ import annotations

PEAKS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(work: dict) -> float:
    return max(work["flops"] / PEAKS[work["precision"]],
               work["bytes"] / HBM_BYTES_PER_S)


def share(ctx, pred, count_name: str):
    """Percent of the roofline of the kernels whose short name satisfies
    `pred`, over the profiled steps; None where they did not run."""
    if ctx.tracer is None:
        return None
    t = ctx.tracer.kernel_seconds(pred)
    if t <= 0:
        return None
    least = sum(least_seconds(ctx.count(count_name, b))
                for b in ctx.profiled())
    return 100.0 * least / t


def mfu(ctx):
    """Percent of the bf16 peak over the traced spans: the model's counted
    FLOPs of the profiled requests or steps over the spans' seconds, as the
    device trace times them (idle included); None without a trace."""
    if ctx.tracer is None or ctx.tracer.window_s() <= 0:
        return None
    flops = sum(ctx.model_count(b)["flops"] for b in ctx.profiled())
    return 100.0 * flops / (ctx.tracer.window_s() * PEAKS["bf16"])
