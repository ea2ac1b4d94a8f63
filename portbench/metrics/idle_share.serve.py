"""Percent of the traced spans in which no operation ran on the device
(1 - the union of device operations / the spans)."""


def read(ctx):
    t = ctx.tracer
    if t is None or ctx.mix["mode"] != "serve" or t.window_s() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
