"""Seconds from the start of the process to the first timed request or
step: imports, the kernel library's build or load, the model, weights,
the pool, the warm-up (or the compared first steps)."""


def read(ctx):
    return ctx.setup_s
