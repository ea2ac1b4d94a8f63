"""Percent of its roofline of the log-mel kernel (`logmel_*`), over the
profiled requests: `counts/logmel`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "logmel_" in n, "logmel")
