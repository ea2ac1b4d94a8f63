"""The 95th percentile, over every request of the window, of the time from
its submission to its token ids on the host."""

import statistics


def read(ctx):
    lat = ctx.window.get("latencies") or []
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
