"""call_ms_p95: the 95th percentile of every call's host-clock time, from
the call until its answer is on the host, in ms."""

import statistics


def read(ctx):
    if len(ctx.call_s) < 2:
        return None
    return statistics.quantiles(ctx.call_s, n=20)[18] * 1e3
