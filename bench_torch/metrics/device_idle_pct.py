"""device_idle_pct: the share of the traced window in which no device
operation runs, from the union of the trace's device intervals."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.device_ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
