"""roofline_pct: the bytes the window's calls need at the least (each
input read once, each output's out_len elements written once; the
configuration's ``needed_bytes``) over the card's published HBM rate, as a
share of the device's busy time in the traced window (the union of its
kernels, copies and memsets)."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.peaks or t.busy_s <= 0 or ctx.needed_bytes <= 0:
        return None
    return 100.0 * ctx.needed_bytes / ctx.peaks["hbm_bytes_per_s"] / t.busy_s
