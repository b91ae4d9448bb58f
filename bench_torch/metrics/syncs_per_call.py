"""syncs_per_call: the points a call where the program blocks the host on
the device (its ``syncs`` counter over the traced window's calls)."""

from bench_torch import progtrace


def read(ctx):
    return progtrace.per_call(ctx, "syncs")
