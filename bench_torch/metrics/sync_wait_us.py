"""sync_wait_us: host time a call blocked on the device at the program's
own reads, in us: the program's ``simdutf.sync.*`` spans (the census
bits' read-back waits for the census kernel), in the traced window."""

from bench_torch import progtrace


def read(ctx):
    return progtrace.self_us(ctx, "sync")
