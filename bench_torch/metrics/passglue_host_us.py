"""passglue_host_us: host time a call between a two-pass kernel's count
and emit passes, in us: the self time of the program's
``simdutf.passglue.*`` spans (``ops/common.tile_glue``'s torch ops on the
per-tile vectors), in the traced window. A program without that span
gives None."""

from bench_torch import progtrace

PREFIX = "simdutf.passglue."


def read(ctx):
    snap = progtrace.snapshot(ctx)
    if snap is None or not any(name.startswith(PREFIX) for name in snap["spans"]):
        return None
    return progtrace.self_us(ctx, "passglue")
