"""fill_pct: the bytes the compose wrappers zero-fill before their emit
pass (the program's count ``compose.fill_bytes``), as a share of the bytes
the window's calls need at the least (the configuration's
``needed_bytes``), in the traced window. A program that does not count
them gives None."""

from bench_torch import progtrace


def read(ctx):
    snap = progtrace.snapshot(ctx)
    if snap is None or ctx.needed_bytes <= 0:
        return None
    filled = snap.get("counts", {}).get("compose.fill_bytes")
    if filled is None:
        return None
    return 100.0 * filled / ctx.needed_bytes
