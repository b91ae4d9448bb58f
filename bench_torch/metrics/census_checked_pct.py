"""census_checked_pct: the share of the census's in-range 16-byte chunks
that ran its positional checks over the traced window (the program's
counts ``census.checked_chunks`` over ``census.chunks``). A program that
does not count them gives None."""

from bench_torch import progtrace


def read(ctx):
    snap = progtrace.snapshot(ctx)
    if snap is None:
        return None
    counts = snap.get("counts", {})
    chunks = counts.get("census.chunks", 0)
    if not chunks:
        return None
    return 100.0 * counts.get("census.checked_chunks", 0) / chunks
