"""exact_chunks_pct: the share of the first-event kernel's in-range
16-byte chunks that ran its exact event lattice over the traced window
(the program's counts ``validate.exact_chunks``, added on the device, over
``validate.chunks``). A program that does not count them gives None."""

from bench_torch import progtrace


def read(ctx):
    snap = progtrace.snapshot(ctx)
    if snap is None:
        return None
    counts = snap.get("counts", {})
    chunks = counts.get("validate.chunks", 0)
    if not chunks or "validate.exact_chunks" not in counts:
        return None
    return 100.0 * counts["validate.exact_chunks"] / chunks
