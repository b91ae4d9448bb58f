"""census_checked_pct: None where the program counts nothing, the share
where it does, and the counts of a traced call on the CPU (where the plain
census checks every chunk)."""

from types import SimpleNamespace

import pytest

from bench_torch import harness

SPANS = {"simdutf.route.utf8.to_utf16": {"count": 4, "total_ns": 4000, "self_ns": 1000,
                                         "parents": {None: 4}}}


def read(snap, monkeypatch):
    from simdutf_tpu_torch import trace

    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    return harness.metric_reader("census_checked_pct").read(
        SimpleNamespace(trace=object(), calls=4))


@pytest.mark.parametrize("snap", [
    {"spans": SPANS, "syncs": 4, "launches": {}},  # a program without counts
    {"spans": SPANS, "syncs": 4, "launches": {}, "counts": {}},
    {"spans": {}, "syncs": 0, "launches": {}, "counts": {"census.chunks": 8}},
])
def test_none_without_counts(snap, monkeypatch):
    assert read(snap, monkeypatch) is None


def test_share_of_the_chunks(monkeypatch):
    snap = {"spans": SPANS, "syncs": 4, "launches": {},
            "counts": {"census.checked_chunks": 3, "census.chunks": 200}}
    assert read(snap, monkeypatch) == 1.5


def test_a_traced_cpu_call_checks_every_chunk():
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from simdutf_tpu_torch import impl, trace
    from simdutf_tpu_torch.ops import utf8 as o8

    buf, n = impl._pad(np.frombuffer("héllo 東京 ".encode() * 100, np.uint8))
    x, n = impl.to_device(buf.copy(), n, "cpu")
    o8.to_utf16(x, n, False)
    with profile(activities=[ProfilerActivity.CPU]):
        o8.to_utf16(x, n, False)
    assert trace.snapshot()["counts"]["census.chunks"] == (n + 15) // 16
    assert harness.metric_reader("census_checked_pct").read(
        SimpleNamespace(trace=object(), calls=1)) == 100.0
