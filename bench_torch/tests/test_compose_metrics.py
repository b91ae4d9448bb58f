"""passglue_host_us and fill_pct on fabricated contexts: None where the
program records nothing for them, the value where it does."""

from types import SimpleNamespace

import pytest

from bench_torch import harness

ROUTE = {"simdutf.route.utf16.to_utf8": {"count": 4, "total_ns": 40000, "self_ns": 8000,
                                         "parents": {None: 4}}}
GLUE = {"simdutf.passglue.tile_glue": {
    "count": 4, "total_ns": 6000, "self_ns": 6000,
    "parents": {"simdutf.kernel.compose8.to_utf8_compose": 4}}}


def read(name, snap, monkeypatch, calls=4, needed=1000, traced=True):
    from simdutf_tpu_torch import trace

    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    ctx = SimpleNamespace(trace=object() if traced else None, calls=calls, needed_bytes=needed)
    return harness.metric_reader(name).read(ctx)


@pytest.mark.parametrize("snap", [
    {"spans": ROUTE, "syncs": 4, "launches": {}, "counts": {}},  # a program without the span
    {"spans": {}, "syncs": 0, "launches": {}, "counts": {}},
])
def test_passglue_none_without_its_span(snap, monkeypatch):
    assert read("passglue_host_us", snap, monkeypatch) is None


def test_passglue_self_time_a_call(monkeypatch):
    snap = {"spans": dict(ROUTE, **GLUE), "syncs": 4, "launches": {}, "counts": {}}
    assert read("passglue_host_us", snap, monkeypatch) == 1.5
    assert read("passglue_host_us", snap, monkeypatch, traced=False) is None


@pytest.mark.parametrize("snap,needed", [
    ({"spans": ROUTE, "syncs": 4, "launches": {}}, 1000),  # a program without counts
    ({"spans": ROUTE, "syncs": 4, "launches": {}, "counts": {"census.chunks": 3}}, 1000),
    ({"spans": ROUTE, "syncs": 4, "launches": {}, "counts": {"compose.fill_bytes": 9}}, 0),
])
def test_fill_none_without_its_counter(snap, needed, monkeypatch):
    assert read("fill_pct", snap, monkeypatch, needed=needed) is None


def test_fill_share_of_needed_bytes(monkeypatch):
    snap = {"spans": dict(ROUTE, **GLUE), "syncs": 4, "launches": {},
            "counts": {"compose.fill_bytes": 736}}
    assert read("fill_pct", snap, monkeypatch, needed=1000) == pytest.approx(73.6)
