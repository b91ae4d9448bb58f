"""The metrics that read the program's own spans and counters: None where
there is nothing to read, the right arithmetic on a snapshot, and a traced
run on the CPU (where each kernel runs its plain version, so nothing
launches)."""

import time
from types import SimpleNamespace

import pytest

from bench_torch import harness

READERS = ["route_host_us", "kernel_host_us", "sync_wait_us", "syncs_per_call",
           "launches_per_call"]

SNAP = {
    "spans": {
        "simdutf.route.utf8.to_utf16": {"count": 4, "total_ns": 4000_000,
                                        "self_ns": 1000_000, "parents": {None: 4}},
        "simdutf.kernel.census.census_bits": {"count": 4, "total_ns": 800_000,
                                              "self_ns": 800_000, "parents": {}},
        "simdutf.kernel.compose16.to_utf16_compose": {"count": 4, "total_ns": 1200_000,
                                                      "self_ns": 1200_000, "parents": {}},
        "simdutf.sync.utf8.census": {"count": 4, "total_ns": 1000_000,
                                     "self_ns": 1000_000, "parents": {}},
    },
    "syncs": 4,
    "launches": {"census_utf8": 4, "compose16": 4},
}


def reader(name):
    return harness.metric_reader(name).read


@pytest.fixture
def snapshot(monkeypatch):
    from simdutf_tpu_torch import trace

    def use(snap):
        monkeypatch.setattr(trace, "snapshot", lambda: snap)
    return use


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace_or_a_span(name, snapshot):
    snapshot(SNAP)
    assert reader(name)(SimpleNamespace(trace=None, calls=4)) is None
    snapshot({"spans": {}, "syncs": 0, "launches": {}})
    assert reader(name)(SimpleNamespace(trace=object(), calls=4)) is None


def test_readings_of_a_snapshot(snapshot):
    snapshot(SNAP)
    ctx = SimpleNamespace(trace=object(), calls=4)
    assert reader("route_host_us")(ctx) == 250.0
    assert reader("kernel_host_us")(ctx) == 500.0
    assert reader("sync_wait_us")(ctx) == 250.0
    assert reader("syncs_per_call")(ctx) == 1.0
    assert reader("launches_per_call")(ctx) == 2.0
    for stem in ("route_host_us", "kernel_host_us", "launches_per_call"):
        assert reader(f"{stem}.decode")(ctx) == reader(stem)(ctx)


def test_none_without_the_module(monkeypatch):
    """A program with no trace module (the parent of the tracing change)
    gives None and does not raise."""
    import builtins

    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "simdutf_tpu_torch" and fromlist and "trace" in fromlist:
            raise ImportError("no trace")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    ctx = SimpleNamespace(trace=object(), calls=4)
    assert all(reader(n)(ctx) is None for n in READERS)


SMALL = {"utf8_to_utf16.mixed_64m": {"doc_bytes": 48000, "page_bytes": 4000},
         "base64_mime.decode_48m": {"raw_bytes": 30000}}


def traced(cell):
    return harness.run_cell(cell, 2**31 + 9, 0.3, True, t_start=time.perf_counter(),
                            device="cpu", traffic=SMALL[cell])["metrics"]


def test_traced_cpu_run():
    m = traced("utf8_to_utf16.mixed_64m")
    assert m["syncs_per_call"]["value"] == 1
    assert m["launches_per_call"]["value"] == 0
    for name in ("route_host_us", "kernel_host_us", "sync_wait_us"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "us"
    again = traced("utf8_to_utf16.mixed_64m")
    assert again["syncs_per_call"] == m["syncs_per_call"]
    assert again["launches_per_call"] == m["launches_per_call"]
    d = traced("base64_mime.decode_48m")
    assert d["launches_per_call.decode"]["value"] == 0
    assert d["route_host_us.decode"]["value"] > 0 and d["kernel_host_us.decode"]["value"] > 0
    assert "syncs_per_call" not in d
