"""The port's spans and counters (``simdutf_tpu_torch.trace``) on the CPU:
off with no profiler, on under one, nested by layer, with a count of the
host's reads of the device and of the kernels' launches."""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simdutf_tpu_torch import impl, trace
from simdutf_tpu_torch.impl import TorchImplementation
from simdutf_tpu_torch.kernels import _build
from simdutf_tpu_torch.ops import base64_ops as ob
from simdutf_tpu_torch.ops import utf8 as o8

TEXT = "héllo wörld, привет, مرحبا, 東京 🙂 " * 20
B8 = np.frombuffer(TEXT.encode(), np.uint8)
B16 = np.frombuffer(TEXT.encode("utf-16-le"), np.uint16)
B32 = np.frombuffer(TEXT.encode("utf-32-le"), np.uint32)
L1 = np.frombuffer("héllo wörld ÿ".encode("latin-1") * 20, np.uint8)
B64 = np.frombuffer(b"aGVsbG8gd29ybGQh\r\nSGVsbG8=", np.uint8)


def staged(data: np.ndarray):
    buf, n = impl._pad(data)
    return impl.to_device(buf.copy(), n, "cpu")


def profiled(call):
    """(call's result, the snapshot of the profiled call)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call()
    return got, trace.snapshot(), prof


def spans_of(snap):
    return snap["spans"]


def test_off_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(trace, "_RecordFunctionFast",
                        lambda name: made.append(name) or pytest.fail("made"))
    trace.reset()
    assert trace.span("simdutf.x") is trace.OFF
    with trace.span("simdutf.x"):
        pass
    x, n = staged(B8)
    o8.to_utf16(x, n, False)
    assert trace.sync("s", int, torch.tensor(3)) == 3
    trace.launch("census_utf8")
    trace.count("census.chunks", 4)
    assert made == []
    assert trace.snapshot() == {"spans": {}, "syncs": 0, "launches": {}, "counts": {}}


def test_route_spans_nest_by_layer():
    x, n = staged(B8)
    o8.to_utf16(x, n, False)
    _, snap, _ = profiled(lambda: o8.to_utf16(x, n, False))
    spans = spans_of(snap)
    route = "simdutf.route.utf8.to_utf16"
    children = ["simdutf.kernel.census.census_bits", "simdutf.sync.utf8.census",
                "simdutf.kernel.compose16.to_utf16_compose"]
    assert set(spans) == {route, *children}
    assert spans[route]["parents"] == {None: 1}
    for name in children:
        assert spans[name]["parents"] == {route: 1}, name
        assert spans[name]["count"] == 1
    for s in spans.values():
        assert 0 <= s["self_ns"] <= s["total_ns"]
    inner = sum(spans[c]["total_ns"] for c in children)
    assert inner <= spans[route]["total_ns"]
    assert spans[route]["self_ns"] == spans[route]["total_ns"] - inner
    assert snap["syncs"] == 1
    assert snap["launches"] == {}  # the CPU runs the plain versions


def test_decode_route_reads_nothing_back():
    x, n = staged(np.frombuffer(b"aGVsbG8gd29ybGQh" * 50, np.uint8))
    call = lambda: ob.decode_bulk_routed(x, n, False, False)  # noqa: E731
    call()
    _, snap, _ = profiled(call)
    assert "simdutf.route.base64_ops.decode_bulk_routed" in spans_of(snap)
    assert "simdutf.kernel.compact64.compact_codes" in spans_of(snap)
    assert "simdutf.kernel.base64_kernel.pack" in spans_of(snap)
    assert snap["syncs"] == 0


def test_spans_are_cpu_ops_not_annotations():
    """Each program span is a ``cpu_op`` event in the profiler's trace, not
    a user annotation, so the profiler makes no device copy of it."""
    x, n = staged(B8)
    o8.to_utf16(x, n, False)
    _, snap, prof = profiled(lambda: o8.to_utf16(x, n, False))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace.PREFIX)}
    assert set(events) == set(spans_of(snap))
    for name, e in events.items():
        assert not e.is_user_annotation(), name
        assert e.scope() == 0, name  # RecordScope.FUNCTION


def test_second_session_starts_from_zero():
    x, n = staged(B8)
    call = lambda: o8.to_utf16(x, n, False)  # noqa: E731
    call()
    _, first, _ = profiled(lambda: [call(), call()])
    assert first["spans"]["simdutf.route.utf8.to_utf16"]["count"] == 2
    assert first["syncs"] == 2
    call()  # a call with no profiler: the next record begins anew
    _, second, _ = profiled(call)
    assert second["spans"]["simdutf.route.utf8.to_utf16"]["count"] == 1
    assert second["syncs"] == 1
    trace.reset()  # or an explicit reset between two profiled stretches
    assert trace.snapshot() == {"spans": {}, "syncs": 0, "launches": {}, "counts": {}}
    _, third, _ = profiled(call)
    assert third["spans"]["simdutf.route.utf8.to_utf16"]["count"] == 1


def test_snapshot_outlives_the_profiler():
    x, n = staged(B8)
    o8.to_utf16(x, n, False)
    _, snap, _ = profiled(lambda: o8.to_utf16(x, n, False))
    o8.to_utf16(x, n, False)  # unprofiled: clears nothing until the next record
    assert trace.snapshot() == snap


def test_an_untraced_thread_clears_nothing():
    """The profiler traces the thread that started it; the port's calls in
    another thread neither record nor clear the traced thread's spans."""
    x, n = staged(B8)
    o8.to_utf16(x, n, False)
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait()
        for _ in range(3):
            o8.to_utf16(x, n, False)
        done.set()

    t = threading.Thread(target=other)
    t.start()

    def both():
        o8.to_utf16(x, n, False)
        started.set()
        done.wait()
        o8.to_utf16(x, n, False)

    _, snap, _ = profiled(both)
    t.join()
    assert snap["spans"]["simdutf.route.utf8.to_utf16"]["count"] == 2
    assert snap["syncs"] == 2


def test_glue_spans():
    ti = TorchImplementation("cpu")
    ti.convert_utf8_to_utf16le_with_errors(B8)
    (res, out), snap, _ = profiled(lambda: ti.convert_utf8_to_utf16le_with_errors(B8))
    assert res.is_ok and out.tobytes() == TEXT.encode("utf-16-le")
    spans = spans_of(snap)
    assert spans["simdutf.glue.stage"]["parents"] == {None: 1}
    assert spans["simdutf.glue.result"]["count"] == 2  # the scalars, then the cut
    assert spans["simdutf.sync.impl.scalars"]["parents"] == {"simdutf.glue.result": 1}
    assert spans["simdutf.sync.impl.cut"]["parents"] == {"simdutf.glue.result": 1}
    assert snap["syncs"] == 3  # the census bits, the scalars, the output


def test_build_call_counts_every_launch(monkeypatch):
    """``_build.call`` counts each launch by its C entry point: a two-pass
    kernel counts two."""

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    _build.call("census_utf8")
    trace.reset()
    _, snap, _ = profiled(lambda: [_build.call("composex_count"), _build.call("composex_emit"),
                                   _build.call("census_utf8")])
    assert snap["launches"] == {"composex_count": 1, "composex_emit": 1, "census_utf8": 1}


def test_count_records_only_under_a_profiler():
    """``trace.count`` adds to ``counts`` while a profiler records, and
    leaves the syncs and launches as they are."""
    trace.count("x", 5)  # no profiler: nothing
    _, snap, _ = profiled(lambda: [trace.count("x", 2), trace.count("x", 3),
                                   trace.count("y", 1)])
    assert snap["counts"] == {"x": 5, "y": 1}
    assert snap["syncs"] == 0 and snap["launches"] == {}
    trace.count("x", 7)  # after the profiler: nothing
    assert trace.snapshot()["counts"] == {"x": 5, "y": 1}


def test_count_off_is_one_flag_check(monkeypatch):
    """With no profiler, ``trace.count`` reads the profiler's flag once and
    touches no thread state."""
    trace.span("simdutf.x")  # a call with no profiler ends this thread's record
    checks = []
    monkeypatch.setattr(trace, "_enabled", lambda: checks.append(1) or False)
    monkeypatch.setattr(trace, "_thread", lambda: pytest.fail("thread state touched"))
    trace.count("census.chunks", 3)
    assert checks == [1]
    assert trace.recording() is False
    assert checks == [1, 1]


def test_counts_sum_across_threads(monkeypatch):
    """``snapshot()["counts"]`` sums each recording thread's counts."""
    local = threading.local()
    monkeypatch.setattr(trace, "_enabled", lambda: getattr(local, "on", False))

    def record(k):
        local.on = True
        trace.count("census.chunks", k)
        trace.count("census.checked_chunks", 1)
        local.on = False
        trace.count("census.chunks", 100)  # off again: not counted

    trace.reset()
    local.on = True
    trace.count("census.chunks", 2)
    t = threading.Thread(target=record, args=(5,))
    t.start()
    t.join()
    snap = trace.snapshot()
    local.on = False
    trace.count("census.chunks", 100)
    assert snap["counts"] == {"census.chunks": 7, "census.checked_chunks": 1}
    assert snap["syncs"] == 0 and snap["launches"] == {}


@pytest.mark.parametrize("route,data,site", [
    ("utf8", B8, "utf8.census"), ("latin1", L1, "latin1.census")])
def test_census_counts_its_chunks(route, data, site):
    """A census-routed call counts the census's checked and in-range
    chunks in its one read: on the CPU the plain census checks them all."""
    import importlib

    mod = importlib.import_module(f"simdutf_tpu_torch.ops.{route}")
    x, n = staged(data)
    call = (lambda: mod.to_utf16(x, n, False)) if route == "utf8" else (  # noqa: E731
        lambda: mod.to_utf8(x, n))
    call()
    _, snap, _ = profiled(call)
    chunks = (len(data) + 15) // 16
    assert snap["counts"] == {"census.checked_chunks": chunks, "census.chunks": chunks}
    assert snap["syncs"] == 1
    assert snap["spans"][f"simdutf.sync.{site}"]["count"] == 1


#: each ops function that impl.py calls, and a TorchImplementation call that
#: reaches it
ROUTES = [
    ("utf8.validate_ascii_with_errors", "validate_ascii_with_errors", B8),
    ("utf8.validate_with_errors", "validate_utf8_with_errors", B8),
    ("utf8.count_code_points", "count_utf8", B8),
    ("utf8.utf16_length", "utf16_length_from_utf8", B8),
    ("utf8.to_utf16", "convert_utf8_to_utf16le_with_errors", B8),
    ("utf8.to_utf16_valid", "convert_valid_utf8_to_utf16le", B8),
    ("utf8.to_utf32", "convert_utf8_to_utf32_with_errors", B8),
    ("utf8.to_utf32_valid", "convert_valid_utf8_to_utf32", B8),
    ("utf8.to_latin1", "convert_utf8_to_latin1_with_errors", B8),
    ("utf8.to_latin1_valid", "convert_valid_utf8_to_latin1", B8),
    ("utf16.validate_with_errors", "validate_utf16le_with_errors", B16),
    ("utf16.count_code_points", "count_utf16le", B16),
    ("utf16.utf8_length", "utf8_length_from_utf16le", B16),
    ("utf16.to_utf8", "convert_utf16le_to_utf8_with_errors", B16),
    ("utf16.to_utf8_valid", "convert_valid_utf16le_to_utf8", B16),
    ("utf16.to_utf32", "convert_utf16le_to_utf32_with_errors", B16),
    ("utf16.to_utf32_valid", "convert_valid_utf16le_to_utf32", B16),
    ("utf16.to_latin1", "convert_utf16le_to_latin1_with_errors", B16),
    ("utf16.to_latin1_valid", "convert_valid_utf16le_to_latin1", B16),
    ("utf16.change_endianness", "change_endianness_utf16", B16),
    ("utf16.to_well_formed", "to_well_formed_utf16le", B16),
    ("utf32.validate_with_errors", "validate_utf32_with_errors", B32),
    ("utf32.utf8_length", "utf8_length_from_utf32", B32),
    ("utf32.utf16_length", "utf16_length_from_utf32", B32),
    ("utf32.to_utf8", "convert_utf32_to_utf8_with_errors", B32),
    ("utf32.to_utf8_valid", "convert_valid_utf32_to_utf8", B32),
    ("utf32.to_utf16", "convert_utf32_to_utf16le_with_errors", B32),
    ("utf32.to_utf16_valid", "convert_valid_utf32_to_utf16le", B32),
    ("utf32.to_latin1", "convert_utf32_to_latin1_with_errors", B32),
    ("utf32.to_latin1_valid", "convert_valid_utf32_to_latin1", B32),
    ("latin1.to_utf8", "convert_latin1_to_utf8", L1),
    ("latin1.to_utf16", "convert_latin1_to_utf16le", L1),
    ("latin1.to_utf32", "convert_latin1_to_utf32", L1),
    ("detect.detect_encodings", "detect_encodings", B8),
    ("base64_ops.decode_bulk_routed", "base64_to_binary_details", B64),
    ("base64_ops.encode_bulk", "binary_to_base64", B8),
]


def _impl_routes() -> set:
    """``<module>.<function>`` of every ops function that impl.py calls."""
    tree = ast.parse(Path(impl.__file__).read_text())
    aliases = {a.asname or a.name: a.name for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom) and node.module == "ops"
               for a in node.names}
    return {f"{aliases[n.value.id]}.{n.attr}" for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id in aliases}


def test_every_routed_function_is_spanned():
    assert _impl_routes() == {r for r, _, _ in ROUTES}
    assert len(ROUTES) == 36


@pytest.mark.parametrize("route,method,data", ROUTES, ids=[r for r, _, _ in ROUTES])
def test_route_span_recorded(route, method, data):
    import importlib

    mod, fn = route.split(".")
    f = getattr(importlib.import_module(f"simdutf_tpu_torch.ops.{mod}"), fn)
    assert f.span_name == f"simdutf.route.{route}"
    ti = TorchImplementation("cpu")
    call = lambda: getattr(ti, method)(data)  # noqa: E731
    call()
    _, snap, _ = profiled(call)
    assert snap["spans"][f"simdutf.route.{route}"]["count"] == 1
    assert snap["spans"]["simdutf.glue.stage"]["count"] >= 1
    assert snap["syncs"] >= 1


def test_device_counter_absent_when_nothing_records():
    """With no profiler, ``device_counter`` gives None and keeps nothing;
    the snapshot holds no such count."""
    trace.reset()
    assert trace.device_counter("dev.x", "cpu") is None
    assert "dev.x" not in trace.snapshot()["counts"]


def test_device_counter_sums_over_calls_and_starts_anew():
    """A recording's first request makes the counter, zeroed, later
    requests give the same tensor, and the snapshot reads the adds of
    every call; the next recording starts from a new counter."""
    def calls(adds):
        got = []
        for k in adds:
            c = trace.device_counter("dev.x", "cpu")
            c += k  # what a kernel adds on the device
            got.append(c)
        assert all(c is got[0] for c in got)
        return got[0]

    trace.span("simdutf.x")  # a call with no profiler ends any record
    first_counter, first, _ = profiled(lambda: calls([3, 4, 5]))
    assert first["counts"] == {"dev.x": 12}
    trace.span("simdutf.x")
    second_counter, second, _ = profiled(lambda: calls([2]))
    assert second["counts"] == {"dev.x": 2} and second_counter is not first_counter


def test_device_counter_read_once_a_use(monkeypatch):
    """``snapshot`` reads a counter from the device once after the calls
    that used it, not at every snapshot."""
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda t: reads.append(1) or item(t))
    trace.span("simdutf.x")
    with profile(activities=[ProfilerActivity.CPU]):
        c = trace.device_counter("dev.y", "cpu")
        c += 6
    assert trace.snapshot()["counts"] == {"dev.y": 6}
    assert trace.snapshot()["counts"] == {"dev.y": 6}
    assert reads == [1]
    with profile(activities=[ProfilerActivity.CPU]):  # no call between: the same record
        trace.device_counter("dev.y", "cpu").add_(1)
    assert trace.snapshot()["counts"] == {"dev.y": 7}
    assert reads == [1, 1]
