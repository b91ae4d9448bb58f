"""Spans and counters of the port's layers, recorded while a
``torch.profiler`` records.

Recording is on exactly while a profiler is active
(``torch._C._autograd._profiler_enabled()``): profile a service with
``torch.profiler`` and the port's layers appear in its trace, on the
trace's own clock beside the device rows. Nothing else turns it on.

* :func:`span` (and the decorators :func:`route`, :func:`kernel` and
  :func:`spanned`) opens a ``simdutf.<layer>.<name>`` range. Off, it is one
  shared no-op context. On, it is a ``torch._C._profiler._RecordFunctionFast``
  range (a ``cpu_op`` event: no ``record_function`` user annotation, so the
  profiler makes no device copy of it and the device rows are those of the
  work alone), and it adds to the aggregates below.
* :func:`sync` makes a device-to-host read (or wait) that blocks the host,
  inside a ``simdutf.sync.<site>`` span, and counts it in ``syncs``.
* :func:`launch` counts one launch of a C entry point in
  ``launches[<entry>]`` (``kernels/_build.call`` makes every launch).
* :func:`count` adds to a named counter of the program's own, in
  ``counts[<name>]`` (the census's checked and in-range chunks; the
  bytes a compose wrapper zero-fills before its emit pass,
  ``compose.fill_bytes``).
  :func:`recording` says whether a profiler records, for a site that
  computes what it counts only then.
* :func:`device_counter` gives a counter that kernels add to on the
  device (the first-event kernel's exact chunks), so that counting reads
  nothing back inside a call: made anew when recording begins, read once
  by :func:`snapshot` into ``counts[<name>]``.

The layers: ``glue`` (``impl.py``: staging, results back on the host),
``route`` (each ``ops`` function that ``impl.py`` calls), ``kernel`` (each
kernel wrapper that launches a C entry point; on the CPU it runs the plain
version, inside the same span), ``passglue`` (``ops/common.tile_glue``:
the torch ops between a two-pass kernel's count and emit passes, inside
its wrapper's span), ``sync``.

:func:`snapshot` returns what was recorded since recording last began:
the aggregates are cleared at the first span or count seen while a
profiler records, after one seen (in a thread that recorded) while none
did, or after :func:`reset`. Per span name: calls,
total ns, self ns (the total less what the span's program child spans
cover) and the names of the enclosing program spans, by host clock
(``time.perf_counter_ns``).
"""

from __future__ import annotations

import functools
import threading
from time import perf_counter_ns

import torch

_enabled = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast

PREFIX = "simdutf."

_tls = threading.local()
_lock = threading.Lock()
#: threads that recorded and have not yet made a call with no profiler
_live = 0
#: set when such a thread makes one: the next record starts a generation
_stale = True
_gen = 0
_threads: list = []  # the _Thread of each thread that recorded in this generation


class _Thread:
    """One thread's span stack and aggregates (no lock on the hot path;
    :func:`snapshot` merges the aggregates of this generation's
    threads)."""

    __slots__ = ("on", "stack", "gen", "spans", "syncs", "launches", "counts", "devcounts")

    def __init__(self):
        self.on = False
        self.stack: list = []
        self.gen = -1
        self.spans: dict = {}  # name -> [count, total_ns, self_ns, {parent: count}]
        self.syncs = 0
        self.launches: dict = {}
        self.counts: dict = {}
        # (name, device) -> [int64[1] tensor, value last read, unread adds]
        self.devcounts: dict = {}


def _recording() -> bool:
    """Whether a profiler records in this thread. Where none does, a thread
    that recorded before makes the next record begin anew (the profiler's
    state is per thread: a thread it does not trace neither records nor
    clears)."""
    global _live, _stale
    if _enabled():
        return True
    if _live:
        t = getattr(_tls, "t", None)
        if t is not None and t.on:
            with _lock:
                t.on = False
                _live -= 1
                _stale = True
    return False


def _thread() -> _Thread:
    """This thread's state while a profiler records, its aggregates
    cleared where recording has begun anew since it last recorded."""
    global _live, _stale, _gen
    t = getattr(_tls, "t", None)
    if t is None:
        t = _tls.t = _Thread()
    if _stale or not t.on:
        with _lock:
            if _stale:
                _gen += 1
                _threads.clear()
                _stale = False
            if not t.on:
                t.on = True
                _live += 1
    if t.gen != _gen:
        with _lock:
            t.gen = _gen
            t.spans = {}
            t.syncs = 0
            t.launches = {}
            t.counts = {}
            t.devcounts = {}
            _threads.append(t)
    return t


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "inner", "rf", "t0", "th")

    def __init__(self, name: str):
        self.name = name
        self.inner = 0

    def __enter__(self):
        self.th = th = _thread()
        stack = th.stack
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0 = perf_counter_ns()
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        dt = perf_counter_ns() - self.t0
        th = self.th
        stack = th.stack
        stack.pop()
        if stack:
            stack[-1].inner += dt
        agg = th.spans.get(self.name)
        if agg is None:
            agg = th.spans[self.name] = [0, 0, 0, {}]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self.inner
        agg[3][self.parent] = agg[3].get(self.parent, 0) + 1
        return False


def span(name: str):
    """A context that records the span ``name`` while a profiler records,
    and the shared no-op :data:`OFF` otherwise."""
    return _Span(name) if _recording() else OFF


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        traced.span_name = name
        return traced

    return deco


def _layer_name(layer: str, fn) -> str:
    return f"{PREFIX}{layer}.{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"


def route(fn):
    """Decorator of an ``ops`` function: the span
    ``simdutf.route.<module>.<function>``."""
    return spanned(_layer_name("route", fn))(fn)


def kernel(fn):
    """Decorator of a kernel wrapper: the span
    ``simdutf.kernel.<module>.<function>``."""
    return spanned(_layer_name("kernel", fn))(fn)


def sync(site: str, op, x):
    """``op(x)``: a read of device tensor ``x`` onto the host (``int``,
    ``torch.Tensor.tolist``, ``torch.Tensor.cpu``) or another wait of the
    host for the device, inside the span ``simdutf.sync.<site>``, counted
    in ``syncs``. Counted on every device, so that CPU runs show the same
    count as the card."""
    if not _recording():
        return op(x)
    with _Span(PREFIX + "sync." + site) as sp:
        out = op(x)
    sp.th.syncs += 1
    return out


def launch(entry: str) -> None:
    """Count one launch of C entry point ``entry``."""
    if not _recording():
        return
    counts = _thread().launches
    counts[entry] = counts.get(entry, 0) + 1


def count(name: str, k: int) -> None:
    """Add ``k`` to the counter ``name``."""
    if not _recording():
        return
    counts = _thread().counts
    counts[name] = counts.get(name, 0) + k


def device_counter(name: str, device):
    """While a profiler records, this recording's counter ``name`` on
    ``device``: a one-element int64 tensor, zeros made at its first
    request, that kernels add to on the device and that :func:`snapshot`
    reads once, after the calls, into ``counts[name]``. None while no
    profiler records."""
    if not _recording():
        return None
    slots = _thread().devcounts
    key = (name, str(torch.device(device)))
    slot = slots.get(key)
    if slot is None:
        slot = slots[key] = [torch.zeros(1, dtype=torch.int64, device=device), 0, True]
    slot[2] = True  # the caller launches with it: snapshot reads it again
    return slot[0]


#: whether the spans and counters record now (a profiler records)
recording = _recording


def reset() -> None:
    """Clear the aggregates now: for two profiled stretches with no call
    of the port between them that the profiler did not record."""
    global _gen
    with _lock:
        _gen += 1
        _threads.clear()


def snapshot() -> dict:
    """What was recorded since recording last began, over every thread, as
    plain data: ``{"spans": {name: {"count", "total_ns", "self_ns",
    "parents": {enclosing span name or None: count}}}, "syncs": int,
    "launches": {entry: count}, "counts": {name: int}}``. ``counts`` holds
    the device counters too, each read from the device (a wait for the
    work queued before the read) the first time after a call used it."""
    spans: dict = {}
    syncs = 0
    launches: dict = {}
    counts: dict = {}
    with _lock:
        threads = list(_threads)
    for t in threads:
        syncs += t.syncs
        for entry, k in list(t.launches.items()):
            launches[entry] = launches.get(entry, 0) + k
        for name, k in list(t.counts.items()):
            counts[name] = counts.get(name, 0) + k
        for (name, _), slot in list(t.devcounts.items()):
            if slot[2]:
                slot[2] = False
                slot[1] = int(slot[0].item())
            counts[name] = counts.get(name, 0) + slot[1]
        for name, (c, tot, self_ns, parents) in list(t.spans.items()):
            agg = spans.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0,
                                          "parents": {}})
            agg["count"] += c
            agg["total_ns"] += tot
            agg["self_ns"] += self_ns
            for p, k in list(parents.items()):
                agg["parents"][p] = agg["parents"].get(p, 0) + k
    return {"spans": spans, "syncs": syncs, "launches": launches, "counts": counts}
