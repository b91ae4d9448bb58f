"""Reduction of a torch.profiler trace to what the per-layer metrics read.

The device rows are the trace's kernels, copies and memsets (the
arithmetic of the repo's ``chip_smoke.device_rows``, kept here). The
device's busy time is the union of their intervals inside the window, not
the sum of the rows; each idle gap between them is labelled by the
innermost host range that was open at its middle (an aten op, a CUDA
runtime call, or the harness's call range when the host ran Python
between ops).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from types import SimpleNamespace

#: CUDA runtime and driver calls (host ranges, whatever device a trace files
#: them under)
_API_CALL = re.compile(r"^cu(da)?[A-Z]")
#: how far back a gap's label is looked for among the host ranges
_LABEL_SCAN = 4096
TOP = 10
NAME_CHARS = 160  # a breakdown's names are cut to this length


def _events(prof, skip: set):
    """(name, start_ns, end_ns, on_device) of the trace's device rows
    (kernels, copies, memsets) and host ranges (ops, runtime calls and
    annotations). The device-side copies of the annotations named in
    ``skip`` are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        on_device = e.device_type() == DeviceType.CUDA and not _API_CALL.match(name)
        if on_device and name in skip:
            continue
        out.append((name, s, s + e.duration_ns(), on_device))
    return out


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gaps(merged, lo: int, hi: int):
    """The stretches of [lo, hi] that no merged interval covers."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def label_of(host, starts, t: int, call_range: str) -> str:
    """The innermost host range open at ``t``; ``host`` sorted by start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _LABEL_SCAN, -1), -1):
        name, s, e = host[j]
        if e >= t:
            return f"{name} (python)" if name == call_range else name
    return "between calls"


def reduce_events(events, window_range: str, call_range: str) -> SimpleNamespace:
    """See the module docstring. ``events`` as :func:`_events` gives them."""
    wins = [(s, e) for name, s, e, dev in events if not dev and name == window_range]
    if not wins:
        raise ValueError(f"the trace holds no {window_range!r} range")
    lo, hi = wins[0]
    calls = sum(1 for name, s, e, dev in events
                if not dev and name == call_range and lo <= s <= hi)
    dev_ev = [(name, max(s, lo), min(e, hi)) for name, s, e, d in events
              if d and e > lo and s < hi]
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in dev_ev:
        by_name[name] += (e - s) / 1e9
    merged = merge([(s, e) for _, s, e in dev_ev])
    busy_ns = sum(e - s for s, e in merged)

    host = sorted(((name, s, e) for name, s, e, d in events
                   if not d and name != window_range), key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle: dict[str, float] = defaultdict(float)
    for s, e in gaps(merged, lo, hi):
        idle[label_of(host, starts, (s + e) // 2, call_range)] += (e - s) / 1e9

    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return SimpleNamespace(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, calls=calls,
                           device_ops=len(dev_ev), top_ops=top(by_name), top_gaps=top(idle))


def summarize(prof, window_range: str, call_range: str) -> SimpleNamespace:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``."""
    return reduce_events(_events(prof, {window_range, call_range}), window_range,
                         call_range)
