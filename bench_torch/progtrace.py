"""The program's own spans and counters in a traced run.

The port records them while a ``torch.profiler`` records
(``simdutf_tpu_torch.trace``): spans ``simdutf.<layer>.<name>`` with their
calls, total and self host-clock ns, a count of the host's syncs on the
device and of the launches of each C entry point. The traced window is the
only time a run's profiler records, and the warm-up before it records
nothing, so the program's snapshot after the window holds the window's
calls alone. A program without that module, or a run that recorded no
span, gives None: the metrics that read it are then left out of the line.
"""

from __future__ import annotations


def snapshot(ctx):
    """The program's snapshot of the traced window, or None where the run
    was not traced, made no call, or the program recorded no span."""
    if ctx.trace is None or ctx.calls <= 0:
        return None
    try:
        from simdutf_tpu_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap["spans"] else None


def self_us(ctx, layer: str):
    """Host self time a call, in us, of the spans ``simdutf.<layer>.*``:
    their time less what their program child spans cover, so that the
    layers' times add up without counting any stretch twice."""
    snap = snapshot(ctx)
    if snap is None:
        return None
    prefix = f"simdutf.{layer}."
    ns = sum(s["self_ns"] for name, s in snap["spans"].items() if name.startswith(prefix))
    return ns / ctx.calls / 1e3


def per_call(ctx, counter: str):
    """A counter of the snapshot (a number, or a dict of numbers summed)
    a call."""
    snap = snapshot(ctx)
    if snap is None:
        return None
    value = snap[counter]
    total = sum(value.values()) if isinstance(value, dict) else value
    return total / ctx.calls
