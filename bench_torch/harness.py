"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic. The harness
finds everything else by name, in files of its own:

* ``workloads/<cell>.json``: the cell's traffic parameters, with the
  name of their ``generator``;
* ``traffic/<generator>.py``: ``generate(params, seed, device)`` -> the
  inputs as uint8[docs, bytes] on the host;
* ``configs/<config>.json`` and ``configs/<config>.py``: the deployment,
  and its driver ``make(data, seed, device, control)`` -> a
  :class:`Session` (the calls, the bytes they need, the check against the
  plain reference in ``configs/<config>_ref.py``);
* ``metrics/<metric>.py``: ``read(ctx)`` -> the metric's value, or None
  where the run holds nothing to read. A metric ``<stem>.<qualifier>``
  (one quantity split by the cells that report it) is read by
  ``metrics/<stem>.py`` unless a file of its own full name is there.

A run builds its data from the seed, stages it, warms up the cell's own
shapes (all of that is ``setup_s``), calls the entry back to back for the
window, reads the device's memory peak, frees the program's state but the
sampled outputs, and checks the answers against the reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: names of the profiler ranges the harness records in a traced run
WINDOW_RANGE = "bench_torch.window"
CALL_RANGE = "bench_torch.call"
#: calls that raise before the window gives up
MAX_FAILED_CALLS = 100
#: the longest window a traced run records: its per-layer ratios are
#: steady over ~10^4 calls, and reading a longer trace takes minutes
TRACE_SECONDS = 10.0
#: calls before the window: the first builds the library where the
#: checkout has none, loads it and meets every shape of the cell
WARM_CALLS = 3


def prepare_process() -> None:
    """What a run's process sets before its first torch call: one thread
    for torch's host ops (the caller is one thread; a pool only adds the
    wake-ups of its threads to each small host copy). The port keeps its
    one build cache at a fixed path inside the checkout
    (``build/simdutf_tpu_torch/``)."""
    import torch

    torch.set_num_threads(1)


def load_module(path: Path, name: str):
    """The module in ``path`` (names may hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(cell: str) -> SimpleNamespace:
    """The cell's entries of ``BENCHMARK.json`` and its files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    wl = cells[cell]
    traffic = json.loads((HERE / "workloads" / f"{cell}.json").read_text())

    def reports(m: dict) -> bool:
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return SimpleNamespace(name=cell, chips=int(wl["chips"]), config=wl["config"],
                           traffic=traffic, end_to_end=e2e, per_layer=layer)


class Reservoir:
    """A sample of ``k`` of the items offered, each equally likely, drawn
    from ``seed``: the outputs a run keeps for the check."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Session:
    """What a configuration's driver gives the harness. ``entry`` is the
    callable the window drives (the program's, or its control path)."""

    #: bytes the calls since the last :meth:`reset` need at the least
    #: (input read once, output written once): the roofline's numerator
    needed_bytes = 0

    def call(self, i: int) -> int:
        """Make call ``i``; it ends when its answer is on the host.
        Returns the call's input bytes."""
        raise NotImplementedError

    def reset(self) -> None:
        """Forget the calls made so far (after the warm-up)."""
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's state but what :meth:`check` needs."""

    def check(self) -> tuple[dict, int, list]:
        """({name: (value, limit)}, calls known wrong, notes) against the
        plain reference."""
        raise NotImplementedError


def run_window(session: Session, seconds: float, annotate: bool = False) -> SimpleNamespace:
    """Calls back to back until ``seconds`` have passed; each call's time
    runs from its start to its answer on the host."""
    if annotate:
        from torch.profiler import record_function
    clock = time.perf_counter
    call_s: list[float] = []
    failed, first_error = 0, None
    nbytes = 0
    i = 0
    t0 = clock()
    end = t0 + seconds
    while True:
        s = clock()
        try:
            if annotate:
                with record_function(CALL_RANGE):
                    nbytes += session.call(i)
            else:
                nbytes += session.call(i)
        except Exception:  # a call that raises is a failed call
            failed += 1
            first_error = first_error or traceback.format_exc()
        e = clock()
        call_s.append(e - s)
        i += 1
        if e >= end or failed >= MAX_FAILED_CALLS:
            break
    return SimpleNamespace(window_s=e - t0, calls=i, call_s=call_s,
                           input_bytes=nbytes, raised=failed, first_error=first_error)


def power_limit_w():
    """The card's power limit in W by ``nvidia-smi``, None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def peaks_of(kind: str):
    """The card's published peaks from ``peaks.json``, None if unlisted."""
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def metric_reader(name: str):
    """The module that reads metric ``name``: ``metrics/<name>.py``, or
    ``metrics/<stem>.py`` for ``<stem>.<qualifier>``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"bench_torch.metrics.{path.stem}")


def read_metrics(metrics: list, ctx) -> dict:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", control: bool = False,
             traffic: dict | None = None, patch=None) -> dict:
    """One run of ``cell``; returns the result line as a dict. ``control``
    drives the configuration's control path instead of the program's entry;
    ``traffic`` overrides traffic parameters and ``patch(session)`` may
    change the session before the warm-up (both for tests on the CPU)."""
    import torch

    c = load_cell(cell)
    gen_params = dict(c.traffic, **(traffic or {}))
    gen = load_module(HERE / "traffic" / f"{gen_params['generator']}.py",
                      f"bench_torch.traffic.{gen_params['generator']}")
    cfg = load_module(HERE / "configs" / f"{c.config}.py", f"bench_torch.configs.{c.config}")
    cuda = torch.device(device).type == "cuda"

    marks = [("imports", time.perf_counter())]
    data = gen.generate(gen_params, seed, device)
    marks.append(("data", time.perf_counter()))
    session = cfg.make(data, seed, device, control)
    if patch is not None:
        patch(session)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("staging", time.perf_counter()))
    for i in range(WARM_CALLS):
        session.call(i)
    session.reset()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))

    # the imports' objects out of the collector's scans: a full collection
    # over them would stall a call by tens of ms
    gc.collect()
    gc.freeze()
    marks.append(("collect", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("setup: " + ", ".join(f"{k} {t - p!r} s" for (k, t), p in
                                zip(marks, [t_start] + [m[1] for m in marks])), file=sys.stderr)
    tsum = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from bench_torch import devtrace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW_RANGE):
                w = run_window(session, min(seconds, TRACE_SECONDS), annotate=True)
        tsum = devtrace.summarize(prof, WINDOW_RANGE, CALL_RANGE)
    else:
        w = run_window(session, seconds)
    needed = session.needed_bytes
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"window: {w.calls} calls in {w.window_s!r} s, {w.input_bytes} input bytes; "
          f"each call's host time is a tail sample ({len(w.call_s)} samples, "
          f"{len(w.call_s) // 20} beyond the 95th percentile)", file=sys.stderr)
    if len(w.call_s) >= 1000:
        q = statistics.quantiles(w.call_s, n=1000)
        print(f"call ms: p50 {q[499] * 1e3!r}, p90 {q[899] * 1e3!r}, p99 {q[989] * 1e3!r}, "
              f"p99.9 {q[998] * 1e3!r}, max {max(w.call_s) * 1e3!r}", file=sys.stderr)
    if w.first_error:
        print(f"{w.raised} calls raised; the first:\n{w.first_error}", file=sys.stderr)

    session.release()
    compared, wrong, notes = session.check()
    for note in notes:
        print(note, file=sys.stderr)
    correct = w.raised == 0 and all(v <= lim for v, lim in compared.values())

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = SimpleNamespace(setup_s=setup_s, window_s=w.window_s, calls=w.calls,
                          call_s=w.call_s, input_bytes=w.input_bytes,
                          needed_bytes=needed, trace=tsum, peaks=peaks_of(kind))
    metrics = read_metrics(c.per_layer if trace else c.end_to_end, ctx)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": c.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if cuda else None}
    print(f"device: {kind}, power limit {dev['power_limit_w']} W, "
          f"memory peak {peak} B", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": w.calls,
              "failed": min(w.calls, wrong + w.raised), "metrics": metrics, "device": dev}
    if tsum is not None:
        dev["busy_s"] = tsum.busy_s
        dev["window_s"] = tsum.window_s
        result["breakdown"] = {"device_ops": tsum.top_ops, "idle_gaps": tsum.top_gaps}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result
