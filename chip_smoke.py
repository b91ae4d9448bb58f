#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (simdutf_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each fatal on failure:
  1. device  - name, compute capability (must be 9.0), nvidia-smi power limit;
  2. build   - nvcc builds csrc/*.cu into one library;
  3. parity  - every Hopper kernel against its plain torch version on the
               card, bit for bit: each UTF-8 class, errors at tile edges,
               at 0, at length-1 and at length, ragged lengths, LE and BE,
               small buffers and the 64 MiB corpus;
  4. slice   - the public simdutf_tpu api with TorchImplementation("cuda")
               installed, on the 64 MiB mixed corpus (bench.mixed_corpus),
               against CPython's codecs and the golden tier, plus the
               uniform classes and the zh profile; every kernel must have
               launched during the main-path calls;
  5. times   - device-resident kernels and the transcode against their
               plain versions, with CUDA events.

The last line of stdout is {"ok": true, "device": {...}}; it is printed
only when every phase passed. Without CUDA the script exits with code 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

MIB = 1 << 20
CORPUS_BYTES = 64 * MIB - 4096  # bench.py's flagship size (bucket = 64 MiB)
SEED = 20261016
PASSES = ("census_utf8", "utf8_first_event", "utf8_count",
          "utf8_to_utf16_compose")
KERNELS = {  # name -> (source, Pallas kernel replaced, also replaced)
    "census_utf8": ("simdutf_tpu_torch/csrc/census.cu",
                    "simdutf_tpu/kernels/census.py:204", []),
    "utf8_first_event": ("simdutf_tpu_torch/csrc/validate.cu",
                         "simdutf_tpu/kernels/validate.py:415",
                         ["simdutf_tpu/kernels/validate.py:438"]),
    "utf8_count": ("simdutf_tpu_torch/csrc/validate.cu",
                   "simdutf_tpu/kernels/validate.py:471", []),
    "utf8_to_utf16_compose": ("simdutf_tpu_torch/csrc/compose16.cu",
                              "simdutf_tpu/kernels/butterfly.py:554",
                              ["simdutf_tpu/kernels/butterfly.py:691"]),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


# --- inputs ----------------------------------------------------------------

_ALPHABET = ["a", " ", "é", "ß", "Ж", "م", "東", "京", "\U0001f642", "𝄞"]
_BAD = [b"\x80", b"\xbf", b"\xff", b"\xf8", b"\xc0\xaf", b"\xc1\xbf",
        b"\xe0\x80\x80", b"\xed\xa0\x80", b"\xe6\x9d", b"\xf4\x90\x80\x80",
        b"\xf0\x8f\xbf\xbf", b"\xf0\x9f", b"\xc3"]


def utf8_from_codepoints(cps):
    """Vectorised UTF-8 encoding of a numpy array of scalar values."""
    import numpy as np

    cps = np.asarray(cps, np.int64)
    nb = 1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
    start = np.cumsum(nb) - nb
    out = np.zeros(int(nb.sum()), np.uint8)
    lead_bits = np.array([0, 0x00, 0xC0, 0xE0, 0xF0])
    shift = 6 * (nb - 1)
    out[start] = (lead_bits[nb] | (cps >> shift)).astype(np.uint8) & 0xFF
    for k in (1, 2, 3):
        m = nb > k
        out[start[m] + k] = 0x80 | ((cps[m] >> (6 * (nb[m] - 1 - k))) & 0x3F)
    return out.tobytes()


def profile_corpus(profile, nbytes: int, seed: int) -> bytes:
    """Text drawn from a tools/gen_corpus profile with numpy: code points
    from the weighted ranges (surrogates skipped), ASCII spaces after 12%
    of them when the profile mixes ranges, cut to whole code points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = nbytes  # at least one byte per code point: enough draws
    weights = np.array([w for _, w in profile], float)
    which = rng.choice(len(profile), size=k, p=weights / weights.sum())
    lo = np.array([r[0] for r, _ in profile])[which]
    hi = np.array([r[1] for r, _ in profile])[which]
    cps = lo + (rng.random(k) * (hi - lo + 1)).astype(np.int64)
    cps = cps[(cps < 0xD800) | (cps > 0xDFFF)]
    if len(profile) > 1:
        space = rng.random(len(cps)) < 0.12
        cps = np.stack([cps, np.where(space, 0x20, -1)], 1).reshape(-1)
        cps = cps[cps >= 0]
    return _whole(utf8_from_codepoints(cps)[:nbytes])


def _whole(data: bytes) -> bytes:
    """``data`` without an incomplete sequence at its end."""
    import numpy as np

    from simdutf_tpu.golden import utf8 as g8

    return data[: g8.trim_partial(np.frombuffer(data, np.uint8))]


def class_corpus(ch: str, nbytes: int) -> bytes:
    unit = ch.encode()
    return unit * (nbytes // len(unit))


def parity_cases(big: int):
    """(name, data bytes, buffer size) for the kernel parity phase."""
    import numpy as np

    import bench

    rng = np.random.default_rng(SEED)
    cases = []
    for cls, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"), ("u4", "🙂")):
        for size in (1, 4096 * 3 + 17, 100_003):
            cases.append((f"{cls}-{size}", class_corpus(ch, size)))
    mixed = _whole(bench.mixed_corpus(300_000))
    cases.append(("mixed-300k", mixed))
    cases.append(("empty", b""))
    # errors at compose tile edges (4096), at 0, at length-1, cut at length
    for pos in (0, 1, 4094, 4095, 4096, 4097, 8191, 8192, 12287):
        for bad in (b"\xff", b"\x80", b"\xed\xa0\x80", b"\xf0\x9f"):
            d = bytearray(mixed[:20_000])
            d[pos:pos + len(bad)] = bad
            cases.append((f"err{bad.hex()}@{pos}", bytes(d)))
    cases.append(("err@len-1", mixed[:9_999] + b"\xc3"))
    cases.append(("cut4@len", mixed[:9_000] + "🙂".encode()[:3]))
    cases.append(("lead4@len-1", mixed[:8_191] + b"\xf0"))
    # random mixtures of every class with invalid sequences
    for t in range(40):
        size = int(rng.integers(1, 70_000))
        parts = [_ALPHABET[i].encode()
                 for i in rng.integers(0, len(_ALPHABET), size)]
        d = bytearray(b"".join(parts)[:size])
        for _ in range(int(rng.integers(0, 3)) if t % 2 else 0):
            p = int(rng.integers(0, len(d) + 1))
            d[p:p] = _BAD[int(rng.integers(len(_BAD)))]
        cases.append((f"fuzz{t}", bytes(d)))
    corpus = bench.mixed_corpus(big)
    cases.append(("mixed-64MiB", corpus))
    bad = bytearray(corpus)
    bad[big // 2 + 1] = 0xFF
    cases.append(("mixed-64MiB-err", bytes(bad)))

    out = []
    for i, (name, data) in enumerate(cases):
        n = len(data)
        # buffer: exact, bucket-padded, or padded with garbage past length
        pad = (0, 8, 1000 + i)[i % 3]
        out.append((name, data, n + pad, i % 3 == 2))
    return out


# --- phases ------------------------------------------------------------------

def device_phase():
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {name}, capability {cap}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {card}")
    check(cap == (9, 0), f"needs compute capability (9, 0), found {cap}")
    return name, card


def build_phase():
    from simdutf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")


def _max_err(a, b) -> int:
    """Largest absolute difference between two results (tuples of 0-d
    tensors and arrays); shapes must agree."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    worst = 0
    for x, y in zip(a, b):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.dtype == torch.uint16:
            x = x.view(torch.int16).to(torch.int64) & 0xFFFF
            y = y.view(torch.int16).to(torch.int64) & 0xFFFF
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def parity_phase(device, big: int = CORPUS_BYTES) -> dict:
    """Each kernel against its plain version on ``device``; returns the
    largest error seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import compose16 as kc
    from simdutf_tpu_torch.kernels import validate as kv

    errs = dict.fromkeys(PASSES, 0)
    cases = parity_cases(big)
    for name, data, n, garbage in cases:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        buf[:L] = np.frombuffer(data, np.uint8)
        if garbage:
            buf[L:] = np.random.default_rng(L).integers(0, 256, n - L)
        x = torch.from_numpy(buf).to(device)
        got = {
            "census_utf8": (kcen.census_bits(x, L), kcen.census_bits_ref(x, L)),
            "utf8_first_event": (
                kv.utf8_first_event_len(x, L) + kv.utf8_first_event(x),
                kv.utf8_first_event_len_ref(x, L)
                + kv.utf8_first_event_len_ref(x, n)),
            "utf8_count": (
                tuple(kv._count_call(x, L, w) for w in kv._MODES),
                tuple(kv.count_ref(x, L, w) for w in kv._MODES)),
            "utf8_to_utf16_compose": (
                kc.to_utf16_compose(x, L, False) + kc.to_utf16_compose(x, L, True),
                kc.to_utf16_compose_ref(x, L, False)
                + kc.to_utf16_compose_ref(x, L, True)),
        }
        if x.is_cuda:
            torch.cuda.synchronize()
        for k, (kern, plain) in got.items():
            e = _max_err(kern, plain)
            errs[k] = max(errs[k], e)
            check(e == 0, f"parity {k} on {name} (n={n}, length={L}): "
                          f"max abs err {e}")
    log(f"parity: {len(cases)} inputs, every kernel bit-identical to its "
        f"plain version (LE and BE)")
    return errs


def slice_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The public api with the port installed; returns the launch count
    of each kernel during the main-path calls."""
    import numpy as np

    import bench
    import simdutf_tpu as su
    from simdutf_tpu.errors import error_code as ec
    from simdutf_tpu.golden import utf8 as g8
    from tools.gen_corpus import PROFILES

    import simdutf_tpu_torch
    from simdutf_tpu_torch.kernels import _build

    su.set_active_implementation(simdutf_tpu_torch.TorchImplementation(device))
    data = bench.mixed_corpus(big)
    want = data.decode("utf-8").encode("utf-16-le")

    _build.reset_launches()
    res, out = su.convert_utf8_to_utf16le_with_errors(data)
    val = su.validate_utf8_with_errors(data)
    n16 = su.utf16_length_from_utf8(data)
    ncp = su.count_utf8(data)
    launches = dict(_build.LAUNCHES)

    check(res.error == ec.SUCCESS and res.count == len(want) // 2,
          f"transcode result {res}")
    check(out == want, "transcode output differs from codecs")
    check(val.error == ec.SUCCESS and val.count == len(data), f"validate {val}")
    check(n16 == len(want) // 2, f"utf16_length {n16} != {len(want) // 2}")
    check(ncp == len(data.decode("utf-8")), f"count_utf8 {ncp}")
    for k in PASSES:
        check(launches.get(k, 0) > 0, f"kernel {k} did not launch on the main path")
    log(f"slice: {len(data)} B mixed corpus, {len(want) // 2} units, equal "
        f"to codecs; launches {launches}")

    res, out = su.convert_utf8_to_utf16be_with_errors(data)
    check(res.is_ok and out == data.decode("utf-8").encode("utf-16-be"),
          "big-endian transcode differs from codecs")

    bad = bytearray(data)
    bad[len(bad) * 3 // 5] = 0xFF
    bad = bytes(bad)
    g_res, g_out = g8.convert_to_utf16_with_errors(np.frombuffer(bad, np.uint8),
                                                   False)
    res, out = su.convert_utf8_to_utf16le_with_errors(bad)
    val = su.validate_utf8_with_errors(bad)
    check((res.error, res.count) == (g_res.error, g_res.count),
          f"injected error: port {res} golden {g_res}")
    check((val.error, val.count) == (g_res.error, g_res.count),
          f"injected error, validate: port {val} golden {g_res}")
    check(out == g_out.tobytes()
          and out == bad[: res.count].decode("utf-8").encode("utf-16-le"),
          "partial output is not the valid prefix")
    log(f"slice: injected error reported as ({res.error.name}, {res.count}), "
        f"partial output = valid prefix ({len(out) // 2} units)")

    inputs = [(c, class_corpus(ch, big // 4))
              for c, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"),
                            ("u4", "🙂"))]
    inputs.append(("zh", profile_corpus(PROFILES["zh"], big // 4, SEED)))
    for name, d in inputs:
        res, out = su.convert_utf8_to_utf16le_with_errors(d)
        check(res.is_ok and out == d.decode("utf-8").encode("utf-16-le"),
              f"{name}: transcode differs from codecs")
        check(su.validate_utf8_with_errors(d).count == len(d), f"{name}: validate")
    log(f"slice: classes {[n for n, _ in inputs]} at {big // 4} B equal codecs")
    return launches


def cuda_ms(fn, iters: int = 10, trials: int = 7) -> float:
    """Median over trials of the mean time of ``iters`` calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def times_phase(card: str, big: int = CORPUS_BYTES) -> dict:
    """ms of each kernel and of its plain version at the main path's
    shape (the 64 MiB mixed corpus, device-resident)."""
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import compose16 as kc
    from simdutf_tpu_torch.kernels import validate as kv
    from simdutf_tpu_torch.ops import utf8 as o8
    import numpy as np

    data = bench.mixed_corpus(big)
    x, L = impl.to_device(*impl._pad(np.frombuffer(data, np.uint8)), "cuda")
    torch.cuda.synchronize()

    def plain_to_utf16():
        int(kcen.census_bits_ref(x, L))  # the route's one sync
        return kc.to_utf16_compose_ref(x, L, False)

    pairs = {
        "census_utf8": (lambda: kcen.census_bits(x, L),
                        lambda: kcen.census_bits_ref(x, L)),
        "utf8_first_event": (lambda: kv.utf8_first_event_len(x, L),
                             lambda: kv.utf8_first_event_len_ref(x, L)),
        "utf8_count": (lambda: kv.utf8_count(x, L),
                       lambda: kv.count_ref(x, L, "count")),
        "utf8_to_utf16_compose": (lambda: kc.to_utf16_compose(x, L, False),
                                  lambda: kc.to_utf16_compose_ref(x, L, False)),
        "to_utf16 (ops.utf8, routed)": (lambda: o8.to_utf16(x, L, False),
                                        plain_to_utf16),
    }
    ms = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: the pair shares one card and state
        p1 = cuda_ms(plain, iters=3, trials=3)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain, iters=3, trials=3)
        ms[name] = (statistics.median([k1, k2]), statistics.median([p1, p2]))
        log(f"time {name}: kernel {ms[name][0]:.4f} ms "
            f"({L / ms[name][0] / 1e6:.1f} GB/s in), plain torch "
            f"{ms[name][1]:.4f} ms ({L / ms[name][1] / 1e6:.1f} GB/s in) "
            f"[{card}]")
    y = torch.empty_like(x)
    copy = cuda_ms(lambda: y.copy_(x))
    log(f"time d2d copy of {x.numel()} B: {copy:.4f} ms, "
        f"{2 * x.numel() / copy / 1e6:.1f} GB/s read+write [{card}]")
    breakdown(lambda: o8.to_utf16(x, L, False), "to_utf16 (mixed 64 MiB)", card)
    return ms


def breakdown(fn, what: str, card: str, iters: int = 20) -> None:
    """Device time per call of each kernel ``fn`` runs, and the device's
    busy share of the window, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    # device-side events only (kernels, copies): an aten op's row repeats
    # the time of the kernels it launched
    rows = sorted(((e.self_device_time_total / iters, e.count / iters, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"breakdown {what}: {wall_us:.1f} us/call on the host clock, device "
        f"busy {busy:.1f} us/call ({100 * busy / wall_us:.1f}%) [{card}]")
    for us, count, key in rows:
        log(f"  {us:9.2f} us/call  x{count:g}  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import bench  # noqa: F401
        import simdutf_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repo ({exc})",
              file=sys.stderr)
        return 2
    try:
        name, card = device_phase()
        build_phase()
        errs = parity_phase("cuda")
        launches = slice_phase("cuda")
        ms = times_phase(card)
        check("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    kernels = [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "also_replaces": KERNELS[k][2],
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": ms[k][0], "plain_ms": ms[k][1]}
        for k in PASSES
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
