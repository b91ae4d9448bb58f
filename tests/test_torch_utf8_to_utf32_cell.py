"""The ``utf8_to_utf32`` benchmark configuration on the CPU: its plain
reference against simdutf's rules, the port's UTF-8 -> UTF-32 route
against that reference on the cell's kind of text with errors planted, the
configuration's check against the control and two faults, and the route's
spans, sync, counts and launches under a CPU profiler (the wrappers'
device path, with the C launches stubbed)."""

import ast
import ctypes
import random
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402
from bench_torch.configs import utf8_to_utf16_ref as codes  # noqa: E402
from bench_torch.configs import utf8_to_utf32_ref as ref  # noqa: E402
from simdutf_tpu_torch import impl, trace  # noqa: E402
from simdutf_tpu_torch.kernels import _build  # noqa: E402
from simdutf_tpu_torch.kernels import census as kcen  # noqa: E402
from simdutf_tpu_torch.ops import utf8 as o8  # noqa: E402
from simdutf_tpu_torch.ops.common import BIG  # noqa: E402

text = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
CELL = "utf8_to_utf32.mixed_64m"
TRAFFIC = harness.load_cell(CELL).traffic
SMALL = {"doc_bytes": 48000, "page_bytes": 4000}
SECONDS = 0.3

VALID = "aé Жм東🙂 x\U0010ffff😀"  # 4-byte sequences among the others
BAD = [  # (bad sequence, simdutf's code), each invalid whatever follows it
    (b"\xf8", codes.HEADER_BITS),
    (b"\xff", codes.HEADER_BITS),
    (b"\xc3", codes.TOO_SHORT),
    (b"\xe6\x9d", codes.TOO_SHORT),
    (b"\xf0\x9f\x99", codes.TOO_SHORT),
    (b"\x80", codes.TOO_LONG),
    (b"\xbf", codes.TOO_LONG),
    (b"\xc0\xaf", codes.OVERLONG),
    (b"\xe0\x80\x80", codes.OVERLONG),
    (b"\xf0\x8f\xbf\xbf", codes.OVERLONG),
    (b"\xf4\x90\x80\x80", codes.TOO_LARGE),
    (b"\xf5\x80\x80\x80", codes.TOO_LARGE),
    (b"\xed\xa0\x80", codes.SURROGATE),
    (b"\xed\xbf\xbf", codes.SURROGATE),
]


def _cases():
    out = [(VALID.encode(), ref.SUCCESS, len(VALID.encode()), VALID), (b"", ref.SUCCESS, 0, "")]
    for bad, code in BAD:
        for where, before in (("start", ""), ("middle", VALID[:5]), ("end", VALID)):
            after = "" if where == "end" else VALID
            data = before.encode() + bad + after.encode()
            out.append((data, code, len(before.encode()), before))
    return out


@pytest.mark.parametrize("data,code,pos,prefix", _cases())
def test_reference_follows_simdutf_rules(data, code, pos, prefix):
    """Every code of the UTF-8 side at the start, middle and end of text
    with 4-byte sequences; the words are the prefix's code points."""
    c, p, words = ref.convert(data)
    assert (c, p) == (code, pos)
    assert words.dtype == np.uint32 and words.tolist() == [ord(ch) for ch in prefix]


def test_reference_imports_nothing_of_the_program():
    """The reference and the module whose error rules it shares import
    neither JAX, nor the JAX package, nor the port."""
    seen = set()
    for name in ("utf8_to_utf32_ref.py", "utf8_to_utf16_ref.py"):
        tree = ast.parse((harness.HERE / "configs" / name).read_text())
        seen |= {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        seen |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert seen <= {"__future__", "numpy", "bench_torch"}
    assert not seen & {"jax", "jaxlib", "simdutf_tpu", "simdutf_tpu_torch"}


# -- the port's route on the cell's text -------------------------------------

def _port(data: np.ndarray):
    """(code, pos, out_len, out uint32[N], N) of the port's route on the
    CPU, staged as the cell stages it."""
    buf, n = impl._pad(data)
    x, n = impl.to_device(buf.copy(), n, "cpu")
    code, pos, out, out_len = o8.to_utf32(x, n)
    return int(code), int(pos), int(out_len), out.numpy().view(np.uint32), x.shape[0]


def _planted(seed: int, pages: int, page_bytes: int) -> list:
    """The cell's text at a small size, valid, and with a bad sequence
    planted at a character start drawn from ``seed``, three times, plus
    one cut sequence at the very end."""
    p = dict(TRAFFIC, docs=1, doc_bytes=pages * page_bytes, page_bytes=page_bytes)
    data = text.generate(p, seed, "cpu")[0]
    rng = random.Random(seed)
    out = [data]
    for _ in range(3):
        k = rng.randrange(len(data))
        while data[k] & 0xC0 == 0x80:
            k -= 1
        bad, _ = rng.choice(BAD)
        out.append(np.concatenate([data[:k], np.frombuffer(bad, np.uint8), data[k:]]))
    out.append(np.concatenate([data, np.frombuffer(b"\xe6\x9d", np.uint8)]))
    return out


@pytest.mark.parametrize("seed", [3, 11, 2**31 + 17])
@pytest.mark.parametrize("pages", [2, 7])
def test_port_matches_reference_on_cell_text(seed, pages):
    """Scalars and words before ``out_len``; for valid input the whole
    N-word buffer, the zeros past ``out_len`` too."""
    for data in _planted(seed, pages, 1000 + (37 * seed) % 900):
        code, pos, words = ref.convert(data.tobytes())
        got_code, got_pos, out_len, out, n = _port(data)
        assert (got_code, got_pos, out_len) == (code, pos, len(words))
        assert out.shape == (n,)
        assert np.array_equal(out[: len(words)], words)
        if code == ref.SUCCESS:
            assert not out[len(words):].any()


# -- the configuration's check ----------------------------------------------

def run(seed=2**31 + 23, **kw):
    return harness.run_cell(CELL, seed, SECONDS, False, t_start=time.perf_counter(),
                            device="cpu", traffic=SMALL, **kw)


def half_input(session):
    """Half of each call's input left out."""
    orig = session.entry
    session.entry = lambda x, n: orig(x, n // 2)


def altered_word(session):
    """One word of each call's output altered."""
    orig = session.entry

    def entry(x, n):
        r = orig(x, n)
        r[2][5] += 1
        return r
    session.entry = entry


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["compared"]) == {"scalars_wrong", "words_wrong"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["compared"].values())
    assert list(r)[-1] == "compared"


def test_control_fails():
    """The Latin-1 path takes every byte for a code point: every call's
    scalars and the sampled words are wrong."""
    r = run(control=True)
    assert not r["correct"]
    assert all(c["value"] > c["limit"] for c in r["compared"].values())
    assert r["compared"]["scalars_wrong"]["value"] == r["attempted"] == r["failed"]


@pytest.mark.parametrize("fault", [half_input, altered_word], ids=lambda f: f.__name__)
def test_fault_fails(fault):
    r = run(patch=fault)
    assert not r["correct"], r["compared"]
    assert r["failed"] > 0


def test_needed_bytes_and_input_bytes():
    """A call needs its bytes read once and its words written once, and
    returns its input bytes."""
    cfg = harness.load_module(harness.HERE / "configs" / "utf8_to_utf32.py",
                              "bench_torch.configs.utf8_to_utf32")
    data = np.frombuffer("aé東🙂 ".encode() * 100, np.uint8).reshape(1, -1)
    s = cfg.make(data, 5, "cpu", False)
    assert s.call(0) == data.shape[1]
    assert s.needed_bytes == data.shape[1] + 4 * 5 * 100
    compared, wrong, _ = s.check()
    assert wrong == 0 and all(v == 0 for v, _ in compared.values())


# -- the route's tracing ------------------------------------------------------

ROUTE = "simdutf.route.utf8.to_utf32"
CHILDREN = ["simdutf.kernel.census.census_bits", "simdutf.sync.utf8.census",
            "simdutf.kernel.compose32.to_utf32_compose"]
#: census bits of mixed text: no fast class holds
MIXED_BITS = (kcen.BIT_NONASCII | kcen.BIT_V2 | kcen.BIT_V3 | kcen.BIT_V4
              | kcen.BIT_HAS2 | kcen.BIT_HASLO)
CHECKED = 3  # the chunks the stubbed census reports checked


class _Lib:
    """Stands in for the kernels' library: the census reports mixed text,
    compose32 a valid buffer and writes no word."""

    def __getattr__(self, name):
        def entry(*args):
            if name == "census_utf8":
                (ctypes.c_int32 * 2).from_address(args[3])[:] = [MIXED_BITS, CHECKED]
            elif name == "compose32":
                (ctypes.c_int64 * 4).from_address(args[-3])[:] = [0, BIG, 0, 0]
                ctypes.c_bool.from_address(args[-2]).value = False
            return 0
        return entry


class _Stream:
    cuda_stream = 0


@pytest.fixture
def stubbed(monkeypatch):
    """The wrappers take their device path on CPU tensors."""
    monkeypatch.setattr(_build, "_check", lambda b, length, dtype: "cuda")
    monkeypatch.setattr(_build, "lib", lambda: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())


def _staged():
    data = np.frombuffer("ab é 東 🙂 Жм ".encode() * 300, np.uint8)
    buf, n = impl._pad(data)
    return impl.to_device(buf.copy(), n, "cpu")


def _traced(call):
    call()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    return trace.snapshot()


@pytest.mark.parametrize("device_path", [False, True], ids=["plain", "stubbed_launches"])
def test_route_is_traced(request, device_path):
    """A recorded call gives its route span, the census sync and its
    counts, compose32's wrapper span inside the route, and on the device
    path one launch each of ``census_utf8`` and ``compose32``."""
    if device_path:
        request.getfixturevalue("stubbed")
    x, n = _staged()
    snap = _traced(lambda: o8.to_utf32(x, n))
    spans = snap["spans"]
    assert set(spans) == {ROUTE, *CHILDREN}
    assert spans[ROUTE]["parents"] == {None: 2}
    for name in CHILDREN:
        assert spans[name]["parents"] == {ROUTE: 2}, name
    assert snap["syncs"] == 2
    chunks = (n + 15) // 16
    checked = CHECKED if device_path else chunks
    assert snap["counts"] == {"census.checked_chunks": 2 * checked, "census.chunks": 2 * chunks}
    assert snap["launches"] == ({"census_utf8": 2, "compose32": 2} if device_path else {})
