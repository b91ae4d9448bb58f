"""The ``utf16_to_utf8`` benchmark configuration on the CPU: its plain
reference against simdutf's rules, the port's UTF-16LE -> UTF-8 route
against that reference on the cell's kind of text with lone surrogates
planted, and the compose wrappers' fill counter, tile-glue span and launches
under a CPU profiler (the wrappers' device path, with the C launches
stubbed)."""

import ctypes
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402
from bench_torch.configs import utf16_to_utf8_ref as ref  # noqa: E402
from simdutf_tpu_torch import impl, trace  # noqa: E402
from simdutf_tpu_torch.kernels import _build  # noqa: E402
from simdutf_tpu_torch.kernels import compose8 as kc8  # noqa: E402
from simdutf_tpu_torch.kernels import composex as kcx  # noqa: E402
from simdutf_tpu_torch.ops import utf16 as o16  # noqa: E402
from simdutf_tpu_torch.ops.common import BIG, tile_glue  # noqa: E402

text16 = harness.load_module(harness.HERE / "traffic" / "text16.py",
                             "bench_torch.traffic.text16")
CELL = harness.load_cell("utf16_to_utf8.mixed_64m").traffic


def u16(*units: int) -> bytes:
    return np.array(units, "<u2").tobytes()


CASES = [  # (UTF-16LE bytes, code, unit position, UTF-8 bytes before it)
    ("aé東".encode("utf-16-le"), ref.SUCCESS, 3, "aé東".encode()),
    ("x🙂".encode("utf-16-le"), ref.SUCCESS, 3, "x🙂".encode()),
    (b"", ref.SUCCESS, 0, b""),
    (u16(0x61, 0xDC00, 0x62), ref.SURROGATE, 1, b"a"),
    (u16(0xD83D, 0x0041), ref.SURROGATE, 0, b""),
    (u16(0xD800, 0xD800, 0xDC00), ref.SURROGATE, 0, b""),
    (u16(0x61, 0x62, 0xD83D), ref.SURROGATE, 2, b"ab"),
    ("Жм東🙂".encode("utf-16-le") + u16(0xDFFF, 0x41), ref.SURROGATE, 5, "Жм東🙂".encode()),
]


@pytest.mark.parametrize("data,code,pos,prefix", CASES)
def test_reference_follows_simdutf_rules(data, code, pos, prefix):
    c, p, out = ref.convert(data)
    assert (c, p) == (code, pos)
    assert out.dtype == np.uint8 and out.tobytes() == prefix


def test_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((harness.HERE / "configs" / "utf16_to_utf8_ref.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods <= {"__future__", "numpy"}


def _port(units: np.ndarray):
    """(code, pos, out_len, out uint8[3N]) of the port's route on the CPU,
    staged as the cell stages it."""
    buf, n = impl._pad(units)
    x, n = impl.to_device(buf.copy(), n, "cpu")
    code, pos, out, out_len = o16.to_utf8(x, n, False)
    return int(code), int(pos), int(out_len), out.numpy(), x.shape[0]


def _planted(seed: int, pages: int, page_units: int) -> list:
    """The cell's text at a small size, valid, and with lone surrogates
    planted at positions drawn from ``seed``."""
    p = dict(CELL, docs=1, doc_units=pages * page_units, page_units=page_units)
    units = text16.generate(p, seed, "cpu")[0].view("<u2").astype(np.uint16)
    rng = random.Random(seed)
    n = len(units)
    out = [units]
    for _ in range(3):
        bad = units.copy()
        k = rng.randrange(n)
        bad[k] = rng.choice([0xD800 + rng.randrange(0x400), 0xDC00 + rng.randrange(0x400)])
        out.append(bad)
    last = units.copy()
    last[-1] = 0xDBFF  # a high surrogate as the last unit
    out.append(last)
    return out


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 13])
@pytest.mark.parametrize("pages", [2, 3])
def test_port_matches_reference_on_cell_text(seed, pages):
    """Scalars and the whole 3N-byte buffer, the zeros past out_len too."""
    for units in _planted(seed, pages, 2000 + (48 * seed) % 1000):
        code, pos, want = ref.convert(units.tobytes())
        got_code, got_pos, out_len, out, n = _port(units)
        assert (got_code, got_pos, out_len) == (code, pos, len(want))
        assert out.shape == (3 * n,)
        assert out[: len(want)].tobytes() == want.tobytes()
        assert not out[len(want):].any()


# -- the compose wrappers' device path, launches stubbed ---------------------

class _Lib:
    """Stands in for the kernels' library: each count pass reports tiles
    with no output and no event, each emit pass writes nothing."""

    def __getattr__(self, name):
        def entry(*args):
            if name == "latin1_utf8_count":
                nt, counts = args[-3:-1]
                ctypes.memset(counts, 0, 4 * nt)
            elif name.endswith("_count"):
                nt, counts, keys, prefix = args[-5:-1]
                ctypes.memset(counts, 0, 4 * nt)
                ctypes.memset(prefix, 0, 4 * nt)
                (ctypes.c_int64 * nt).from_address(keys)[:] = [BIG << 8] * nt
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


def _traced(call):
    call()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    return trace.snapshot()


def test_compose8_counts_its_fill_and_spans_its_glue(stubbed):
    """compose8 is one launch a call: it counts no fill bytes (the kernel
    writes the zeros past out_len itself) and opens no ``tile_glue``
    span; the zero fill of a call with nothing in range is counted."""
    w = torch.zeros(5000, dtype=torch.uint16)
    snap = _traced(lambda: kc8.to_utf8_compose(w, 4500, False))
    assert snap["counts"] == {}
    assert snap["launches"] == {"compose8": 2}
    assert "simdutf.passglue.tile_glue" not in snap["spans"]
    assert snap["spans"]["simdutf.kernel.compose8.to_utf8_compose"]["count"] == 2
    snap = _traced(lambda: kc8.to_utf8_compose(w, 0, False, mode="valid"))
    assert snap["counts"] == {"compose.fill_bytes": 2 * 3 * 5000} and snap["launches"] == {}


@pytest.mark.parametrize("wrapper,dtype,fill", [
    (kcx.u32_to_utf8_compose, torch.int32, 4),
    (kcx.u16_to_utf32_compose, torch.uint16, 4),
    (kcx.u32_to_utf16_compose, torch.int32, 4),
    (kcx.latin1_to_utf8_compose, torch.uint8, 2),
], ids=lambda v: getattr(v, "__name__", None))
def test_composex_counts_its_fill(stubbed, wrapper, dtype, fill):
    """The composex wrappers count the bytes of the buffer they zero-fill;
    those with a tile glue span it."""
    x = torch.zeros(3000, dtype=dtype)
    args = (x, 2500) if wrapper in (kcx.u32_to_utf8_compose, kcx.latin1_to_utf8_compose) \
        else (x, 2500, False)
    snap = _traced(lambda: wrapper(*args))
    assert snap["counts"] == {"compose.fill_bytes": 2 * fill * 3000}
    kernel = f"simdutf.kernel.composex.{wrapper.__name__}"
    if wrapper is kcx.latin1_to_utf8_compose:
        assert "simdutf.passglue.tile_glue" not in snap["spans"]
    else:
        assert snap["spans"]["simdutf.passglue.tile_glue"]["parents"] == {kernel: 2}


def test_route_on_the_cpu_fills_nothing():
    """On a CPU tensor the compose wrapper runs its plain version: no fill
    to count and no glue."""
    units = np.frombuffer("ab é 東 🙂 Жм ".encode("utf-16-le") * 300, np.uint16)
    buf, n = impl._pad(units)
    x, n = impl.to_device(buf.copy(), n, "cpu")
    snap = _traced(lambda: o16.to_utf8(x, n, False))
    assert snap["counts"] == {} and snap["syncs"] == 2
    assert "simdutf.passglue.tile_glue" not in snap["spans"]


def test_glue_off_is_one_flag_check(monkeypatch):
    """With no profiler, the tile glue's span reads the profiler's flag
    once and touches no thread state."""
    trace.span("simdutf.x")  # a call with no profiler ends this thread's record
    checks = []
    monkeypatch.setattr(trace, "_enabled", lambda: checks.append(1) or False)
    monkeypatch.setattr(trace, "_thread", lambda: pytest.fail("thread state touched"))
    counts = torch.tensor([3, 0, 5], dtype=torch.int32)
    keys = torch.full((3,), BIG << 8, dtype=torch.int64)
    off, total, err_any, *_ = tile_glue(counts, keys, torch.zeros(3, dtype=torch.int32))
    assert off.tolist() == [0, 3, 3] and int(total) == 8 and not bool(err_any)
    trace.count("compose.fill_bytes", 24)
    assert checks == [1, 1]
