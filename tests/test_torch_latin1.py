"""The port's Latin-1 row and column against the JAX package on CPU.

``kernels.composex.latin1_to_utf8_compose``'s plain version is held against
the scatter engine of ``simdutf_tpu.ops.latin1.to_utf8`` (its whole u8[2N]
buffer and total, garbage past the length included) and, on at most two
8192-byte tiles, against the Pallas ``butterflyx.latin1_to_utf8_compose``
(interpret mode). Then the routed ``ops.latin1`` functions and every
``to_latin1`` / ``to_latin1_valid`` of ``ops.utf8``, ``ops.utf16`` and
``ops.utf32`` against the JAX ops on the same padded buffers: full
outputs, past out_len included, and (error, position, out_len). Integer
results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import butterflyx as jbx
from simdutf_tpu.ops import common as jcom
from simdutf_tpu.ops import latin1 as jol1
from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch import impl
from simdutf_tpu_torch.kernels import composex as tcx
from simdutf_tpu_torch.ops import latin1 as tol1
from simdutf_tpu_torch.ops import utf8 as to8
from simdutf_tpu_torch.ops import utf16 as to16
from simdutf_tpu_torch.ops import utf32 as to32

T = jbx.TILE_E


@jax.jit
def _jscatter(b, length):
    """ops/latin1.to_utf8's scatter engine: (out u8[2n], total)."""
    n = b.shape[0]
    w = jcom.zero_tail(b.astype(jnp.int32), length)
    in_r = jcom.positions(n) < length
    hi = (w >= 0x80) & in_r
    off, inc = jcom.excl_scan(jnp.where(in_r, 1, 0) + hi.astype(jnp.int32), n)
    out = jcom.scatter_writes(2 * n, jnp.uint8, [
        (in_r, off, jnp.where(hi, (w >> 6) | 0xC0, w)),
        (hi, off + 1, (w & 0x3F) | 0x80)])
    return out, inc[n - 1]


def _latin1(n: int, seed: int) -> np.ndarray:
    """70% of bytes in 0x20-0x7E, 30% in 0xC0-0xFF."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.7, rng.integers(0x20, 0x7F, n),
                    rng.integers(0xC0, 0x100, n)).astype(np.uint8)


LATIN1 = {
    "empty": np.zeros(0, np.uint8),
    "ascii": np.frombuffer(b"plain ASCII text. " * 300, np.uint8),
    "all_high": np.full(3000, 0xE9, np.uint8),
    "every_byte": np.arange(256, dtype=np.uint8).repeat(17),
    "mixed": _latin1(7000, 1),
    "high_at_tile_edges": np.where(np.isin(np.arange(6200), [0, 2047, 2048, 4095, 6199]),
                                   0xFF, 0x41).astype(np.uint8),
}


@pytest.mark.parametrize("name", sorted(LATIN1))
@pytest.mark.parametrize("garbage", [False, True])
def test_latin1_compose_matches_scatter_engine(name, garbage):
    data = LATIN1[name]
    n = 1 << (len(data) + 8).bit_length()
    buf = np.zeros(n, np.uint8)
    if garbage:
        buf[:] = np.random.default_rng(n).integers(0, 256, n)
    buf[: len(data)] = data
    want, total = _jscatter(jnp.asarray(buf), jnp.int32(len(data)))
    out, got_total = tcx.latin1_to_utf8_compose(torch.from_numpy(buf), len(data))
    assert out.dtype == torch.uint8 and out.shape == (2 * n,)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert int(got_total) == int(total) == len(data.tobytes().decode("latin-1").encode())


@pytest.mark.parametrize("size", [T, 2 * T - 333])
def test_latin1_compose_matches_butterflyx(size):
    data = _latin1(size, size)
    n = -(-size // T) * T
    buf = np.zeros(n, np.uint8)
    buf[:size] = data
    want, total = jbx.latin1_to_utf8_compose(jnp.asarray(buf), jnp.int32(size))
    out, got_total = tcx.latin1_to_utf8_compose(torch.from_numpy(buf), size)
    assert int(got_total) == int(total)
    assert np.array_equal(out.numpy(), np.asarray(want))


def _staged(arr: np.ndarray):
    buf, L = impl._pad(arr)
    return buf.copy(), int(L)


def _ints(*vals):
    return [int(v) for v in vals]


_jl1_to_u8 = jax.jit(jol1.to_utf8)
_jl1_len = jax.jit(jol1.utf8_length)
_jl1_to_u16 = jax.jit(jol1.to_utf16, static_argnums=2)
_jl1_to_u32 = jax.jit(jol1.to_utf32)


@pytest.mark.parametrize("name", sorted(LATIN1))
def test_latin1_ops_match_jax(name):
    buf, L = _staged(LATIN1[name])
    x, jb = torch.from_numpy(buf), jnp.asarray(buf)
    out, out_len = tol1.to_utf8(x, L)
    want, want_len = _jl1_to_u8(jb, L)
    assert np.array_equal(out.numpy(), np.asarray(want)) and int(out_len) == int(want_len)
    assert int(tol1.utf8_length(x, L)) == int(_jl1_len(jb, L))
    for be in (False, True):
        got = tol1.to_utf16(x, L, be)
        assert got.dtype == torch.uint16
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(_jl1_to_u16(jb, L, be)))
    assert np.array_equal(tol1.to_utf32(x, L).numpy().view(np.uint32),
                          np.asarray(_jl1_to_u32(jb, L)))


def test_latin1_routes():
    """ASCII and all-high buffers take the fixed-rate branches, mixed input
    the compose kernel."""
    got = [tol1.census(torch.from_numpy(_staged(LATIN1[k])[0]), len(LATIN1[k]))
           for k in ("ascii", "all_high", "mixed", "empty")]
    assert got == [(True, False), (False, True), (False, False), (True, False)]


_jto_l1 = jax.jit(jo8.to_latin1)
_jto_l1_valid = jax.jit(jo8.to_latin1_valid)

UTF8 = {
    "empty": b"",
    "ascii": b"abc " * 400,
    "latin1": "café naïve ÿ ".encode() * 200,
    "cont_at_0": b"\x80ab" + "é".encode() * 100,
    "three_byte": "ab東cd".encode() * 50,
    "four_byte": "x\U0001f642y".encode() * 50,
    "above_ff": "aĀb".encode() * 80,
    "overlong": b"ab\xc1\xbfcd" * 40,
    "too_short": "é".encode() * 300 + b"\xc3",
    "lead_then_lead": b"ab\xc3\xc3\xa9" * 30,
    "extra_cont": "é".encode() + b"\x80" + b"z" * 100,
    "header": b"ok\xf8ok" * 20,
}


@pytest.mark.parametrize("name", sorted(UTF8))
def test_utf8_to_latin1_matches_jax(name):
    buf, L = _staged(np.frombuffer(UTF8[name], np.uint8))
    x, jb = torch.from_numpy(buf), jnp.asarray(buf)
    code, pos, out, out_len = to8.to_latin1(x, L)
    want = _jto_l1(jb, L)
    assert out.dtype == torch.uint8 and out.shape == (len(buf),)
    assert np.array_equal(out.numpy(), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    out_v, total = to8.to_latin1_valid(x, L)
    want_v = _jto_l1_valid(jb, L)
    assert np.array_equal(out_v.numpy(), np.asarray(want_v[0]))
    assert int(total) == int(want_v[1])


def test_utf8_continuation_at_0_is_too_long():
    """A continuation byte at 0 is TOO_LONG there, with nothing before it;
    the later leads are still written past out_len."""
    buf, L = _staged(np.frombuffer(b"\x80ab", np.uint8))
    code, pos, out, out_len = to8.to_latin1(torch.from_numpy(buf), L)
    assert _ints(code, pos, out_len) == [3, 0, 0]
    assert out[:3].tolist() == [0x61, 0x62, 0]


_jto16_l1 = jax.jit(jo16.to_latin1, static_argnums=2)
_jto16_l1_valid = jax.jit(jo16.to_latin1_valid, static_argnums=2)
_jto32_l1 = jax.jit(jo32.to_latin1)
_jto32_l1_valid = jax.jit(jo32.to_latin1_valid)

TEXT = {"ascii": "abc" * 300, "latin1": "naïve café ÿ" * 100,
        "above_ff_mid": "é" * 500 + "Ā" + "é" * 100, "astral_at_0": "\U0001f642" + "a" * 50}


@pytest.mark.parametrize("name", sorted(TEXT))
@pytest.mark.parametrize("be", [False, True])
def test_utf16_to_latin1_matches_jax(name, be):
    units = np.frombuffer(TEXT[name].encode("utf-16-be" if be else "utf-16-le"), np.uint16)
    buf, L = _staged(units)
    buf[L:] = 0xFFFF  # past the length: ignored, zero in the output
    w, jw = torch.from_numpy(buf.view(np.int16)).view(torch.uint16), jnp.asarray(buf)
    code, pos, out, out_len = to16.to_latin1(w, L, be)
    want = _jto16_l1(jw, L, be)
    assert np.array_equal(out.numpy(), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    out_v, total = to16.to_latin1_valid(w, L, be)
    want_v = _jto16_l1_valid(jw, L, be)
    assert np.array_equal(out_v.numpy(), np.asarray(want_v[0])) and int(total) == int(want_v[1])


@pytest.mark.parametrize("name", sorted(TEXT) + ["top_bit"])
def test_utf32_to_latin1_matches_jax(name):
    if name == "top_bit":
        words = np.array([0x61, 0xE9, 0x800000E9, 0x62], np.uint32)
    else:
        words = np.frombuffer(TEXT[name].encode("utf-32-le"), np.uint32)
    buf, L = _staged(words)
    w, jw = torch.from_numpy(buf.view(np.int32)), jnp.asarray(buf)
    code, pos, out, out_len = to32.to_latin1(w, L)
    want = _jto32_l1(jw, L)
    assert np.array_equal(out.numpy(), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    out_v, total = to32.to_latin1_valid(w, L)
    want_v = _jto32_l1_valid(jw, L)
    assert np.array_equal(out_v.numpy(), np.asarray(want_v[0])) and int(total) == int(want_v[1])
