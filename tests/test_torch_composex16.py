"""simdutf_tpu_torch.kernels.composex's UTF-16 <-> UTF-32 compose kernels
against the JAX package's engines.

The plain versions (what runs here) are held against the scatter engines
of ``simdutf_tpu.ops.utf16.to_utf32`` (``first_error`` + ``_codepoints`` +
``_emit_utf32``) and ``simdutf_tpu.ops.utf32.to_utf16`` (``first_error`` +
``_emit_utf16``), which give the JAX package's final result on every input
(its butterflies rerun them on any error), on full padded buffers: the
whole output, the words or units past out_len on the error path included,
and (error, position, out_len), LE and BE. On valid input in 8192-element
multiples (at most two tiles) they are also held against the Pallas
``butterflyx.u16_to_utf32_compose`` and ``u32_to_utf16_compose``
(interpret mode on CPU). Integer results: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import butterflyx as jbx
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch.kernels import composex as tcx

T = jbx.TILE_E  # 8192-element butterfly tiles (the port's own are 2048)
BIG = 2**31 - 1


@functools.partial(jax.jit, static_argnums=2)
def _jscatter16(units, length, be):
    """ops/utf16.to_utf32's scatter engine: (code, pos, out u32[n], out_len)."""
    n = units.shape[0]
    w = jo16.native(units, length, be)
    err_pos, err_code = jo16.first_error(w, length)
    ok = err_pos == BIG
    cp, start = jo16._codepoints(w, length)
    out, off, total = jo16._emit_utf32(cp, start, n)
    out_len = jnp.where(ok, total, off[jnp.minimum(err_pos, n - 1)])
    return jnp.where(ok, 0, err_code), jnp.where(ok, length, err_pos), out, out_len


@functools.partial(jax.jit, static_argnums=2)
def _jscatter32(words, length, be):
    """ops/utf32.to_utf16's scatter engine: (code, pos, out u16[2n], out_len)."""
    n = words.shape[0]
    w64 = jo32._native(words, length)
    err_pos, err_code = jo32.first_error(w64, length)
    ok = err_pos == BIG
    out, off, total = jo32._emit_utf16(w64, length, n, be)
    out_len = jnp.where(ok, total, off[jnp.minimum(err_pos, n - 1)])
    return jnp.where(ok, 0, err_code), jnp.where(ok, length, err_pos), out, out_len


def _buffer(elems: np.ndarray, dtype, n: int, garbage: bool) -> np.ndarray:
    buf = np.zeros(n, dtype)
    if garbage:
        hi = 1 << (8 * np.dtype(dtype).itemsize)
        buf[:] = np.random.default_rng(n).integers(0, hi, n, dtype=np.uint64)
    buf[: len(elems)] = elems
    return buf


def _check(got, want, out_np):
    """got: the port's compose tuple; want: the JAX scatter verdict."""
    out, total, err_any, err_pos, err_code, err_len = got
    code, pos, jout, out_len = want
    assert np.array_equal(out_np(out), np.asarray(jout))
    assert bool(err_any) == (int(code) != 0)
    if err_any:
        assert (int(err_pos), int(err_code), int(err_len)) == (int(pos), int(code), int(out_len))
    else:
        assert (int(total), int(err_pos), int(err_code), int(err_len)) == (int(out_len), BIG, 0, 0)
    return [int(v) for v in (total, err_any, err_pos, err_code, err_len)]


def _compare16(units: np.ndarray, be: bool, length=None, n=None, garbage=False):
    """UTF-16 -> UTF-32 on native ``units`` stored LE or BE in an n-unit
    buffer (next power of two with 8 units of slack by default)."""
    length = len(units) if length is None else length
    n = n or 1 << (len(units) + 8).bit_length()
    buf = _buffer(units, np.uint16, n, garbage)
    if be:
        buf = buf.byteswap()
    want = _jscatter16(jnp.asarray(buf), jnp.int32(length), be)
    w = torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
    got = tcx.u16_to_utf32_compose(w, length, be)
    assert got[0].dtype == torch.int32 and got[0].shape == (n,)
    return _check(got, want, lambda o: o.numpy().view(np.uint32))


def _compare32(words: np.ndarray, be: bool, length=None, n=None, garbage=False):
    """UTF-32 -> UTF-16 (LE or BE units) on ``words`` in an n-word buffer."""
    length = len(words) if length is None else length
    n = n or 1 << (len(words) + 8).bit_length()
    buf = _buffer(words, np.uint32, n, garbage)
    want = _jscatter32(jnp.asarray(buf), jnp.int32(length), be)
    got = tcx.u32_to_utf16_compose(torch.from_numpy(buf.view(np.int32)), length, be)
    assert got[0].dtype == torch.uint16 and got[0].shape == (2 * n,)
    return _check(got, want, lambda o: o.view(torch.int16).numpy().view(np.uint16))


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16).copy()


def _words(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def _text(n: int, seed: int) -> str:
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff", "\x00", "\uffff"]
    rng = np.random.default_rng(seed)
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def _with(arr, pos, value) -> np.ndarray:
    out = arr.copy()
    out[pos] = value
    return out


_U = _units(_text(6000, 1))
_PAIR_AT_EDGE = _units("x" * 2047 + "\U0001f642" + _text(3000, 2))
UNITS = {
    "mixed": _U,
    "pair_straddles_2047": _PAIR_AT_EDGE,
    "high_at_0": _with(_U, 0, 0xD800),
    "low_at_0": _with(_U, 0, 0xDC00),
    "high_at_2047": _with(_units("é" * 5000), 2047, 0xDBFF),
    "low_at_2048": _with(_units("é" * 5000), 2048, 0xDFFF),
    "high_high": _with(_with(_units("Ж" * 3000), 100, 0xD800), 101, 0xD801),
    "high_at_len-1": _with(_U, len(_U) - 1, 0xD83D),
    "two_lows_after_pair": np.concatenate([_units("a\U0001f642"), [0xDC00, 0xDC01],
                                           _units("b" * 300)]).astype(np.uint16),
}


@pytest.mark.parametrize("name", sorted(UNITS))
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("garbage", [False, True])
def test_u16_to_u32_compose_matches_scatter_engine(name, be, garbage):
    _, err_any, *_ = _compare16(UNITS[name], be, garbage=garbage)
    assert bool(err_any) == (name not in ("mixed", "pair_straddles_2047"))


def test_u16_high_at_length_minus_one_pairs_with_zero():
    """A high surrogate at length-1 whose low is stored at length: lone, and
    the scatter engine's word pairs it with the zero past the length,
    ((0xD83D - 0xD800) << 10) + (0 - 0xDC00) + 0x10000 = 0x11800, not the
    code point the stored pair makes."""
    units = _units("a\U0001f642")  # 0x61, 0xD83D, 0xDE42
    buf = np.concatenate([units, np.zeros(13, np.uint16)])
    for be in (False, True):
        stored = buf.byteswap() if be else buf
        w = torch.from_numpy(stored.view(np.int16)).view(torch.uint16)
        out, total, err_any, err_pos, err_code, err_len = tcx.u16_to_utf32_compose(w, 2, be)
        assert out[:3].tolist() == [0x61, 0x11800, 0]
        assert [int(total), bool(err_any), int(err_pos), int(err_len)] == [2, True, 1, 1]
        assert _compare16(units, be, length=2, n=16) == [2, 1, 1, 6, 1]


def test_u16_empty_and_length_equals_buffer():
    assert _compare16(_U[:2048], False, n=2048)[1] == 0
    assert _compare16(np.zeros(0, np.uint16), True, n=16) == [0, 0, BIG, 0, 0]
    assert _compare16(_U[:9], False, length=0, n=16) == [0, 0, BIG, 0, 0]


_W = _words(_text(6000, 3))
WORDS = {
    "mixed": _W,
    "edges": np.array([0x7F, 0xFFFF, 0x10000, 0x10FFFF, 0xD7FF, 0xE000] * 800, np.uint32),
    "too_large_at_0": _with(_W, 0, 0x110000),
    "surrogate_at_2047": _with(_W, 2047, 0xD800),
    "dfff_at_2048": _with(_W, 2048, 0xDFFF),
    "top_bit_at_4097": _with(_W, 4097, 0x80000000),
    "all_ones_at_len-1": _with(_W, len(_W) - 1, 0xFFFFFFFF),
    "two_errors": _with(_with(_W, 5000, 0xDBFF), 3000, 0x7FFFFFFF),
}


@pytest.mark.parametrize("name", sorted(WORDS))
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("garbage", [False, True])
def test_u32_to_u16_compose_matches_scatter_engine(name, be, garbage):
    _, err_any, *_ = _compare32(WORDS[name], be, garbage=garbage)
    assert bool(err_any) == (name not in ("mixed", "edges"))


def test_u32_too_large_word_emits_one_zero_unit():
    """A word above 0x10FFFF emits the one unit 0x0000 and a surrogate word
    itself; both stay past out_len, so total counts them."""
    words = np.array([0x61, 0x110000, 0x1F642, 0xDC00, 0x62], np.uint32)
    buf = np.concatenate([words, np.zeros(11, np.uint32)])
    out = tcx.u32_to_utf16_compose(torch.from_numpy(buf.view(np.int32)), 5, False)
    assert out[0][:7].view(torch.int16).numpy().view(np.uint16).tolist() == [
        0x61, 0, 0xD83D, 0xDE42, 0xDC00, 0x62, 0]
    assert _compare32(words, False) == [6, 1, 1, 5, 1]
    assert _compare32(words, True) == [6, 1, 1, 5, 1]


def test_u32_empty_and_length_equals_buffer():
    assert _compare32(_W[:2048], True, n=2048)[1] == 0
    assert _compare32(np.zeros(0, np.uint32), False, n=16) == [0, 0, BIG, 0, 0]


VALID_TILES = {
    "mixed_2tiles": _text(2 * T - 1500, 4),
    "pair_at_8191": "x" * (T - 1) + "\U0001f642" + "é東" * 40,
}


@pytest.mark.parametrize("name", sorted(VALID_TILES))
def test_compose_matches_butterflyx_on_valid_input(name):
    text = VALID_TILES[name]
    units, words = _units(text), _words(text)
    n16 = -(-len(units) // T) * T
    buf16 = np.zeros(n16, np.uint16)
    buf16[: len(units)] = units
    want, total, err_any = jbx.u16_to_utf32_compose(jnp.asarray(buf16), jnp.int32(len(units)))
    got = tcx.u16_to_utf32_compose(
        torch.from_numpy(buf16.view(np.int16)).view(torch.uint16), len(units), False)
    assert not bool(err_any) and not bool(got[2])
    assert int(got[1]) == int(total) == len(words)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want))

    n32 = -(-len(words) // T) * T
    buf32 = np.zeros(n32, np.uint32)
    buf32[: len(words)] = words
    for be in (False, True):
        want, total, err_any = jbx.u32_to_utf16_compose(
            jnp.asarray(buf32), jnp.int32(len(words)), be)
        got = tcx.u32_to_utf16_compose(torch.from_numpy(buf32.view(np.int32)), len(words), be)
        assert not bool(err_any) and not bool(got[2])
        assert int(got[1]) == int(total) == len(units)
        assert np.array_equal(got[0].view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want))
