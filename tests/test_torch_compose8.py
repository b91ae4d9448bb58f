"""simdutf_tpu_torch.kernels.compose8 against the Pallas butterfly16
(simdutf_tpu.kernels.butterfly16.to_utf8_compose, interpret mode on CPU,
called directly as tests/test_butterfly16.py does: off the TPU the general
engine routes to the scatter form instead).

The butterfly takes native-order units; the port takes the same units in
storage order with the byte order beside them. Both get one or two
8192-unit tiles and the same length; every element of the contract must be
equal: the full 3N-byte output (zeros past out_len included), total,
err_any, err_pos, err_code and err_len. ``total`` counts 2 bytes for
every surrogate, paired or not, so it equals the "utf8len" count on every
input. The valid-only mode is held against the JAX package's valid-only
engine (ops/utf16._codepoints / _utf8_widths / _emit_utf8). Integer
results: exact. The one-launch kernel's look-back aggregates (its
per-tile triples) are held against the compose results on buffers of
several 8192-unit tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import butterfly16 as jb16
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu_torch.kernels import compose8 as tc8
from simdutf_tpu_torch.kernels import utf16_kernels as tk16

T = jb16.TILE_U  # 8192-unit butterfly tiles (the port's own are 2048)
_jcompose = jax.jit(jb16.to_utf8_compose)
_jutf8len = jax.jit(jo16.utf8_length, static_argnums=2)
_jvalidate = jax.jit(jo16.validate_with_errors, static_argnums=2)


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


def _compare(units: np.ndarray, be: bool, length: int | None = None,
             garbage: bool = False):
    """Run both on ``units`` padded to whole butterfly tiles; the length
    defaults to all of ``units``. Returns the port's scalars as ints."""
    length = len(units) if length is None else length
    n = max(T, -(-len(units) // T) * T)
    buf = np.zeros(n, np.uint16)
    if garbage:  # units past the length are ignored by both
        buf[:] = np.random.default_rng(len(units)).integers(0, 1 << 16, n)
    buf[: len(units)] = units
    want = _jcompose(jnp.asarray(buf), jnp.int32(length))
    stored = buf.byteswap() if be else buf
    w = torch.from_numpy(stored.view(np.int16)).view(torch.uint16)
    got = tc8.to_utf8_compose(w, length, be)
    assert got[0].dtype == torch.uint8 and got[0].shape == (3 * n,)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    rest = [int(v) for v in got[1:]]
    assert rest == [int(v) for v in want[1:]]
    # the invariant: total == utf8_length, valid or not
    assert rest[0] == int(tk16.utf16_reduce(w, length, be, "utf8len"))
    assert rest[0] == int(_jutf8len(jnp.asarray(stored), length, be))
    return rest


def _with(units, pos, value) -> np.ndarray:
    out = np.array(units, np.uint16)
    out[pos] = value
    return out


_ALPHABET = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff", "\x00"]


def _mixed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    text = "".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET), n))
    return _units(text)[:n].copy()


_X = _units("x" * (T + 100))
CASES = {
    # every width interleaved across the 8192-unit tile edge
    "mixed_2tiles": _mixed(2 * T - 77, 1),
    "zh_spaces": _units("東京は日本 " * 1500)[: T - 5],
    "emoji": _units("\U0001f642\U0001f680" * 1000),
    "width_edges": np.array([0x7F, 0x80, 0x7FF, 0x800, 0xD7FF, 0xE000, 0xFFFF] * 300, np.uint16),
    # pairs straddling the butterfly's and the port's tile edges
    "straddle_8192": _units("x" * (T - 1) + "\U0001f642" + "tail é 東"),
    "straddle_2048": _units("x" * 2047 + "\U0001f642" + "é" * 3000),
    # lone surrogates at 0, at tile edges, at length-1
    "lone_high_at_0": _with(_X, 0, 0xD800),
    "lone_low_at_0": _with(_X, 0, 0xDC00),
    "lone_low_at_2048": _with(_X, 2048, 0xDC00),
    "lone_high_at_2047": _with(_X, 2047, 0xD800),
    "lone_high_at_8191": _with(_X, T - 1, 0xDBFF),
    "lone_low_at_8192": _with(_X, T, 0xDFFF),
    "lone_high_at_end": np.concatenate([_mixed(3000, 2)[:2999], [0xD83D]]).astype(np.uint16),
    "lone_high_then_ascii": np.array([0x61, 0xD83D, 0x61, 0x62], np.uint16),
    "lone_low_then_cjk": np.array([0x61, 0xDC00, 0x4E00], np.uint16),
    "two_errors": _with(_with(_mixed(6000, 3), 5000, 0xDC00), 4000, 0xD800),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_compose_matches_butterfly16(name, be):
    total, err_any, err_pos, err_code, err_len = _compare(CASES[name], be)
    assert bool(err_any) == ("lone" in name or name.startswith("two"))


def test_compose_total_on_invalid_input():
    """Butterfly accounting on invalid input: 5 and 6 bytes, where the
    scatter engine's widths would sum to 7 and 4."""
    assert _compare(CASES["lone_high_then_ascii"], False)[:4] == [5, 1, 1, 6]
    assert _compare(CASES["lone_low_then_cjk"], False)[:4] == [6, 1, 1, 6]


@pytest.mark.parametrize("be", [False, True])
def test_compose_high_at_length_minus_one(be):
    """A high surrogate at length-1 whose low is stored at length is
    lone; garbage past the length is ignored."""
    units = _units("ab é \U0001f642" * 500)
    L = len(units) - 1
    assert units[L - 1] >> 10 == 0xD800 >> 10
    total, err_any, err_pos, err_code, err_len = _compare(units, be, L, garbage=True)
    assert err_any and err_pos == L - 1 and err_len == total - 2


@pytest.mark.parametrize("seed", range(4))
def test_compose_random_lone_surrogates_and_garbage(seed):
    rng = np.random.default_rng(seed)
    units = _mixed(int(rng.integers(1, T)), 10 + seed)
    for _ in range(seed % 3):
        units[int(rng.integers(0, len(units)))] = int(rng.integers(0xD800, 0xE000))
    _compare(units, bool(seed & 1), garbage=True)


def test_compose_empty_length():
    assert _compare(np.zeros(0, np.uint16), False) == [0, 0, 2**31 - 1, 0, 0]


@pytest.mark.parametrize("err", [False, True])
def test_tile_glue(err):
    """The torch glue that the composex kernels run between their passes
    (on the card only; compose8 folds the same triples in its look-back),
    on hand-made per-tile vectors: offsets, total, and the first error from
    the least event key."""
    from simdutf_tpu_torch.ops.common import BIG, tile_glue

    none = BIG << 8
    counts = torch.tensor([3, 5, 2], dtype=torch.int32)
    keys = torch.tensor([none, (7 << 8) | 6 if err else none,
                         (9 << 8) | 3 if err else none], dtype=torch.int64)
    prefix = torch.tensor([3, 4, 1], dtype=torch.int32)
    off, *rest = tile_glue(counts, keys, prefix)
    assert off.tolist() == [0, 3, 8]
    want = [10, True, 7, 6, 7, 7] if err else [10, False, BIG, 0, 0, 10]
    assert [int(v) for v in rest] == want


def _valid_engine(stored, length, be: bool):
    w = jo16.native(stored, length, be)
    cp, start = jo16._codepoints(w, length)
    out, _, total = jo16._emit_utf8(cp, start, jo16._utf8_widths(cp, start), stored.shape[0])
    return out, total


_jvalid = jax.jit(_valid_engine, static_argnums=2)


def _jax_valid_engine(buf: np.ndarray, length: int, be: bool):
    """The JAX package's valid-only engine (the general branch of
    ops/utf16.to_utf8_valid) on native-order units ``buf``."""
    stored = buf.byteswap() if be else buf
    out, total = _jvalid(jnp.asarray(stored), length, be)
    return np.asarray(out), int(total)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_valid_mode_matches_jax_valid_engine(name, be):
    """The valid-only mode: a high pairs with whatever follows it, a lone
    low writes nothing; full 3N-byte buffer and total, no error reported."""
    units = CASES[name]
    n = max(T, -(-len(units) // T) * T)
    buf = np.zeros(n, np.uint16)
    buf[: len(units)] = units
    want_out, want_total = _jax_valid_engine(buf, len(units), be)
    stored = buf.byteswap() if be else buf
    w = torch.from_numpy(stored.view(np.int16)).view(torch.uint16)
    out, total, *err = tc8.to_utf8_compose(w, len(units), be, mode="valid")
    assert np.array_equal(out.numpy(), want_out)
    assert int(total) == want_total
    assert [int(v) for v in err] == [0, 2**31 - 1, 0, 0]


@pytest.mark.parametrize("be", [False, True])
def test_valid_mode_high_at_length_minus_one_pairs_with_zero(be):
    """A high at length-1 pairs with 0, not with the low stored at the
    length (the opposite of the UTF-16 -> UTF-32 rerun's partner), and a
    run of highs asks for more than the 3N-byte buffer holds."""
    units = _units("ab\U0001f642")
    stored = units.byteswap() if be else units.copy()
    w = torch.from_numpy(stored.view(np.int16)).view(torch.uint16)
    out, total = tc8.to_utf8_compose(w, 3, be, mode="valid")[:2]
    assert int(total) == 6 and bytes(out.numpy()[:6]) == b"ab\xf0\x91\xa0\x80"  # U+11800
    highs = np.full(64, 0xDBFF, np.uint16)  # each makes a 4-byte code point
    w = torch.from_numpy((highs.byteswap() if be else highs).view(np.int16)).view(torch.uint16)
    out, total = tc8.to_utf8_compose(w, 64, be, mode="valid")[:2]
    assert int(total) == 4 * 64 and out.shape == (192,)
    assert np.array_equal(out.numpy(), _jax_valid_engine(highs, 64, False)[0])


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        tc8.to_utf8_compose(torch.zeros(4, dtype=torch.int16).view(torch.uint16), 2, False,
                            mode="lenient")


# -- the look-back aggregates of the one-launch kernel -----------------------
#
# csrc/compose8.cu publishes one (bytes, least event key, bytes before it)
# triple a tile of 8192 units and folds its predecessors' with the
# look-back's combine; the fold of the plain per-tile triples must give the
# compose result's total, first error and err_len, in both modes and byte
# orders.

TT = tc8.TILE  # 8192-unit look-back tiles
NO_EVENT = (2**31 - 1) << 8


def _combine(a, b):
    """The look-back's combine of two adjacent runs, ``a`` the earlier."""
    return (a[0] + b[0], min(a[1], b[1]), a[2] if a[1] < b[1] else a[0] + b[2])


def _dense(n: int, seed: int) -> np.ndarray:
    """``n`` units of every width, pairs included, and no lone surrogate."""
    units = _mixed(n, seed)
    if units[-1] >> 10 == 0xD800 >> 10:  # a pair cut at the end
        units[-1] = 0x78
    return units


def _plant(units: np.ndarray, pos: int, value: int) -> np.ndarray:
    """``units`` with ``value`` at ``pos`` and 'x' on either side, so that
    a planted surrogate is lone and breaks no pair around it."""
    out = _with(units, slice(max(pos - 1, 0), pos + 2), 0x78)
    if pos >= 2 and out[pos - 2] >> 10 == 0xD800 >> 10:  # a high left lone
        out[pos - 2] = 0x78
    if pos + 2 < len(out) and out[pos + 2] >> 10 == 0xDC00 >> 10:  # a low left lone
        out[pos + 2] = 0x78
    out[pos] = value
    return out


_D = _dense(4 * TT + 777, 21)
LOOKBACK_CASES = {
    "valid-many-tiles": _D,
    "valid-one-tile": _dense(TT, 22),
    "valid-tile+1": _dense(TT + 1, 23),
    "valid-pair-straddles-tile": _with(_with(_D, TT - 1, 0xD83D), TT, 0xDE42),
    "lone-hi@0": _plant(_D, 0, 0xD800),
    "lone-lo@0": _plant(_D, 0, 0xDC00),
    "lone-lo@tile": _plant(_D, TT, 0xDFFF),
    "lone-hi@tile-1": _plant(_D, TT - 1, 0xDBFF),
    "lone-hi@2tile-1": _plant(_D, 2 * TT - 1, 0xD800),
    "lone-lo@3tile": _plant(_D, 3 * TT, 0xDC00),
    "lone-hi@len-1": _with(_D, len(_D) - 1, 0xD83D),
    "two-errors": _plant(_plant(_D, 3 * TT + 9, 0xDC00), TT + 3, 0xD800),
}


def _stored(units: np.ndarray, be: bool, extra: int = 5) -> torch.Tensor:
    """``units`` in storage order, with ``extra`` garbage units past them."""
    buf = np.random.default_rng(len(units)).integers(0, 1 << 16, len(units) + extra)
    buf = buf.astype(np.uint16)
    buf[: len(units)] = units
    stored = buf.byteswap() if be else buf
    return torch.from_numpy(stored.view(np.int16)).view(torch.uint16)


@pytest.mark.parametrize("mode", ["validate", "valid"])
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("name", sorted(LOOKBACK_CASES))
def test_tile_triples_combine_to_the_first_error(name, be, mode):
    units = LOOKBACK_CASES[name]
    L = len(units)
    w = _stored(units, be)
    count, key, before = tc8.tile_aggregates_ref(w, L, be, mode)
    assert count.numel() == -(-L // TT)
    acc = (0, NO_EVENT, 0)
    for t in zip(count.tolist(), key.tolist(), before.tolist()):
        acc = _combine(acc, t)
    total, key, before = acc
    _, want_total, err_any, err_pos, err_code, err_len = tc8.to_utf8_compose_ref(w, L, be, mode)
    assert total == int(want_total)
    assert (key >> 8, key & 0xFF) == (int(err_pos), int(err_code))
    assert bool(err_any) == (key != NO_EVENT) == (
        mode == "validate" and ("lone" in name or name == "two-errors"))
    assert (before if key != NO_EVENT else 0) == int(err_len)
    if mode == "validate":
        assert total == int(tk16.utf16_reduce(w, L, be, "utf8len"))
        stored = units.byteswap() if be else units
        code, pos = _jvalidate(jnp.asarray(stored), L, be)
        assert (int(pos) if int(code) else 2**31 - 1) == key >> 8
    else:
        buf = np.zeros(L + 5, np.uint16)
        buf[:L] = units
        assert total == _jax_valid_engine(buf, L, be)[1]


def test_tile_aggregates_on_the_cpu_are_the_plain_ones():
    w = _stored(LOOKBACK_CASES["two-errors"], False)
    L = len(LOOKBACK_CASES["two-errors"])
    for mode in ("validate", "valid"):
        for got, want in zip(tc8._tile_aggregates(w, L, False, mode),
                             tc8.tile_aggregates_ref(w, L, False, mode)):
            assert torch.equal(got, want)
    assert tc8._tile_aggregates(w, 0, False)[0].numel() == 0


@pytest.mark.parametrize("mode", ["validate", "valid"])
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("name", ["valid-many-tiles", "lone-hi@tile-1", "two-errors"])
def test_compose_matches_scatter_engine_across_lookback_tiles(name, be, mode):
    """The compose contract on buffers of several 8192-unit tiles: the
    butterfly's in the validating mode, the JAX valid-only engine's in the
    other, with garbage past the length."""
    units = LOOKBACK_CASES[name]
    if mode == "validate":
        _compare(units, be, garbage=True)
        return
    n = -(-len(units) // T) * T
    buf = np.zeros(n, np.uint16)
    buf[: len(units)] = units
    want_out, want_total = _jax_valid_engine(buf, len(units), be)
    stored = buf.byteswap() if be else buf
    w = torch.from_numpy(stored.view(np.int16)).view(torch.uint16)
    out, total, *err = tc8.to_utf8_compose(w, len(units), be, mode="valid")
    assert np.array_equal(out.numpy(), want_out)
    assert int(total) == want_total
    assert [int(v) for v in err] == [0, 2**31 - 1, 0, 0]
