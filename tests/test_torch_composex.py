"""simdutf_tpu_torch.kernels.composex against the JAX package's UTF-32 ->
UTF-8 engines.

The plain version (what runs here) is held against the scatter engine of
``simdutf_tpu.ops.utf32.to_utf8`` (``first_error`` + ``_emit_utf8``), which
gives the JAX package's final result on every input (its butterfly reruns
it on any error), on full padded buffers: the whole u8[4N] buffer, the
bytes past out_len on the error path included, and (error, position,
out_len). On valid input in 8192-word multiples it is also held against
the Pallas ``butterflyx.u32_to_utf8_compose`` (interpret mode on CPU).
Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import butterflyx as jbx
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch.kernels import composex as tcx
from simdutf_tpu_torch.kernels import validate as tv

T = jbx.TILE_E  # 8192-word butterfly tiles (the port's own are 2048)
BIG = 2**31 - 1


@jax.jit
def _jscatter(words, length):
    """ops/utf32.to_utf8's scatter engine: (code, pos, out, out_len)."""
    n = words.shape[0]
    w64 = jo32._native(words, length)
    err_pos, err_code = jo32.first_error(w64, length)
    ok = err_pos == BIG
    out, off, total = jo32._emit_utf8(w64, length, n)
    out_len = jnp.where(ok, total, off[jnp.minimum(err_pos, n - 1)])
    return jnp.where(ok, 0, err_code), jnp.where(ok, length, err_pos), out, out_len


def _compare(words: np.ndarray, length: int | None = None, n: int | None = None,
             garbage: bool = False):
    """Run both on ``words`` in an ``n``-word buffer (the next power of two
    with 8 words of slack by default); returns the port's scalars."""
    length = len(words) if length is None else length
    n = n or 1 << (len(words) + 8).bit_length()
    buf = np.zeros(n, np.uint32)
    if garbage:
        buf[:] = np.random.default_rng(n).integers(0, 1 << 32, n, dtype=np.uint64)
    buf[: len(words)] = words
    code, pos, want, out_len = _jscatter(jnp.asarray(buf), jnp.int32(length))
    w = torch.from_numpy(buf.view(np.int32))
    out, total, err_any, err_pos, err_code, err_len = tcx.u32_to_utf8_compose(w, length)
    assert out.dtype == torch.uint8 and out.shape == (4 * n,)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert bool(err_any) == (int(code) != 0)
    if err_any:
        assert (int(err_pos), int(err_code), int(err_len)) == (int(pos), int(code), int(out_len))
    else:
        assert (int(total), int(err_pos), int(err_code), int(err_len)) == (
            int(out_len), BIG, 0, 0)
        # on valid input total is the utf8len count
        assert int(total) == int(tv.utf32_count(w, length, "utf8len"))
    return [int(v) for v in (total, err_any, err_pos, err_code, err_len)]


def _words(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def _mixed(n: int, seed: int) -> np.ndarray:
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff", "\x00", "\x7f"]
    rng = np.random.default_rng(seed)
    return _words("".join(alphabet[i] for i in rng.integers(0, len(alphabet), n)))


def _with(words, pos, value) -> np.ndarray:
    out = np.array(words, np.uint32)
    out[pos] = value
    return out


_M = _mixed(10_000, 1)
CASES = {
    "mixed": _M,
    "edges": np.array([0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x10FFFF] * 700, np.uint32),
    "too_large_at_0": _with(_M, 0, 0x110000),
    "surrogate_at_2047": _with(_M, 2047, 0xD800),
    "dfff_at_2048": _with(_M, 2048, 0xDFFF),
    "top_bit_at_4097": _with(_M, 4097, 0x80000000),
    "all_ones_at_len-1": _with(_M, len(_M) - 1, 0xFFFFFFFF),
    "two_errors": _with(_with(_M, 7000, 0xDBFF), 3000, 0x7FFFFFFF),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("garbage", [False, True])
def test_compose_matches_scatter_engine(name, garbage):
    total, err_any, *_ = _compare(CASES[name], garbage=garbage)
    assert bool(err_any) == (name not in ("mixed", "edges"))


def test_error_path_keeps_later_bytes():
    """The JAX engine writes every word's bytes: a surrogate as 3 bytes
    after out_len, and a too-large word as 0x00, so total is not the
    utf8len count (which gives a too-large word 4 bytes)."""
    words = np.array([0x61, 0x62, 0xD800, 0x63, 0xE9, 0x1F642], np.uint32)
    assert _compare(words) == [12, 1, 2, 6, 2]
    w = torch.from_numpy(np.concatenate([words, np.zeros(10, np.uint32)]).view(np.int32))
    out = tcx.u32_to_utf8_compose(w, 6)[0]
    assert bytes(out[:13].tolist()) == bytes.fromhex("6162eda08063c3a9f09f998200")
    big = np.array([0x61, 0x110000, 0x62], np.uint32)
    assert _compare(big) == [3, 1, 1, 5, 1]
    assert int(tv.utf32_count(torch.from_numpy(big.view(np.int32)), 3, "utf8len")) == 6


def test_length_equals_buffer_and_empty():
    _compare(_M[:2048], n=2048)
    assert _compare(np.zeros(0, np.uint32), n=16) == [0, 0, BIG, 0, 0]
    assert _compare(_M[:5], length=0, n=16) == [0, 0, BIG, 0, 0]


VALID_TILES = {
    "mixed_2tiles": _mixed(2 * T - 50, 2),
    "widths_at_8192": _words("x" * (T - 2) + "\U0001f642é東" * 30),
}


@pytest.mark.parametrize("name", sorted(VALID_TILES))
def test_compose_matches_butterflyx_on_valid_input(name):
    words = VALID_TILES[name]
    n = -(-len(words) // T) * T
    buf = np.zeros(n, np.uint32)
    buf[: len(words)] = words
    want, total, err_any = jbx.u32_to_utf8_compose(jnp.asarray(buf), jnp.int32(len(words)))
    out, got_total, got_err = tcx.u32_to_utf8_compose(
        torch.from_numpy(buf.view(np.int32)), len(words))[:3]
    assert not bool(err_any) and not bool(got_err)
    assert int(got_total) == int(total) == len(words.tobytes().decode("utf-32-le").encode())
    assert np.array_equal(out.numpy(), np.asarray(want))
