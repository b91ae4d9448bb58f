"""simdutf_tpu_torch.kernels.compose32 against the JAX package's UTF-8 ->
UTF-32 engines.

The plain version (what runs here) is held against
``simdutf_tpu.ops.utf8._to_utf32_general``, the scatter engine that gives
the JAX package's final result on every input (its butterfly reruns it on
any error), on full padded buffers: the whole u32[N] buffer, the decoded
words past out_len on the error path included, and (error, position,
out_len). On valid input in 8192-byte multiples it is also held against
the Pallas ``butterfly32.to_utf32_compose`` (interpret mode on CPU, called
directly as tests/test_butterfly32.py does). Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import butterfly32 as jb32
from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu_torch.kernels import compose32 as tc32
from simdutf_tpu_torch.kernels import validate as tv

T = jb32.TILE_B  # 8192-byte butterfly tiles (the port's own are 16384)
_jgeneral = jax.jit(jo8._to_utf32_general)


def _compare(data: bytes, length: int | None = None, n: int | None = None,
             garbage: bool = False):
    """Run both on ``data`` in an ``n``-byte buffer (the next power of two
    with 8 bytes of slack by default); returns the port's scalars."""
    length = len(data) if length is None else length
    n = n or 1 << (len(data) + 8).bit_length()
    buf = np.zeros(n, np.uint8)
    if garbage:
        buf[:] = np.random.default_rng(n).integers(0, 256, n)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    code, pos, want, out_len = _jgeneral(jnp.asarray(buf), jnp.int32(length))
    x = torch.from_numpy(buf)
    out, total, err_any, err_pos, err_code, err_len = tc32.to_utf32_compose(x, length)
    assert out.dtype == torch.int32 and out.shape == (n,)
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(want))
    assert bool(err_any) == (int(code) != 0)
    if err_any:
        assert (int(err_pos), int(err_code), int(err_len)) == (int(pos), int(code), int(out_len))
    else:
        assert (int(total), int(err_pos), int(err_code), int(err_len)) == (
            int(out_len), 2**31 - 1, 0, 0)
    # total counts every in-range lead, valid or not
    assert int(total) == int(tv.utf8_count(x, length))
    return [int(v) for v in (total, err_any, err_pos, err_code, err_len)]


def _mixed(nbytes: int, seed: int) -> bytes:
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff"]
    rng = np.random.default_rng(seed)
    text = "".join(alphabet[i] for i in rng.integers(0, len(alphabet), nbytes))
    return text.encode()[:nbytes].decode("utf-8", "ignore").encode()


_MIX = _mixed(20_000, 1)


def _put(data: bytes, pos: int, bad: bytes) -> bytes:
    d = bytearray(data)
    d[pos:pos + len(bad)] = bad
    return bytes(d)


CASES = {
    "mixed": _MIX,
    "zh_spaces": "東京は日本 ".encode() * 900,
    "emoji": "\U0001f642\U0010ffff".encode() * 700,
    "straddle4_at_4096": b"a" * 4095 + "\U0001f642".encode() + "é".encode() * 50,
    "header_ff": b"ab\xffcd\xc3\xa9",
    "orphan_at_0": b"\x80" + "東".encode() * 300,
    "cut_at_length": "é東".encode() * 500 + "\U0001f642".encode()[:2],
    "lead4_at_len-1": _MIX[:8191] + b"\xf0",
    "surrogate": _put(_MIX, 9000, b"\xed\xa0\x80"),
    "overlong": _put(_MIX, 4096, b"\xc0\xaf"),
    "too_large": _put(_MIX, 4095, b"\xf4\x90\x80\x80"),
    "err_at_4097": _put(_MIX, 4097, b"\xff"),
    "err_at_len-1": _MIX[:9_999] + b"\xc3",
    "two_errors": _put(_put(_MIX, 15_000, b"\x80"), 6000, b"\xf8"),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("garbage", [False, True])
def test_compose_matches_scatter_engine(name, garbage):
    total, err_any, *_ = _compare(CASES[name], garbage=garbage)
    assert bool(err_any) == (name not in ("mixed", "zh_spaces", "emoji",
                                          "straddle4_at_4096"))


def test_error_path_keeps_decoded_words():
    """The JAX engine leaves every lead's word in place past out_len: 0xFF
    decodes to 0, and the words after it stay."""
    total, err_any, err_pos, err_code, err_len = _compare(b"ab\xffcd\xc3\xa9")
    assert (total, err_any, err_pos, err_code, err_len) == (6, 1, 2, 1, 2)
    out = tc32.to_utf32_compose(torch.from_numpy(np.frombuffer(
        b"ab\xffcd\xc3\xa9" + bytes(1017), np.uint8).copy()), 7)[0]
    assert out[:7].tolist() == [97, 98, 0, 99, 100, 233, 0]


def test_length_equals_buffer_and_empty():
    _compare(_MIX[:4096], n=4096)
    assert _compare(b"", n=16) == [0, 0, 2**31 - 1, 0, 0]
    assert _compare(b"abc", length=0, n=16) == [0, 0, 2**31 - 1, 0, 0]


VALID_TILES = {
    "mixed_2tiles": _mixed(2 * T - 50, 2),
    "straddle_8192": b"x" * (T - 2) + "\U0001f642".encode() + "東".encode() * 20,
}


@pytest.mark.parametrize("name", sorted(VALID_TILES))
def test_compose_matches_butterfly32_on_valid_input(name):
    data = VALID_TILES[name]
    n = -(-len(data) // T) * T
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    want, total, err_any = jb32.to_utf32_compose(jnp.asarray(buf), jnp.int32(len(data)))
    out, got_total, got_err = tc32.to_utf32_compose(torch.from_numpy(buf), len(data))[:3]
    assert not bool(err_any) and not bool(got_err)
    assert int(got_total) == int(total) == len(data.decode())
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(want))


# -- the look-back aggregates of the one-launch kernel -----------------------
#
# csrc/compose32.cu publishes one (words, least event key, words before it)
# triple a tile and folds its predecessors' with the look-back's combine;
# the fold of the plain per-tile triples must give the compose result's
# total, first error and err_len, and the JAX package's first error.

TT = tc32.TILE  # the look-back tiles (8 KiB)
NO_EVENT = (2**31 - 1) << 8


def _combine(a, b):
    """The look-back's combine of two adjacent runs, ``a`` the earlier."""
    return (a[0] + b[0], min(a[1], b[1]), a[2] if a[1] < b[1] else a[0] + b[2])


def _dense(size: int, seed: int) -> bytes:
    """Whitespace-free mixed text of ``size`` bytes (cut at a character
    start, padded with 'x')."""
    alphabet = ["x", "é", "Ж", "東", "\U0001f642"]
    rng = np.random.default_rng(seed)
    d = "".join(alphabet[i] for i in rng.integers(0, 5, size)).encode()[:size]
    d = d.decode("utf-8", "ignore").encode()
    return d + b"x" * (size - len(d))


_DENSE = _dense(4 * TT + 777, 3)
LOOKBACK_CASES = {
    "valid-many-tiles": _DENSE,
    "valid-one-tile": _dense(TT, 6),
    "valid-tile+1": _dense(TT + 1, 4),
    "ff@0": _put(_DENSE, 0, b"\xff"),
    "orphan@0": b"\x80" + _DENSE[1:],
    "orphan@tile": _put(_dense(3 * TT, 5), TT, b"\x80"),
    "ff@tile-1": _put(_DENSE, TT - 1, b"\xff"),
    "overlong@tile-1": _put(_DENSE, TT - 1, b"\xc0\xaf"),
    "surrogate@tile-2": _put(_DENSE, TT - 2, b"\xed\xa0\x80"),
    "too-large@2tile-1": _put(_DENSE, 2 * TT - 1, b"\xf4\x90\x80\x80"),
    "cut3@3tile-1": _put(_DENSE, 3 * TT - 1, b"\xe6\x9d\x41"),
    "err@len-1": _DENSE[:-1] + b"\xc3",
    "lead4-cut@len": _DENSE[:2 * TT + 5] + "\U0001f642".encode()[:3],
    "lead4@len-1": _DENSE[:TT - 1] + b"\xf0",
    "two-errors": _put(_put(_DENSE, 3 * TT + 9, b"\xff"), TT + 3, b"\xf8"),
}


@pytest.mark.parametrize("name", sorted(LOOKBACK_CASES))
def test_tile_triples_combine_to_the_first_error(name):
    data = LOOKBACK_CASES[name]
    n = len(data) + 5
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    x = torch.from_numpy(buf)
    count, key, before = tc32.tile_aggregates_ref(x, len(data))
    assert count.numel() == -(-len(data) // TT)
    acc = (0, NO_EVENT, 0)
    for t in zip(count.tolist(), key.tolist(), before.tolist()):
        acc = _combine(acc, t)
    total, key, before = acc
    _, want_total, err_any, err_pos, err_code, err_len = tc32.to_utf32_compose_ref(x, len(data))
    assert total == int(want_total) == int(tv.utf8_count(x, len(data)))
    assert (key >> 8, key & 0xFF) == (int(err_pos), int(err_code))
    assert bool(err_any) == (key != NO_EVENT) == ("valid" not in name)
    assert (before if key != NO_EVENT else 0) == int(err_len)
    code, pos = jo8.validate_with_errors(jnp.asarray(buf), len(data))
    assert (int(pos) if int(code) else 2**31 - 1) == key >> 8
    assert int(code) == key & 0xFF


def test_tile_aggregates_on_the_cpu_are_the_plain_ones():
    x = torch.from_numpy(np.frombuffer(_DENSE, np.uint8).copy())
    for got, want in zip(tc32._tile_aggregates(x, len(_DENSE)),
                         tc32.tile_aggregates_ref(x, len(_DENSE))):
        assert torch.equal(got, want)
    assert tc32._tile_aggregates(x, 0)[0].numel() == 0


@pytest.mark.parametrize("name", ["valid-many-tiles", "ff@tile-1", "lead4-cut@len"])
def test_compose_matches_scatter_engine_across_lookback_tiles(name):
    """The compose contract on buffers of several look-back tiles."""
    _compare(LOOKBACK_CASES[name], garbage=True)


def _text_with(size: int, marks: dict) -> bytes:
    """Valid text with no 4-byte sequence, ``size`` bytes, with the
    sequence ``marks[pos]`` at each byte ``pos``."""
    src = "ab é 東 Жм ".encode() * (size // 10 + 1)
    out, at = b"", 0
    for pos in sorted(marks) + [size]:
        piece = src[:pos - at].decode("utf-8", "ignore").encode()
        out += piece + b"a" * (pos - at - len(piece)) + marks.get(pos, b"")
        at = pos + len(marks.get(pos, b""))
    return out


def test_tile_paths_on_the_cpu_are_the_plain_count():
    """_tile_paths on a CPU tensor: per tile, its data warps with no
    4-byte lead among their bytes and the byte before them; none on a
    tile the fast check flags."""
    W = TT // tc32.WARPS  # bytes a warp
    lead4 = "\U0001f642".encode()
    size = 6 * TT + 999
    data = bytearray(_text_with(size, {TT + 2 * W - 1: lead4,  # warps 1 and 2 of tile 1
                                       3 * TT + 5 * W + 100: lead4,  # warp 5 of tile 3
                                       5 * TT + W - 2: lead4}))  # warp 0 of tile 5
    data[4 * TT + 3 * W] = 0xFF  # tile 4 flagged
    want = [tc32.WARPS] * 7
    want[1] -= 2
    want[3] -= 1
    want[4] = 0
    want[5] -= 1
    x = torch.from_numpy(np.frombuffer(bytes(data), np.uint8).copy())
    assert tc32._tile_paths(x, size).tolist() == want
    assert tc32._tile_paths(x, 0).numel() == 0
