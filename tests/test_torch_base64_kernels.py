"""simdutf_tpu_torch.kernels.compact64 and kernels.base64_kernel against
the JAX package on CPU.

The compaction (compact_codes and the routed decode built on it) is held
against the Pallas butterfly (simdutf_tpu.kernels.butterfly64, interpret
mode, pinned with ``ep._CHOICE64 = "butterfly"`` as
tests/test_butterfly64.py pins it) on whole 32 KiB butterfly tiles, and
against the scatter engine (simdutf_tpu.ops.base64_ops.decode_bulk) on
the trouble cases: invalid chars at 0, at tile edges, at length-1 and at
length, dense whitespace, garbage past the length, length == N, uint8
and uint16 chars, the three alphabet modes. The packs and the encode are
held against pack_sextets, pack_words and block_encode. Integer results:
exact, the full ``packed`` buffer included.
"""

import base64 as pyb64
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdutf_tpu.kernels.base64_kernel as jkb
import simdutf_tpu.kernels.butterfly64 as jkb64
import simdutf_tpu.ops.base64_ops as job
from simdutf_tpu.ops import engine_probe as ep
from simdutf_tpu_torch.kernels import base64_kernel as tkb
from simdutf_tpu_torch.kernels import compact64 as tc64
from simdutf_tpu_torch.ops import base64_ops as tob
from test_butterfly64 import CORPORA

MODES = [(False, False), (True, False), (False, True)]  # (url, both)
T = jkb64.TILE  # 32 KiB butterfly tiles (the port's own are 16384 chars)
_jscatter = jax.jit(job.decode_bulk, static_argnames=("url", "both"))
# own jit objects, traced only while the butterfly is pinned
_jrouted = jax.jit(job.decode_bulk_routed, static_argnames=("url", "both"))
_jcompact = jax.jit(jkb64.compact_codes, static_argnames=("url", "both"))


def _buffer(data: bytes, n: int, garbage: bool = False) -> np.ndarray:
    buf = np.zeros(n, np.uint8)
    if garbage:  # chars past the length are ignored by both
        buf[:] = np.random.default_rng(len(data)).integers(0, 256, n)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return buf


def _torch(buf: np.ndarray) -> torch.Tensor:
    if buf.dtype == np.uint16:
        return torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(buf)


def _same(got, want):
    """The six decode outputs, value for value and byte for byte."""
    assert got[3].dtype == torch.uint8 and got[4].dtype == torch.uint8
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g.numpy(), np.int64), np.asarray(w, np.int64)
        assert g.shape == w.shape and np.array_equal(g, w), i


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("url,both", MODES)
def test_routed_matches_butterfly(name, url, both):
    buf = _buffer(bytes(CORPORA[name]), 3 * T)
    L = len(CORPORA[name])
    with mock.patch.object(ep, "_CHOICE64", "butterfly"):
        want = _jrouted(jnp.asarray(buf), jnp.int32(L), url=url, both=both)
    _same(tob.decode_bulk_routed(_torch(buf), L, url, both), want)


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("url,both", MODES)
@pytest.mark.parametrize("wide", [False, True])
def test_corpora_match_scatter(name, url, both, wide):
    buf = _buffer(bytes(CORPORA[name]), 3 * T)
    buf = buf.astype(np.uint16) if wide else buf
    L = len(CORPORA[name])
    want = _jscatter(jnp.asarray(buf), jnp.int32(L), url=url, both=both)
    _same(tob.decode_bulk_routed(_torch(buf), L, url, both), want)


@pytest.mark.parametrize("name", ["clean", "mime_crlf", "space_every_4"])
def test_compact_matches_butterfly(name):
    buf = _buffer(bytes(CORPORA[name]), 3 * T, garbage=True)
    L = len(CORPORA[name]) - 3
    with mock.patch.object(ep, "_CHOICE64", "butterfly"):
        words, nvalid, first_bad, nab, cand_ok, _ = _jcompact(
            jnp.asarray(buf), jnp.int32(L), url=False, both=False)
    assert bool(cand_ok)
    codes, *scalars = tc64.compact_codes(_torch(buf), L, False, False)
    assert np.array_equal(codes.numpy(), np.asarray(words).view(np.uint8).reshape(-1))
    assert [int(v) for v in scalars[:3]] == [int(nvalid), int(first_bad), int(nab)]


def _mime(n: int) -> bytes:
    raw = pyb64.b64encode(np.random.default_rng(n).bytes(n))
    return b"\r\n".join(raw[i: i + 76] for i in range(0, len(raw), 76))


def _put(data: bytes, pos: int, ch: bytes) -> bytes:
    d = bytearray(data)
    d[pos: pos + len(ch)] = ch
    return bytes(d)


_M = _mime(30_000)  # 40,000 chars + CRLFs
# (chars, buffer size, length or None for all of chars, garbage past it)
TROUBLE = {
    "mime": (_M, 65536, None, False),
    "mime_garbage_past_length": (_M, 65536, None, True),
    "bad_at_0": (_put(_M, 0, b"*"), 65536, None, False),
    "bad_at_4095": (_put(_M, 4095, b"!"), 65536, None, False),
    "bad_at_4096": (_put(_M, 4096, b"="), 65536, None, False),
    "bad_at_32767": (_put(_M, 32767, b"\x80"), 65536, None, True),
    "bad_at_32768": (_put(_M, 32768, b"\xff"), 65536, None, False),
    "bad_at_len_minus_1": (_M + b"*", 65536, None, False),
    "bad_at_len": (_M + b"*", 65536, len(_M), False),
    "two_bad_alphabet_after": (_put(_put(_M, 9000, b"*"), 20000, b"$"), 65536, None, False),
    "eq_inside": (b"QUJD=REVG" * 100, 1024 * 4, None, False),
    "all_ws_tiles": (b" " * (3 * 4096) + b"TWFu" + b"\n" * 9000 + b"QQ", 65536, None, False),
    "ws_then_bad": (b"\t" * 20000 + b"*" + b"TWFuTQ", 65536, None, False),
    "tail_1": (b"TWFu" * 500 + b"Q", 4096, None, True),
    "tail_2": (b"TW\nFu" * 700 + b"QQ", 4096, None, False),
    "tail_3": (b"TWFu " * 300 + b"QUI", 4096, None, False),
    "length_0": (b"TWFu", 1024, 0, True),
    "len_eq_n_last_valid": (b"TWFu" * 256, 1024, None, False),
    "len_eq_n_last_ws": (b"TWFu" * 255 + b"TWF ", 1024, None, False),
    "len_eq_n_bad_last": (b"TWFu" * 255 + b"TWF*", 1024, None, False),
    "url_and_std": (b"ab+/cd-_" * 600, 8192, None, False),
    "random_alphabet": (bytes(np.random.default_rng(5).choice(
        np.frombuffer(b"AZaz09+/-_ \t\r\n\x0c", np.uint8), 50_000)), 65536, None, False),
}


def _trouble(name: str, wide: bool):
    data, n, L, garbage = TROUBLE[name]
    buf = _buffer(data, n, garbage)
    L = len(data) if L is None else L
    if wide:  # char16: units above 0xFF are invalid, even where the low byte is 'A'
        buf = buf.astype(np.uint16)
        if garbage:
            buf[L:] = np.random.default_rng(L).integers(0, 1 << 16, n - L)
        if name == "mime":
            buf[12_345] = 0x141
    return buf, L


@pytest.mark.parametrize("name", sorted(TROUBLE))
@pytest.mark.parametrize("url,both", MODES)
@pytest.mark.parametrize("wide", [False, True])
def test_compact_matches_scatter(name, url, both, wide):
    buf, L = _trouble(name, wide)
    want = _jscatter(jnp.asarray(buf), jnp.int32(L), url=url, both=both)
    got = tob.decode_bulk_routed(_torch(buf), L, url, both)
    _same(got, want)
    # the compaction's own contract: codes zero past nvalid, and
    # nvalid_at_bad 0 with no invalid char
    codes, nvalid, first_bad, nab, tail_start = tc64.compact_codes(_torch(buf), L, url, both)
    assert not codes[int(nvalid):].any()
    assert int(nab) == (int(want[2]) if int(first_bad) < tc64.BIG else 0)
    assert int(tail_start) == int(want[5])


def test_trouble_cases_reach_their_edges():
    """The cases exercise what their names say, on the JAX side."""
    def scatter(name, wide=False):
        buf, L = _trouble(name, wide)
        return [int(np.asarray(v)) for i, v in enumerate(
            _jscatter(jnp.asarray(buf), jnp.int32(L), url=False, both=False)) if i in (0, 1, 2, 5)]

    assert scatter("bad_at_0")[0] == 0
    assert scatter("bad_at_32768")[0] == 32768
    assert scatter("bad_at_len")[0] == tc64.BIG
    assert scatter("mime", wide=True)[0] == 12_345
    fb, nvalid, nab, _ = scatter("len_eq_n_last_valid")
    assert fb == tc64.BIG and nab == nvalid - 1 == 1023
    fb, nvalid, nab, _ = scatter("len_eq_n_last_ws")
    assert nab == nvalid == 1023
    assert [scatter(f"tail_{k}")[1] % 4 for k in (1, 2, 3)] == [1, 2, 3]


def _codes_words(rng, shape):
    """int32 words of 4 sextet values, and words of any bytes."""
    sextets = rng.integers(0, 64, shape + (4,), dtype=np.uint8)
    return (sextets.view(np.int32).reshape(shape),
            rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("rows", [16, 48])
def test_pack_sextets_matches_jax(rows):
    for w in _codes_words(np.random.default_rng(rows), (rows, 512)):
        got = tkb.pack_sextets(torch.from_numpy(w))
        assert got.dtype == torch.int32 and got.shape == (rows, 384)
        assert np.array_equal(got.numpy(), np.asarray(jkb.pack_sextets(jnp.asarray(w))))


@pytest.mark.parametrize("rows", [64, 128])
def test_pack_words_matches_jax(rows):
    for w in _codes_words(np.random.default_rng(rows), (rows, 128)):
        got = tkb.pack_words(torch.from_numpy(w))
        assert got.dtype == torch.int32 and got.shape == (rows * 3 // 4, 128)
        assert np.array_equal(got.numpy(), np.asarray(jkb.pack_words(jnp.asarray(w))))


@pytest.mark.parametrize("url", [False, True])
@pytest.mark.parametrize("rows", [16, 20])
def test_block_encode_matches_jax(rows, url):
    x = np.random.default_rng(rows).integers(-2**31, 2**31, (rows, 384)).astype(np.int32)
    got = tkb.block_encode(torch.from_numpy(x), url)
    assert got.dtype == torch.int32 and got.shape == (rows, 512)
    assert np.array_equal(got.numpy(), np.asarray(jkb.block_encode(jnp.asarray(x), url)))
    chars = got.numpy().view(np.uint8).tobytes()
    enc = pyb64.urlsafe_b64encode if url else pyb64.b64encode
    assert chars == enc(x.tobytes())


@pytest.mark.parametrize("n", [4, 12, 16, 20, 1028])
def test_pack_flat_matches_sextets_to_bytes(n):
    """The flat pack at sizes the word planes cannot take."""
    codes = np.random.default_rng(n).integers(0, 64, n).astype(np.uint8)
    got = tkb.pack(torch.from_numpy(codes))
    want = np.asarray(job.sextets_to_bytes(jnp.asarray(codes), n))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    assert tkb.pack(torch.zeros(0, dtype=torch.uint8)).shape == (0,)
    assert tkb.encode(torch.zeros(0, dtype=torch.uint8), True).shape == (0,)
    with pytest.raises(ValueError):
        tkb.pack(torch.zeros(6, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tkb.encode(torch.zeros(4, dtype=torch.uint8), False)
    with pytest.raises(TypeError):
        tkb.pack(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        tc64.compact_codes(torch.zeros(8, dtype=torch.int32), 8, False, False)
    with pytest.raises(ValueError):
        tc64.compact_codes(torch.zeros(8, dtype=torch.uint8), 9, False, False)
    with pytest.raises(ValueError):
        tob.decode_bulk_routed(torch.zeros(6, dtype=torch.uint8), 6, False, False)
