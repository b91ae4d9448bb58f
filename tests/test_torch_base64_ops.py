"""simdutf_tpu_torch.ops.base64_ops and the port's base64 host helpers
against the JAX package on CPU.

Same padded buffer (the JAX package's bucket), same length and options
into both: the six outputs of ``decode_bulk`` and ``decode_bulk_routed``
(the full ``packed`` buffer included), ``encode_bulk`` byte for byte, the
char classification, and the host helpers ``b64_strip``,
``b64_tail_epilogue`` and ``b64_finish`` of simdutf_tpu_torch.base64_host
against those of simdutf_tpu.ops.impl. Integer results: exact.
"""

import base64 as pyb64
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdutf_tpu.ops.base64_ops as job
import simdutf_tpu.ops.impl as jimpl
from simdutf_tpu.golden import base64_impl as gb
from simdutf_tpu_torch import base64_host as bh
from simdutf_tpu_torch import impl
from simdutf_tpu_torch.ops import base64_ops as tob

MODES = [(False, False), (True, False), (False, True)]  # (url, both)
_jdecode = jax.jit(job.decode_bulk, static_argnames=("url", "both"))
_jencode = jax.jit(job.encode_bulk, static_argnames=("url",))


def _torch(buf: np.ndarray) -> torch.Tensor:
    if buf.dtype == np.uint16:
        return torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(buf)


def _wrap(raw: bytes, every: int = 76, sep: bytes = b"\r\n") -> bytes:
    return sep.join(raw[i: i + every] for i in range(0, len(raw), every))


_RNG = np.random.default_rng(64)
CASES = {
    "empty": b"",
    "clean": pyb64.b64encode(_RNG.bytes(3000)),
    "mime": _wrap(pyb64.b64encode(_RNG.bytes(6000))),
    "url_mime": _wrap(pyb64.urlsafe_b64encode(_RNG.bytes(5000)), 64, b"\n"),
    "spaces": b" ".join(b"TWFu" for _ in range(700)) + b" QQ",
    "invalid_mid": b"TWFuTWFu" * 300 + b"%" + b"QUJD" * 100,
    "char_0x80": b"QUJD\x80QUJD",
    "pad_inside": b"QUJD==QUJD",
    "tail_3": b"TWFu\tTWFu\n\x0cQUJ",
}


def _staged(data: bytes, wide: bool):
    arr = np.frombuffer(data, np.uint8)
    if wide:
        arr = arr.astype(np.uint16)
    buf, L = impl._pad(arr)
    return buf.copy(), int(L)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("url,both", MODES)
@pytest.mark.parametrize("wide", [False, True])
def test_decode_matches_jax(name, url, both, wide):
    buf, L = _staged(CASES[name], wide)
    want = [np.asarray(v, np.int64) for v in _jdecode(jnp.asarray(buf), L, url=url, both=both)]
    for fn in (tob.decode_bulk, tob.decode_bulk_routed):
        got = fn(_torch(buf), L, url, both)
        assert [g.dtype for g in got[3:5]] == [torch.uint8, torch.uint8]
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(np.asarray(g.numpy(), np.int64), w), (fn.__name__, i)


def test_char16_units_above_0xff_are_invalid():
    buf, L = _staged(b"QUJDQUJD", True)
    buf[5] = 0x155  # low byte 'U'
    first_bad, nvalid, nab, packed, _, _ = tob.decode_bulk_routed(_torch(buf), L, False, False)
    assert (int(first_bad), int(nvalid), int(nab)) == (5, 7, 5)
    assert bytes(packed[:3].numpy()) == b"ABC"


def test_classify_chars_matches_jax():
    c = np.arange(256, dtype=np.int32)
    for url, both in MODES:
        got = tob.classify_chars(torch.from_numpy(c), url, both).numpy()
        assert np.array_equal(got, np.asarray(job.classify_chars(jnp.asarray(c), url, both)))


@pytest.mark.parametrize("n", [0, 3, 1533, 1536, 3 * 1536, 3072 + 1536 * 5])
@pytest.mark.parametrize("url", [False, True])
def test_encode_bulk_matches_jax(n, url):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    got = tob.encode_bulk(torch.from_numpy(data), url)
    want = np.asarray(_jencode(jnp.asarray(data), url=url))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    enc = pyb64.urlsafe_b64encode if url else pyb64.b64encode
    assert got.numpy().tobytes() == enc(data.tobytes())


def test_encode_small_matches_jax():
    data = np.random.default_rng(1).integers(0, 256, 999).astype(np.uint8)
    for url in (False, True):
        got = tob.encode_small(torch.from_numpy(data), url).numpy()
        assert np.array_equal(got, np.asarray(job.encode_small(jnp.asarray(data), url)))


STRIP = [b"", b"=", b"==", b"===", b"QQ==", b"QQ== \n", b"QUI=\t", b" \r\n",
         b"QUJD", b"QU=J=", b"AA" + b" " * 300 + b"=" + b"\n" * 200 + b"=" + b" " * 5000]


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_b64_strip_matches_jax(garbage, wide):
    for options in (0, 1, 8):
        tab = gb.value_table(options)
        for s in STRIP:
            src = np.frombuffer(s, np.uint8)
            src = src.astype(np.uint16) if wide else src
            assert bh.b64_strip(src, tab, garbage) == jimpl.b64_strip(src, tab, garbage), s


def test_b64_tail_epilogue_matches_jax():
    tails = {0: [], 1: [17], 2: [19, 48], 3: [19, 22, 5]}
    for outlen, idx, pad, garbage, chunk in itertools.product(
            (0, 3, 6), (0, 1, 2, 3), (0, 1, 2), (False, True),
            (gb.LOOSE, gb.STRICT, gb.STOP_BEFORE_PARTIAL)):
        for tail in (tails[idx], [63] * idx):
            args = (outlen, idx, tail, 40, 44, pad, 44 - pad, garbage, chunk)
            got, want = bh.b64_tail_epilogue(*args), jimpl.b64_tail_epilogue(*args)
            assert got[0] == want[0] and np.array_equal(got[1], want[1]), args


def test_b64_finish_matches_jax():
    packed = np.arange(30, dtype=np.uint8)
    tail_vals = np.array([19, 22, 5, 0], np.uint8)
    for chunk, garbage in itertools.product(
            (gb.LOOSE, gb.STRICT, gb.STOP_BEFORE_PARTIAL), (False, True)):
        for srclen, pad, first_bad, nvalid, nab in (
                (0, 0, 0, 0, 0), (0, 1, 0, 0, 0), (0, 2, 0, 0, 0),
                (40, 0, 2**31 - 1, 40, 39), (40, 1, 2**31 - 1, 39, 38),
                (40, 2, 2**31 - 1, 38, 37), (40, 0, 13, 38, 12),
                (40, 0, 44, 37, 36), (40, 2, 2**31 - 1, 37, 36)):
            args = (srclen, pad, srclen + 1 - pad, garbage, chunk, first_bad,
                    nvalid, nab, packed, tail_vals, 36)
            got, want = bh.b64_finish(*args), jimpl.b64_finish(*args)
            assert got[0] == want[0] and np.array_equal(got[1], want[1]), args
