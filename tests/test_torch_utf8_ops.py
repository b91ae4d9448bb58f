"""simdutf_tpu_torch.ops.utf8 against simdutf_tpu.ops.utf8 on CPU.

Both packages get the identical padded buffer and length (the port's
``impl._pad``), the JAX side through the XLA tier's jitted entry points.
Every output is compared in full and exactly (integer results): codes,
positions, lengths, census facts, and whole output buffers including the
zeros past out_len.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simdutf_tpu.golden import utf8 as g8
from simdutf_tpu.ops import impl as jimpl
from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu_torch import impl as timpl
from simdutf_tpu_torch.ops import utf8 as to8
from simdutf_tpu_torch.ops.common import scatter_writes

_ALPHABET = ["a", " ", "é", "ß", "Ж", "東", "京", "\U0001f642", "𝄞"]
_BAD = [b"\x80", b"\xff", b"\xf8", b"\xc0\xaf", b"\xe0\x80\x80",
        b"\xed\xa0\x80", b"\xe6\x9d", b"\xf4\x90\x80\x80", b"\xf0\x9f",
        b"\xc3"]


def _text(seed: int, size: int, n_bad: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    parts = [_ALPHABET[i].encode() for i in rng.integers(0, len(_ALPHABET), size)]
    d = bytearray(b"".join(parts)[:size])
    d = d[: g8.trim_partial(np.frombuffer(bytes(d), np.uint8))]
    for _ in range(n_bad):
        p = int(rng.integers(0, len(d) + 1))
        d[p:p] = _BAD[int(rng.integers(len(_BAD)))]
    return bytes(d)


INPUTS = {
    "empty": b"",
    "ascii": b"plain ascii text " * 40,
    "u2": "é".encode() * 300,
    "u3": "東".encode() * 300,
    "u4": "\U0001f642".encode() * 200,
    "u3_ragged": "東".encode() * 300 + b"x",
    "mixed": _text(1, 2500),
    "mixed_long": _text(2, 7000),
    "invalid_one": _text(3, 2000, 1),
    "invalid_many": _text(4, 3000, 3),
    "start_cont": b"\x80abc",
    "cut_at_length": "ab東".encode()[:-1],
    "lead4_last": b"abc\xf0",
    "overlong": b"ab\xc0\xafcd",
    "surrogate": b"ab\xed\xa0\x80",
    "too_large": b"ab\xf4\x90\x80\x80",
    # convert_valid on invalid input: the unit of every in-range lead, past
    # the first error too
    "valid_only_truncated_lead": b"\xe6",
    "valid_only_ff_mid": b"a\xffb",
    "valid_only_cut4_at_end": b"ab\xf0\x90",
    "valid_only_orphan_cont": b"\x80ab\xbf",
}


def _both(data: bytes):
    buf, n = timpl._pad(np.frombuffer(data, np.uint8))
    x, length = timpl.to_device(buf, n, "cpu")
    return jnp.asarray(buf), jnp.int32(n), x, length


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("be", [False, True])
def test_to_utf16_matches_jax(name, be):
    jb, jn, x, length = _both(INPUTS[name])
    jfn = jimpl._j_u8_to_u16be if be else jimpl._j_u8_to_u16le
    code, pos, out, out_len = jfn(jb, jn)
    tcode, tpos, tout, tout_len = to8.to_utf16(x, length, be)
    assert (int(tcode), int(tpos), int(tout_len)) == (int(code), int(pos), int(out_len))
    assert np.array_equal(_u16(tout), np.asarray(out))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_validate_and_lengths_match_jax(name):
    jb, jn, x, length = _both(INPUTS[name])
    code, pos = jimpl._j_validate_utf8(jb, jn)
    tcode, tpos = to8.validate_with_errors(x, length)
    assert (int(tcode), int(tpos)) == (int(code), int(pos))
    assert int(to8.count_code_points(x, length)) == int(jimpl._j_count_utf8(jb, jn))
    assert int(to8.utf16_length(x, length)) == int(jimpl._j_utf16_len_from_utf8(jb, jn))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_census_and_first_error_match_jax(name):
    jb, jn, x, length = _both(INPUTS[name])
    want = [bool(v) for v in jo8.census_full(jb, jn)]
    assert list(to8.census_full(x, length)) == want
    jcls = jo8.classify(jb, jn)
    tcls = to8.classify(x, length)
    for key in ("lead", "seqlen", "cp", "err", "lead4"):
        assert np.array_equal(tcls[key].numpy(), np.asarray(jcls[key])), key
    jpos, jcode = jo8._first_error_from(jcls, jn)
    tpos, tcode = to8._first_error_from(tcls, length)
    assert (int(tpos), int(tcode)) == (int(jpos), int(jcode))


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("be", [False, True])
def test_to_utf16_valid_matches_jax(name, be):
    """Every input, invalid ones included: the same full buffer and length."""
    jb, jn, x, length = _both(INPUTS[name])
    jfn = jimpl._j_u8_to_u16be_v if be else jimpl._j_u8_to_u16le_v
    out, total = jfn(jb, jn)
    tout, ttotal = to8.to_utf16_valid(x, length, be)
    assert int(ttotal) == int(total)
    assert np.array_equal(_u16(tout), np.asarray(out))


@pytest.mark.parametrize("be", [False, True])
def test_general_engine_matches_jax_scatter(be):
    """The routed transcode on input no census class covers, which takes
    the compose kernel (its plain version here), against the JAX
    package's scatter engine."""
    jb, jn, x, length = _both(_text(5, 5000, 2))
    assert not any(to8.census(x, length))
    code, pos, out, out_len = jo8._to_utf16_general(jb, jn, be)
    tcode, tpos, tout, tout_len = to8.to_utf16(x, length, be)
    assert (int(tcode), int(tpos), int(tout_len)) == (int(code), int(pos), int(out_len))
    assert np.array_equal(_u16(tout), np.asarray(out).astype(np.uint16))


def test_scatter_writes_drops_masked():
    mask = torch.tensor([True, False, True, True])
    off = torch.tensor([0, 1, 1, 2])
    vals = torch.tensor([7, 8, 9, 10], dtype=torch.int32)
    out = scatter_writes(5, [(mask, off, vals)], "cpu")
    assert out.tolist() == [7, 9, 10, 0, 0]


@pytest.mark.parametrize("n", [0, 1, 1015, 1016, 1017, 5000, 65536,
                               64 * 2**20 - 8, 64 * 2**20 - 7, 100 * 2**20])
@pytest.mark.parametrize("multiple", [4, 1536])
def test_bucket_equals_jax(n, multiple):
    assert timpl._bucket(n, multiple) == jimpl._bucket(n, multiple)
