"""simdutf_tpu_torch.kernels.validate against the Pallas validation and
count kernels (simdutf_tpu.kernels.validate, interpret mode on CPU).

The JAX kernels take the (R + 64, 512) row layout with a zero halo; the
port takes the flat buffer. Both get the same bytes and length; (pos,
code) and counts must be equal (integer results, exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simdutf_tpu.kernels import validate as jv
from simdutf_tpu_torch.kernels import validate as tv

TILE = jv.BR * jv.W  # 32 KiB: the Pallas kernels' tile


def _buf(data: bytes, n: int = TILE, garbage: bool = False) -> np.ndarray:
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    if garbage:
        rng = np.random.default_rng(len(data))
        buf[len(data):] = rng.integers(0, 256, n - len(data))
    return buf


def _x2d(buf: np.ndarray):
    return jnp.asarray(np.concatenate(
        [buf.reshape(-1, jv.W), np.zeros((jv.BR, jv.W), np.uint8)]))


def _first(buf: np.ndarray, length: int):
    pos, code = jv.utf8_first_event_len(_x2d(buf), length)
    tpos, tcode = tv.utf8_first_event_len(torch.from_numpy(buf), length)
    return (int(tpos), int(tcode)), (int(pos), int(code))


MIXED = ("ab é 東 \U0001f642 " * 300).encode()

# (prefix, bad bytes, suffix): the error lattice of ops/utf8.classify
LATTICE = {
    "valid": (MIXED, b"", b""),
    "header_bits": (b"ab", b"\xff", b"cd"),
    "bad_lead_f8": (MIXED[:100], b"\xf8\x80\x80\x80", b"z"),
    "too_short_2": (b"ab", b"\xc3", b"x"),
    "too_short_3": (b"ab", b"\xe6\x9d", b"x"),
    "too_short_4": (b"ab", b"\xf0\x9f\x99", b"x"),
    "too_long_orphan": (b"ab", b"\x80", b"cd"),
    "too_long_after_2": ("é".encode(), b"\xa9", b""),
    "too_long_after_4": ("\U0001f642".encode(), b"\x80", b"x"),
    "start_cont": (b"", b"\xbf", b"abc"),
    "overlong_2": (b"a", b"\xc0\xaf", b""),
    "overlong_3": (b"a", b"\xe0\x80\xaf", b""),
    "overlong_4": (b"a", b"\xf0\x8f\xbf\xbf", b""),
    "surrogate": (b"a", b"\xed\xa0\x80", b""),
    "too_large": (b"a", b"\xf4\x90\x80\x80", b""),
    "f5_lead": (b"a", b"\xf5\x80\x80\x80", b""),
    "two_errors": (b"a\xc3", b"\xff", b"\x80"),
}


@pytest.mark.parametrize("name", sorted(LATTICE))
def test_first_event_lattice(name):
    pre, bad, post = LATTICE[name]
    data = pre + bad + post
    got, want = _first(_buf(data), len(data))
    assert got == want, (name, got, want)


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_first_event_truncated_at_length(cut):
    """Bytes at/after the length read as zero even when the buffer holds
    the rest of the sequence: TOO_SHORT at the lead."""
    data = MIXED[:1000] + "\U0001f642".encode()
    length = len(data) - cut
    got, want = _first(_buf(data), length)
    assert got == want and got == (1000, 2)


@pytest.mark.parametrize("where", [0, TILE - 1, TILE, TILE + 1])
def test_first_event_tile_edges(where):
    """Errors on either side of the Pallas tile edge, in a 2-tile buffer;
    bytes past the length are garbage."""
    data = bytearray(b"a" * (TILE + 200))
    data[where] = 0x80
    got, want = _first(_buf(bytes(data), 2 * TILE, garbage=True), len(data))
    assert got == want and got == (where, 3)


def test_first_event_straddle_valid():
    """A 4-byte sequence straddling the tile edge is valid."""
    data = b"a" * (TILE - 1) + "\U0001f642".encode() + b"tail"
    got, want = _first(_buf(data, 2 * TILE), len(data))
    assert got == want and got[0] == jv.BIG


@pytest.mark.parametrize("name", ["valid", "too_short_3", "start_cont"])
def test_first_event_no_length(name):
    pre, bad, post = LATTICE[name]
    buf = _buf(pre + bad + post)
    pos, code = jv.utf8_first_event(_x2d(buf))
    tpos, tcode = tv.utf8_first_event(torch.from_numpy(buf))
    assert (int(tpos), int(tcode)) == (int(pos), int(code))


COUNTS = {
    "mixed": MIXED,
    "latin1_high": bytes(range(256)) * 3,
    "invalid": b"\x80\xff\xc3" * 100 + MIXED[:500],
}


@pytest.mark.parametrize("name", sorted(COUNTS))
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("what", ["count", "utf16", "latin1"])
def test_count_modes(name, garbage, what):
    data = COUNTS[name]
    buf = _buf(data, garbage=garbage)
    jfn = {"count": jv.utf8_count, "utf16": jv.utf8_utf16_length,
           "latin1": jv.latin1_utf8_length}[what]
    tfn = {"count": tv.utf8_count, "utf16": tv.utf8_utf16_length,
           "latin1": tv.latin1_utf8_length}[what]
    length = len(data) - 7  # ragged, not a multiple of anything
    want = int(jfn(_x2d(buf), jnp.int32(length)))
    assert int(tfn(torch.from_numpy(buf), length)) == want
