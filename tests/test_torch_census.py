"""simdutf_tpu_torch.kernels.census against the Pallas census kernel.

The JAX side calls ``simdutf_tpu.kernels.census.census_bits`` directly, in
Pallas interpret mode on CPU (on CPU its routing never reaches it:
``census_supported`` is False off the TPU). The port's wrapper runs its
plain version for a CPU tensor. Both get the identical buffer and length;
the bits must be equal (integer result, exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simdutf_tpu.kernels import census as jcen
from simdutf_tpu_torch.kernels import census as tcen

BLOCK = jcen.BLOCK_B  # the Pallas kernel needs a multiple of 32 KiB


def _buf(data: bytes, n: int = BLOCK, garbage: bool = False) -> np.ndarray:
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    if garbage:  # bytes past the length must not change the census
        rng = np.random.default_rng(len(data))
        buf[len(data) + 1:] = rng.integers(0, 256, n - len(data) - 1)
    return buf


def _bits(buf: np.ndarray, length: int):
    want = int(jcen.census_bits(jnp.asarray(buf), jnp.int32(length)))
    got = tcen.census_bits(torch.from_numpy(buf), length)
    return int(got), want


CASES = {
    "empty": b"",
    "ascii": b"hello census " * 100,
    "latin_high": "é".encode() * 700,  # no byte < 0x80: BIT_HASLO clear
    "u2_ragged": "é".encode() * 700 + b"\xc3",
    "u3": "東".encode() * 900,
    "u3_surrogate": "東".encode() * 10 + b"\xed\xa0\x80",
    "u3_overlong": b"\xe0\x80\x80" + "東".encode() * 10,
    "u4": "\U0001f642".encode() * 600,
    "u4_too_large": "\U0001f642".encode() * 6 + b"\xf4\x90\x80\x80",
    "u4_overlong": b"\xf0\x8f\xbf\xbf" + "\U0001f642".encode() * 6,
    "mixed": ("ab é 東 \U0001f642 " * 800).encode(),
    "two_byte_only_c0": b"\xc0\x80" * 100,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_census_bits_match_pallas(name):
    data = CASES[name]
    got, want = _bits(_buf(data), len(data))
    assert got == want, (name, got, want)


@pytest.mark.parametrize("name", ["u3", "mixed", "latin_high"])
def test_census_ignores_bytes_past_length(name):
    data = CASES[name]
    got, want = _bits(_buf(data, garbage=True), len(data))
    assert got == want


@pytest.mark.parametrize("cut", [1, 2, 3, 5])
def test_census_ragged_lengths(cut):
    """Lengths that are not multiples of the class width."""
    data = "\U0001f642".encode() * 50
    got, want = _bits(_buf(data), len(data) - cut)
    assert got == want


def test_census_across_blocks():
    """A uniform-3 run crossing the 32 KiB block edge, in a 2-block buffer
    (the Pallas kernel reads the next block's first bytes for p+1)."""
    data = "東".encode() * ((BLOCK + 300) // 3)
    got, want = _bits(_buf(data, 2 * BLOCK), len(data))
    assert got == want
    assert got & tcen.BIT_V3 == 0


def test_census_bit_values():
    assert (tcen.BIT_NONASCII, tcen.BIT_V2, tcen.BIT_V3, tcen.BIT_V4,
            tcen.BIT_HAS2, tcen.BIT_HAS4, tcen.BIT_HASLO) == (
        jcen.BIT_NONASCII, jcen.BIT_V2, jcen.BIT_V3, jcen.BIT_V4,
        jcen.BIT_HAS2, jcen.BIT_HAS4, jcen.BIT_HASLO)


def test_census_rejects_non_uint8():
    with pytest.raises(TypeError):
        tcen.census_bits(torch.zeros(16, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        tcen.census_bits(torch.zeros(16, dtype=torch.uint8), 17)


@pytest.mark.parametrize("name", ["empty", "ascii", "u2_ragged", "u4", "mixed"])
def test_census_counted_on_cpu(name):
    """``counted=True`` gives the bits and the chunks checked: the plain
    census checks every in-range chunk."""
    data = CASES[name]
    buf = torch.from_numpy(_buf(data, garbage=True))
    both = tcen.census_bits(buf, len(data), counted=True)
    chunks = (len(data) + 15) // 16
    assert both.dtype == torch.int64 and both.dim() == 0
    assert int(both) == int(tcen.census_bits(buf, len(data))) | chunks << 32
    assert tcen.census_chunks(buf, len(data)) == chunks
