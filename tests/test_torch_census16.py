"""simdutf_tpu_torch.kernels.census.census16_bits against the Pallas UTF-16
census kernel.

The JAX side calls ``simdutf_tpu.kernels.census.census16_bits`` directly,
in Pallas interpret mode on CPU (on CPU its routing never reaches it:
``census16_supported`` is False off the TPU). The port's wrapper runs its
plain version for a CPU tensor. Both get the identical buffer (units in
storage order), length and byte order; the bits must be equal (integer
result, exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import census as jcen
from simdutf_tpu_torch.kernels import census as tcen

BLOCK = jcen.BLOCK_U16  # the Pallas kernel needs a multiple of 8192 units
_jbits = jax.jit(jcen.census16_bits, static_argnames=("be",))


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


def _buf(units: np.ndarray, be: bool, n: int = BLOCK,
         garbage: bool = False) -> np.ndarray:
    buf = np.zeros(n, np.uint16)
    if garbage:  # units past the length must not change the census
        buf[:] = np.random.default_rng(len(units)).integers(0, 1 << 16, n)
    buf[: len(units)] = units
    return buf.byteswap() if be else buf


def _bits(buf: np.ndarray, length: int, be: bool):
    want = int(_jbits(jnp.asarray(buf), jnp.int32(length), be=be))
    w = torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
    return int(tcen.census16_bits(w, length, be)), want


CASES = {
    "empty": _units(""),
    "ascii": _units("hello census16 " * 100),
    "nul": np.zeros(300, np.uint16),
    "u2": _units("é" * 700),
    "u2_edges": np.array([0x80, 0x7FF] * 300, np.uint16),
    "u2_with_ascii": _units("é" * 300 + "a"),
    "u3": _units("東" * 900),
    "u3_edges": np.array([0x800, 0xD7FF, 0xE000, 0xFFFF] * 200, np.uint16),
    "u3_lone_surrogate": _units("東" * 10).tolist() + [0xD800],
    "astral": _units("\U0001f642" * 600),
    "astral_swapped_pair": np.array([0xDC00, 0xD800] * 100, np.uint16),
    "astral_odd_offset": _units("a" + "\U0001f642" * 100),
    "mixed": _units("ab é 東 \U0001f642 " * 800),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_census16_bits_match_pallas(name, be):
    units = np.asarray(CASES[name], np.uint16)
    got, want = _bits(_buf(units, be), len(units), be)
    assert got == want, (name, got, want)


@pytest.mark.parametrize("name", ["u2", "u3", "astral", "mixed"])
@pytest.mark.parametrize("be", [False, True])
def test_census16_ignores_units_past_length(name, be):
    units = CASES[name]
    got, want = _bits(_buf(units, be, garbage=True), len(units), be)
    assert got == want


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_census16_ragged_lengths(cut):
    """A length that splits an astral pair: the bits are positional only
    (the caller ANDs the length's parity), so the pattern still holds."""
    units = _units("\U0001f642" * 50)
    got, want = _bits(_buf(units, False), len(units) - cut, False)
    assert got == want
    assert got & tcen.BIT16_VASTRAL == 0


def test_census16_across_blocks():
    """A uniform-3 run crossing the 8192-unit block edge, in a 2-block
    buffer."""
    units = _units("東" * (BLOCK + 300))
    got, want = _bits(_buf(units, True, 2 * BLOCK), len(units), True)
    assert got == want
    assert got & tcen.BIT16_V3 == 0


def test_census16_bit_values():
    assert (tcen.BIT16_NONASCII, tcen.BIT16_V2, tcen.BIT16_V3,
            tcen.BIT16_VASTRAL) == (jcen.BIT16_NONASCII, jcen.BIT16_V2,
                                    jcen.BIT16_V3, jcen.BIT16_VASTRAL)


def test_census16_rejects_non_uint16():
    with pytest.raises(TypeError):
        tcen.census16_bits(torch.zeros(16, dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        tcen.census16_bits(torch.zeros(16, dtype=torch.int16).view(torch.uint16), 17)
