"""simdutf_tpu_torch.kernels.utf16_kernels against the Pallas UTF-16
kernels and the JAX ops.

``utf16_first_bad`` and ``utf16_reduce`` are held against
``simdutf_tpu.kernels.utf16_kernels`` (interpret mode on CPU) on the
Pallas layout, ``_pad2d16``: zero tiles fore and aft, zeros past the
length. With garbage past the length, where the Pallas first-bad kernel
(which takes no length) cannot follow, they are held against
``simdutf_tpu.ops.utf16`` ``validate_with_errors`` / ``count_code_points``
/ ``utf8_length``. Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import utf16_kernels as jk16
from simdutf_tpu.kernels.impl import _pad2d16
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu_torch.kernels import utf16_kernels as tk16
from simdutf_tpu_torch.ops.common import BIG

_jvalidate = jax.jit(jo16.validate_with_errors, static_argnums=2)
_jcount = jax.jit(jo16.count_code_points, static_argnums=2)
_jutf8len = jax.jit(jo16.utf8_length, static_argnums=2)


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


def _tensor(buf: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(buf.view(np.int16)).view(torch.uint16)


def _mixed(n: int, seed: int) -> np.ndarray:
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642"]
    rng = np.random.default_rng(seed)
    return _units("".join(alphabet[i] for i in rng.integers(0, 6, n)))[:n].copy()


def _with(units, pos, value) -> np.ndarray:
    out = np.array(units, np.uint16)
    out[pos] = value
    return out


_M = _mixed(5000, 1)
CASES = {
    "empty": np.zeros(0, np.uint16),
    "ascii": _units("plain ascii " * 50),
    "mixed": _M,
    "pairs": _units("\U00010000\U0010ffff\U0001f642" * 300),
    "lone_high_at_0": _with(_M, 0, 0xD800),
    "lone_low_at_0": _with(_M, 0, 0xDC00),
    "lone_high_at_end": np.concatenate([_units("abc"), [0xD83D]]).astype(np.uint16),
    "lone_low_mid": _with(_units("x" * 3000), 2048, 0xDFFF),
    "lone_high_mid": _with(_units("x" * 3000), 2047, 0xDBFF),
    "high_high_low": np.array([0x41, 0xD800, 0xD800, 0xDC00, 0x42], np.uint16),
    "lone_high_then_ascii": np.array([0x61, 0xD83D, 0x61, 0x62], np.uint16),
    "lone_low_then_cjk": np.array([0x61, 0xDC00, 0x4E00], np.uint16),
    "pair_at_tile_edge": _units("a" * 2047 + "\U0001f642" + "b" * 10),
}


def _pallas(units: np.ndarray, be: bool):
    x2d, n = _pad2d16(units.byteswap() if be else units)
    x2d = jnp.asarray(x2d)
    return (int(jk16.utf16_first_bad(x2d, be)),
            int(jk16.utf16_reduce(x2d, n, be, "count")),
            int(jk16.utf16_reduce(x2d, n, be, "utf8len")))


def _port(buf: np.ndarray, length: int, be: bool):
    w = _tensor(buf)
    return (int(tk16.utf16_first_bad(w, length, be)),
            int(tk16.utf16_reduce(w, length, be, "count")),
            int(tk16.utf16_reduce(w, length, be, "utf8len")))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_first_bad_and_reduce_match_pallas(name, be):
    units = CASES[name]
    buf = np.zeros(len(units) + 9, np.uint16)  # zeros past the length
    buf[: len(units)] = units.byteswap() if be else units
    assert _port(buf, len(units), be) == _pallas(units, be)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_first_bad_and_reduce_match_ops_with_garbage(name, be):
    units = CASES[name]
    n = 1 << (len(units) + 8).bit_length()
    buf = np.random.default_rng(n).integers(0, 1 << 16, n).astype(np.uint16)
    buf[: len(units)] = units.byteswap() if be else units
    L = len(units)
    code, pos = (int(v) for v in _jvalidate(jnp.asarray(buf), L, be))
    pos_port, count, utf8len = _port(buf, L, be)
    assert (pos_port if pos_port != BIG else L) == pos
    assert (pos_port != BIG) == (code != 0)
    assert count == int(_jcount(jnp.asarray(buf), L, be))
    assert utf8len == int(_jutf8len(jnp.asarray(buf), L, be))


@pytest.mark.parametrize("be", [False, True])
def test_high_at_length_minus_one_does_not_pair_past_length(be):
    """A high surrogate at length-1 whose low is stored at length: lone,
    though the Pallas kernel (no length, zero padding) never sees this."""
    units = _units("ab\U0001f642")  # a b high low
    buf = units.byteswap() if be else units.copy()
    assert _port(buf, 3, be)[0] == 2
    assert _port(buf, 4, be)[0] == BIG
    code, pos = (int(v) for v in _jvalidate(jnp.asarray(buf), 3, be))
    assert (code, pos) == (6, 2)


def test_reduce_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tk16.utf16_reduce(_tensor(np.zeros(4, np.uint16)), 2, False, "bytes")
