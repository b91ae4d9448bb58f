"""simdutf_tpu_torch.ops.utf16 against simdutf_tpu.ops.utf16 on CPU.

Same padded unit buffer (storage order, the JAX package's bucket), same
length and byte order into both packages: the census routing facts, the
full 3N-byte output of ``to_utf8`` (zeros past out_len included) with its
error code, position and out_len, and ``to_utf8_valid`` on valid input
must be equal, and so must the full output and total of ``to_utf8_valid``
on every input, invalid ones included. The fixed-rate branches (ascii,
u2r, astral) and the general engine (compose8, in its validating and its
valid-only mode) are each reached. Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu_torch import impl
from simdutf_tpu_torch.ops import utf16 as to16

_jto = jax.jit(jo16.to_utf8, static_argnums=2)
_jvalid = jax.jit(jo16.to_utf8_valid, static_argnums=2)
_jcensus = jax.jit(jo16.census)


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


def _with(units, pos, value) -> np.ndarray:
    out = np.array(units, np.uint16)
    out[pos] = value
    return out


CASES = {
    "empty": np.zeros(0, np.uint16),
    "ascii": _units("ascii only. " * 200),
    "u2": _units("éЖ" * 600),
    "u3": _units("東京" * 600),
    "astral": _units("\U0001f642\U0010ffff" * 400),
    "astral_odd_length": _units("\U0001f642" * 400 + "a"),
    "mixed": _units("ab é 東 \U0001f642 " * 500),
    "u2_then_lone_low": _with(_units("é" * 900), 700, 0xDC00),
    "astral_lone_high_at_end": np.concatenate([_units("\U0001f642" * 300), [0xD800]]).astype(np.uint16),
    "mixed_lone_high": _with(_units("ab é 東 \U0001f642 " * 500), 3000, 0xD811),
    # a high pairs with whatever follows it (0 past the length), a lone low
    # writes nothing
    "lone_high_only": np.array([0xD83D], np.uint16),
    "lone_low_between_ascii": np.array([0x61, 0xDC00, 0x62], np.uint16),
    "lone_high_between_ascii": np.array([0x61, 0xD800, 0x62], np.uint16),
    # 4 bytes per unit: more than the 3N-byte buffer holds
    "lone_highs_run": np.full(4088, 0xDBFF, np.uint16),
}


def _staged(units: np.ndarray, be: bool):
    buf, L = impl._pad(units.byteswap() if be else units)
    return buf.copy(), int(L)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_to_utf8_matches_jax(name, be):
    buf, L = _staged(CASES[name], be)
    w = torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
    want = [np.asarray(v) for v in _jto(jnp.asarray(buf), L, be)]
    got = to16.to_utf8(w, L, be)
    assert np.array_equal(got[2].numpy(), want[2])
    assert [int(got[i]) for i in (0, 1, 3)] == [int(want[i]) for i in (0, 1, 3)]
    # the census facts that picked the route
    jw16 = jnp.asarray(buf.byteswap() if be else buf)
    assert list(to16.census(w, L, be)) == [bool(v) for v in _jcensus(jw16, L)]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("be", [False, True])
def test_to_utf8_valid_matches_jax(name, be):
    buf, L = _staged(CASES[name], be)
    w = torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
    out, total = _jvalid(jnp.asarray(buf), L, be)
    got, got_total = to16.to_utf8_valid(w, L, be)
    assert int(got_total) == int(total)
    assert np.array_equal(got.numpy(), np.asarray(out))
