"""The port's routed UTF-16 <-> UTF-32 ops against the JAX package's on CPU.

Same padded buffer (the JAX package's bucket, in units or words), same
length into both: ``ops.utf16.to_utf32`` / ``to_utf32_valid`` (LE and BE
input) and ``ops.utf32.to_utf16`` / ``to_utf16_valid`` (LE and BE output),
their full outputs (past out_len on the error path: the JAX engines'
decoded rest, not zeros) with the error code, position and out_len. The
``_valid`` forms are compared on every input, invalid too: both packages
run the same engine there. Every fixed-rate branch and the compose
kernels' plain versions are reached. Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch import impl
from simdutf_tpu_torch.ops import utf16 as to16
from simdutf_tpu_torch.ops import utf32 as to32

_jto32 = jax.jit(jo16.to_utf32, static_argnums=2)
_jto32_valid = jax.jit(jo16.to_utf32_valid, static_argnums=2)
_jto16 = jax.jit(jo32.to_utf16, static_argnums=2)
_jto16_valid = jax.jit(jo32.to_utf16_valid, static_argnums=2)

_MIXED = "ab é 東 \U0001f642 \x00"
TEXT = {
    "empty": "",
    "ascii": "ascii only. " * 200,
    "bmp": "aé東" * 500,
    "astral": "\U0001f642\U0010ffff" * 400,
    "mixed": _MIXED * 400,
}


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16).copy()


def _words(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def _with(arr, pos, value) -> np.ndarray:
    out = arr.copy()
    out[pos] = value
    return out


UNITS = {k: _units(t) for k, t in TEXT.items()}
UNITS.update({
    "astral_lone_high_at_end": _units("\U0001f642" * 300)[:-1],
    "astral_odd_length": np.concatenate([_units("\U0001f642" * 200), _units("a")]),
    "bmp_lone_low": _with(_units("é" * 900), 700, 0xDC00),
    "mixed_lone_high": _with(_units(_MIXED * 300), 1001, 0xD800),
    "mixed_low_at_0": _with(_units(_MIXED * 300), 0, 0xDFFF),
})
WORDS = {k: _words(t) for k, t in TEXT.items()}
WORDS.update({
    "bmp_surrogate": _with(_words("é" * 900), 700, 0xDC00),
    "astral_too_large_at_end": _with(_words("\U0001f642" * 300), 299, 0x110000),
    "mixed_top_bit": _with(_words(_MIXED * 400), 1500, 0x80000000),
    "mixed_all_ones_at_0": _with(_words(_MIXED * 400), 0, 0xFFFFFFFF),
})


def _staged(arr: np.ndarray):
    buf, L = impl._pad(arr)
    return buf.copy(), int(L)


def _ints(*vals):
    return [int(v) for v in vals]


@pytest.mark.parametrize("name", sorted(UNITS))
@pytest.mark.parametrize("be", [False, True])
def test_utf16_to_utf32_matches_jax(name, be):
    buf, L = _staged(UNITS[name].byteswap() if be else UNITS[name])
    w, jw = torch.from_numpy(buf.view(np.int16)).view(torch.uint16), jnp.asarray(buf)
    code, pos, out, out_len = to16.to_utf32(w, L, be)
    want = _jto32(jw, L, be)
    assert out.dtype == torch.int32 and out.shape == (len(buf),)
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    out_v, total = to16.to_utf32_valid(w, L, be)
    want_v = _jto32_valid(jw, L, be)
    assert np.array_equal(out_v.numpy().view(np.uint32), np.asarray(want_v[0]))
    assert int(total) == int(want_v[1])


@pytest.mark.parametrize("name", sorted(WORDS))
@pytest.mark.parametrize("be", [False, True])
def test_utf32_to_utf16_matches_jax(name, be):
    buf, L = _staged(WORDS[name])
    w, jw = torch.from_numpy(buf.view(np.int32)), jnp.asarray(buf)
    code, pos, out, out_len = to32.to_utf16(w, L, be)
    want = _jto16(jw, L, be)
    assert out.dtype == torch.uint16 and out.shape == (2 * len(buf),)
    assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    out_v, total = to32.to_utf16_valid(w, L, be)
    want_v = _jto16_valid(jw, L, be)
    assert np.array_equal(out_v.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(want_v[0]))
    assert int(total) == int(want_v[1])


def test_every_route_is_reached():
    """No surrogate: the widen; all pairs: the pair map; else the compose
    kernel. The same three for UTF-32 -> UTF-16 from the UTF-32 census."""
    got = []
    for name in ("ascii", "bmp", "astral", "mixed", "astral_odd_length", "empty"):
        buf, L = _staged(UNITS[name])
        got.append(to16.census32(torch.from_numpy(buf.view(np.int16)).view(torch.uint16),
                                 L, False))
    assert got == [(True, False), (True, False), (False, True), (False, False),
                   (False, False), (True, False)]
    facts = []
    for name in ("bmp", "astral", "mixed", "bmp_surrogate"):
        buf, L = _staged(WORDS[name])
        facts.append(to32.census(torch.from_numpy(buf.view(np.int32)), L)[3:])
    assert facts == [(False, True), (True, False), (False, False), (False, False)]


def test_census32_reads_the_high_byte_of_each_unit():
    """A unit whose low byte looks like a surrogate's high byte is no
    surrogate, in either byte order."""
    units = np.array([0x00D8, 0x41DC, 0x61], np.uint16)
    for be in (False, True):
        buf, L = _staged(units.byteswap() if be else units)
        w = torch.from_numpy(buf.view(np.int16)).view(torch.uint16)
        assert to16.census32(w, L, be)[0]
