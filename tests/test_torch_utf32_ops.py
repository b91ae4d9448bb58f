"""simdutf_tpu_torch.ops.utf32 and the UTF-32 half of ops.utf8 against the
JAX package's ops on CPU.

Same padded buffer (the JAX package's bucket: bytes for UTF-8, words for
UTF-32), same length into both: the census facts; validation with errors
and the UTF-8 / UTF-16 lengths of UTF-32; the full 4N-byte output of
``ops.utf32.to_utf8`` and the full N-word output of ``ops.utf8.to_utf32``
with their error code, position and out_len (past out_len on the error
path: the JAX engines' decoded rest, not zeros); and the ``_valid`` forms
on valid input. Every fixed-rate branch and the general engine (composex,
compose32) are reached. Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch import impl
from simdutf_tpu_torch.ops import utf8 as to8
from simdutf_tpu_torch.ops import utf32 as to32

_jto8 = jax.jit(jo32.to_utf8)
_jto8_valid = jax.jit(jo32.to_utf8_valid)
_jvalidate = jax.jit(jo32.validate_with_errors)
_jlen8 = jax.jit(jo32.utf8_length)
_jlen16 = jax.jit(jo32.utf16_length)
_jcensus = jax.jit(lambda w, n: jo32.census(jo32._native(w, n), n))
_jto32 = jax.jit(jo8.to_utf32)
_jto32_valid = jax.jit(jo8.to_utf32_valid)


def _words(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def _with(words, pos, value) -> np.ndarray:
    out = np.array(words, np.uint32)
    out[pos] = value
    return out


_MIXED = "ab é 東 \U0001f642 \x00"
WORDS = {
    "empty": np.zeros(0, np.uint32),
    "ascii": _words("ascii only. " * 200),
    "u2": _words("éЖ" * 600),
    "u3": _words("東京" * 600),
    "astral": _words("\U0001f642\U0010ffff" * 400),
    "bmp_mixed": _words("aé東" * 300),
    "mixed": _words(_MIXED * 400),
    "u2_then_surrogate": _with(_words("é" * 900), 700, 0xDC00),
    "astral_too_large_at_end": _with(_words("\U0001f642" * 300), 299, 0x110000),
    "mixed_top_bit": _with(_words(_MIXED * 400), 1500, 0x80000000),
    "mixed_all_ones_at_0": _with(_words(_MIXED * 400), 0, 0xFFFFFFFF),
}

BYTES = {
    "empty": b"",
    "ascii": b"ascii only. " * 200,
    "u2": "éЖ".encode() * 600,
    "u3": "東京".encode() * 600,
    "u4": "\U0001f642\U0010ffff".encode() * 400,
    "mixed": (_MIXED * 400).encode(),
    "u2_cut": "é".encode() * 600 + b"\xc3",
    "mixed_header": (_MIXED * 100).encode() + b"\xff" + (_MIXED * 100).encode(),
    "mixed_surrogate": (_MIXED * 100).encode() + b"\xed\xa0\x80" + b"xyz",
    "orphan_at_0": b"\x80" + (_MIXED * 50).encode(),
}


def _staged(arr: np.ndarray):
    buf, L = impl._pad(arr)
    return buf.copy(), int(L)


def _wtensor(buf: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(buf.view(np.int32))


def _ints(*vals):
    return [int(v) for v in vals]


@pytest.mark.parametrize("name", sorted(WORDS))
def test_utf32_validate_lengths_and_census_match_jax(name):
    buf, L = _staged(WORDS[name])
    w, jw = _wtensor(buf), jnp.asarray(buf)
    assert _ints(*to32.validate_with_errors(w, L)) == _ints(*_jvalidate(jw, L))
    assert int(to32.utf8_length(w, L)) == int(_jlen8(jw, L))
    assert int(to32.utf16_length(w, L)) == int(_jlen16(jw, L))
    assert list(to32.census(w, L)) == [bool(v) for v in _jcensus(jw, L)]


@pytest.mark.parametrize("name", sorted(WORDS))
def test_utf32_to_utf8_matches_jax(name):
    buf, L = _staged(WORDS[name])
    w, jw = _wtensor(buf), jnp.asarray(buf)
    code, pos, out, out_len = to32.to_utf8(w, L)
    want = _jto8(jw, L)
    assert out.dtype == torch.uint8 and out.shape == (4 * len(buf),)
    assert np.array_equal(out.numpy(), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    if not name.startswith(("u2_then", "astral_too", "mixed_")):
        out_v, total = to32.to_utf8_valid(w, L)
        want_v = _jto8_valid(jw, L)
        assert np.array_equal(out_v.numpy(), np.asarray(want_v[0]))
        assert int(total) == int(want_v[1]) == int(out_len)


@pytest.mark.parametrize("name", sorted(BYTES))
def test_utf8_to_utf32_matches_jax(name):
    buf, L = _staged(np.frombuffer(BYTES[name], np.uint8))
    x, jb = torch.from_numpy(buf), jnp.asarray(buf)
    code, pos, out, out_len = to8.to_utf32(x, L)
    want = _jto32(jb, L)
    assert out.dtype == torch.int32 and out.shape == (len(buf),)
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(want[2]))
    assert _ints(code, pos, out_len) == _ints(want[0], want[1], want[3])
    if int(code) == 0:
        out_v, total = to8.to_utf32_valid(x, L)
        want_v = _jto32_valid(jb, L)
        assert np.array_equal(out_v.numpy().view(np.uint32), np.asarray(want_v[0]))
        assert int(total) == int(want_v[1]) == int(out_len)


def test_every_route_is_reached():
    """Each census class takes its fixed-rate branch, and mixed input the
    compose kernels' plain versions."""
    seen = []
    for name in ("ascii", "u2", "u3", "astral", "mixed"):
        buf, L = _staged(WORDS[name])
        seen.append(to32.census(_wtensor(buf), L)[:4])
    assert seen == [(True, False, False, False), (False, True, False, False),
                    (False, False, True, False), (False, False, False, True),
                    (False, False, False, False)]
    for name, want in (("ascii", 0), ("u2", 1), ("u3", 2), ("u4", 3), ("mixed", None)):
        buf, L = _staged(np.frombuffer(BYTES[name], np.uint8))
        facts = to8.census(torch.from_numpy(buf), L)
        assert (facts.index(True) if any(facts) else None) == want
