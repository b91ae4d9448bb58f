"""simdutf_tpu_torch.kernels.validate's UTF-32 kernels against the Pallas
UTF-32 kernels and the JAX ops.

``utf32_first_bad`` and ``utf32_count`` are held against
``simdutf_tpu.kernels.validate.utf32_first_bad`` and ``utf32_reduce``
(interpret mode on CPU) on the Pallas layout, ``_pad_u32k``: one word per
int32 lane, zeros past the length. With garbage past the length they are
held against ``simdutf_tpu.ops.utf32`` ``validate_with_errors`` /
``utf8_length`` / ``utf16_length``. Words >= 2^31 are negative in both
packages' int32 lanes. Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import validate as jv
from simdutf_tpu.kernels.impl import _pad_u32k
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch.kernels import validate as tv
from simdutf_tpu_torch.ops.common import BIG

_jvalidate = jax.jit(jo32.validate_with_errors)
_jutf8len = jax.jit(jo32.utf8_length)
_jutf16len = jax.jit(jo32.utf16_length)


def _words(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def _with(words, pos, value) -> np.ndarray:
    out = np.array(words, np.uint32)
    out[pos] = value
    return out


def _mixed(n: int, seed: int) -> np.ndarray:
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff", "\x00"]
    rng = np.random.default_rng(seed)
    return _words("".join(alphabet[i] for i in rng.integers(0, len(alphabet), n)))


def _tensor(buf: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(buf.view(np.int32))


_M = _mixed(5000, 1)
CASES = {
    "empty": np.zeros(0, np.uint32),
    "ascii": _words("plain ascii " * 50),
    "mixed": _M,
    "edges": np.array([0, 0x7F, 0x80, 0x7FF, 0x800, 0xD7FF, 0xE000, 0xFFFF,
                       0x10000, 0x10FFFF] * 100, np.uint32),
    "too_large_at_0": _with(_M, 0, 0x110000),
    "surrogate_at_0": _with(_M, 0, 0xD800),
    "dfff_mid": _with(_M, 2047, 0xDFFF),
    "top_bit_mid": _with(_M, 2048, 0x80000000),
    "all_ones_at_end": _with(_M, len(_M) - 1, 0xFFFFFFFF),
    "two_errors": _with(_with(_M, 4000, 0xD900), 3000, 0x7FFFFFFF),
}


def _pallas(words: np.ndarray):
    x32, n = _pad_u32k(words)
    x32 = jnp.asarray(x32.copy())
    return (int(jv.utf32_first_bad(x32, n)),
            int(jv.utf32_reduce(x32, n, "utf8len")),
            int(jv.utf32_reduce(x32, n, "utf16len")))


def _port(buf: np.ndarray, length: int):
    w = _tensor(buf)
    return (int(tv.utf32_first_bad(w, length)),
            int(tv.utf32_count(w, length, "utf8len")),
            int(tv.utf32_count(w, length, "utf16len")))


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_bad_and_counts_match_pallas(name):
    words = CASES[name]
    buf = np.zeros(len(words) + 9, np.uint32)  # zeros past the length
    buf[: len(words)] = words
    assert _port(buf, len(words)) == _pallas(words)


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_bad_and_counts_match_ops_with_garbage(name):
    words = CASES[name]
    n = 1 << (len(words) + 8).bit_length()
    buf = np.random.default_rng(n).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    buf[: len(words)] = words
    L = len(words)
    code, pos = (int(v) for v in _jvalidate(jnp.asarray(buf), L))
    first, utf8len, utf16len = _port(buf, L)
    assert (first if first != BIG else L) == pos
    assert (first != BIG) == (code != 0)
    assert utf8len == int(_jutf8len(jnp.asarray(buf), L))
    assert utf16len == int(_jutf16len(jnp.asarray(buf), L))


@pytest.mark.parametrize("word,first,utf8len,utf16len", [
    (0x10FFFF, BIG, 4, 2), (0x110000, 0, 4, 2), (0xD800, 0, 3, 1),
    (0xDFFF, 0, 3, 1), (0xE000, BIG, 3, 1), (0x80000000, 0, 4, 2),
    (0xFFFFFFFF, 0, 4, 2), (0x7F, BIG, 1, 1), (0x80, BIG, 2, 1)])
def test_single_word_ladder(word, first, utf8len, utf16len):
    """One word, then a word at the length that must not count."""
    buf = np.array([word, 0xFFFFFFFF], np.uint32)
    assert _port(buf, 1) == (first, utf8len, utf16len)
    assert _pallas(buf[:1]) == (first, utf8len, utf16len)


def test_count_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tv.utf32_count(_tensor(np.zeros(4, np.uint32)), 2, "bytes")
