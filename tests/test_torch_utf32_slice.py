"""The port's UTF-8 <-> UTF-32 slice through its own api, on CPU.

With ``simdutf_tpu_torch.api.use_device("cpu")``, the eight UTF-32 entry
points (validation with errors, the UTF-8 and UTF-16 lengths, both
validating transcodes and both valid-only ones) and their bytes-out and
``_into`` forms must answer exactly as the JAX ``xla`` tier and CPython's
codecs (``utf-32-le``) do. The valid-only converters are compared on
valid input only. The api's previous implementation is restored
afterwards.
"""

import numpy as np
import pytest

from simdutf_tpu.ops.impl import XLAImplementation
from simdutf_tpu_torch import api


@pytest.fixture
def port():
    before = api._active
    impl = api.use_device("cpu")
    try:
        yield impl
    finally:
        api._active = before


@pytest.fixture(scope="module")
def xla():
    return XLAImplementation()


_ALPHABET = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff"]


def _text(seed: int, n: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET), n))


def _w(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def _with(words, pos, value) -> np.ndarray:
    out = np.array(words, np.uint32)
    out[pos] = value
    return out


VALID = {
    "empty": "",
    "ascii": "The quick brown fox. " * 60,
    "u2": "é" * 500,
    "u3": "東" * 500,
    "astral": "\U0001f642" * 300,
    "mixed": _text(7, 3000),
}
WORDS = {name: _w(t) for name, t in VALID.items()}
WORDS.update({
    "err_surrogate_mid": _with(_w(_text(8, 700)), 400, 0xD83D),
    "err_too_large_at_0": _with(_w(_text(9, 300)), 0, 0x110000),
    "err_top_bit_at_end": _with(_w(_text(10, 300)), 299, 0x80000000),
    "err_all_ones_astral": _with(_w("\U0001f642" * 300), 150, 0xFFFFFFFF),
})
BYTES = {name: t.encode() for name, t in VALID.items()}
BYTES.update({
    "err_header": _text(11, 500).encode() + b"\xff" + _text(12, 100).encode(),
    "err_orphan": b"\x80" + _text(13, 50).encode(),
    "err_truncated": _text(14, 400).encode() + "東".encode()[:2],
    "err_surrogate": _text(15, 200).encode() + b"\xed\xa0\x80",
})


def _pair(res, xres):
    return (int(res.error), res.count) == (int(xres.error), xres.count)


@pytest.mark.parametrize("name", sorted(WORDS))
def test_utf32_to_utf8_matches_xla_and_codecs(port, xla, name):
    w = WORDS[name]
    res, out = api.convert_utf32_to_utf8_with_errors(w.tobytes())
    xres, xout = xla.convert_utf32_to_utf8_with_errors(w)
    assert _pair(res, xres) and out == xout.tobytes()
    if name.startswith("err"):
        assert not res.is_ok
        assert out == w[: res.count].tobytes().decode("utf-32-le").encode()
        assert api.convert_utf32_to_utf8(w.tobytes()) == b""
        assert api.convert_utf32_to_utf8_into(w, np.zeros(8, np.uint8)) == 0
    else:
        assert res.is_ok and out == VALID[name].encode() and res.count == len(out)
        assert api.convert_valid_utf32_to_utf8(w.tobytes()) == out
        assert api.convert_utf32_to_utf8(w) == out
        dst = np.zeros(len(out) + 3, np.uint8)
        assert api.convert_utf32_to_utf8_into(w, dst) == len(out)
        assert dst[: len(out)].tobytes() == out


@pytest.mark.parametrize("name", sorted(WORDS))
def test_utf32_validate_and_lengths_match_xla(port, xla, name):
    w = WORDS[name]
    assert _pair(api.validate_utf32_with_errors(w.tobytes()), xla.validate_utf32_with_errors(w))
    assert api.validate_utf32(w) == xla.validate_utf32(w) == (not name.startswith("err"))
    assert api.utf8_length_from_utf32(w) == xla.utf8_length_from_utf32(w)
    assert api.utf16_length_from_utf32(w) == xla.utf16_length_from_utf32(w)
    if name in VALID:
        assert api.utf8_length_from_utf32(w) == len(VALID[name].encode())
        assert api.utf16_length_from_utf32(w) == len(VALID[name].encode("utf-16-le")) // 2


@pytest.mark.parametrize("name", sorted(BYTES))
def test_utf8_to_utf32_matches_xla_and_codecs(port, xla, name):
    data = BYTES[name]
    res, out = api.convert_utf8_to_utf32_with_errors(data)
    xres, xout = xla.convert_utf8_to_utf32_with_errors(np.frombuffer(data, np.uint8))
    assert _pair(res, xres) and out == xout.tobytes()
    if name.startswith("err"):
        assert not res.is_ok
        assert out == data[: res.count].decode().encode("utf-32-le")
        assert api.convert_utf8_to_utf32(data) == b""
    else:
        assert res.is_ok and out == data.decode().encode("utf-32-le")
        assert api.convert_valid_utf8_to_utf32(data) == out
        assert api.utf32_length_from_utf8(data) == len(out) // 4
        dst = np.zeros(len(out) // 4 + 1, np.uint32)
        assert api.convert_utf8_to_utf32_into(data, dst) == len(out) // 4
        assert dst[: len(out) // 4].tobytes() == out


def test_utf32_input_must_be_whole_words(port):
    with pytest.raises(ValueError):
        api.validate_utf32(b"abc")
