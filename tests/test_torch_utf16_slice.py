"""The port's UTF-16 -> UTF-8 slice through the public simdutf_tpu api, on
CPU.

With ``TorchImplementation("cpu")`` installed as the active
implementation, the public ``su.*`` UTF-16 entry points (validation with
errors, code point and UTF-8 counts, the validating and the valid-only
UTF-16LE/BE -> UTF-8 converters) must answer exactly as the JAX ``xla``
tier and CPython's codecs do. The valid-only converters are compared on
valid input only. The previous active implementation is restored
afterwards.
"""

import numpy as np
import pytest

import simdutf_tpu as su
from simdutf_tpu import registry
from simdutf_tpu.ops.impl import XLAImplementation

import simdutf_tpu_torch

_ALPHABET = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff"]


def _text(seed: int, n: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET), n))


def _u(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


def _with(units, pos, value) -> np.ndarray:
    out = np.array(units, np.uint16)
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
DATA = {name: _u(t) for name, t in VALID.items()}
DATA.update({
    "err_lone_high_mid": _with(_u(_text(8, 700)), 400, 0xD83D),
    "err_lone_low_at_0": _with(_u(_text(9, 300)), 0, 0xDE00),
    "err_truncated_pair": _u(_text(10, 300) + "\U0001f642")[:-1],
    "err_astral_lone": _with(_u("\U0001f642" * 300), 301, 0x41),
})


@pytest.fixture
def torch_active():
    before = registry._active
    impl = su.set_active_implementation(simdutf_tpu_torch.TorchImplementation("cpu"))
    try:
        yield impl
    finally:
        with registry._lock:
            registry._active = before


@pytest.fixture(scope="module")
def xla():
    return XLAImplementation()


def _stored(name: str, be: bool) -> np.ndarray:
    units = DATA[name]
    return units.byteswap() if be else units


@pytest.mark.parametrize("name", sorted(DATA))
@pytest.mark.parametrize("be", [False, True])
def test_utf16_to_utf8_matches_xla_and_codecs(torch_active, xla, name, be):
    w = _stored(name, be)
    api = su.convert_utf16be_to_utf8_with_errors if be else su.convert_utf16le_to_utf8_with_errors
    res, out = api(w.tobytes())
    xfn = xla.convert_utf16be_to_utf8_with_errors if be else xla.convert_utf16le_to_utf8_with_errors
    xres, xout = xfn(w)
    assert (res.error, res.count) == (xres.error, xres.count)
    assert out == xout.tobytes()
    if name.startswith("err"):
        prefix = DATA[name][: res.count].tobytes().decode("utf-16-le")
        assert not res.is_ok and out == prefix.encode()
    else:
        assert res.is_ok and out == VALID[name].encode()
        valid = su.convert_valid_utf16be_to_utf8 if be else su.convert_valid_utf16le_to_utf8
        assert valid(w.tobytes()) == out


@pytest.mark.parametrize("name", sorted(DATA))
@pytest.mark.parametrize("be", [False, True])
def test_utf16_validate_and_counts_match_xla(torch_active, xla, name, be):
    w = _stored(name, be)
    e = "be" if be else "le"
    for method in ("validate_utf16%s_with_errors", "validate_utf16%s",
                   "count_utf16%s", "utf8_length_from_utf16%s",
                   "utf32_length_from_utf16%s"):
        m = method % e
        assert getattr(su, m)(w.tobytes()) == getattr(xla, m)(w), m
    if not name.startswith("err"):
        assert su.count_utf16le(DATA[name].tobytes()) == len(VALID[name])
        assert su.utf8_length_from_utf16le(DATA[name].tobytes()) == len(VALID[name].encode())
