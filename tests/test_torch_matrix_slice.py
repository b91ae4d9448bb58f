"""The port's UTF-16 <-> UTF-32 and Latin-1 entry points against the JAX
package's api and CPython's codecs, on CPU.

``simdutf_tpu_torch.api`` runs on ``use_device("cpu")``; ``simdutf_tpu``'s
api runs on its ``xla`` tier. Every entry point of the slice (the
``_with_errors``, plain, ``convert_valid_*`` and native-endian ``utf16``
forms of UTF-16LE/BE <-> UTF-32 and of UTF-8/16/32 -> Latin-1, Latin-1 ->
UTF-8/16LE/16BE/32 with ``_safe`` and ``_into``, and the four arithmetic
Latin-1 length helpers) must answer exactly as the JAX api does, Result
and bytes alike, and as the codecs do on valid input. The valid-only
converters are compared on every input: both packages run the same
engine there. Both apis' previous implementations are restored afterwards.
"""

import numpy as np
import pytest

import simdutf_tpu as su
from simdutf_tpu import registry
from simdutf_tpu.ops.impl import XLAImplementation
from simdutf_tpu_torch import api


@pytest.fixture(scope="module")
def apis():
    before, before_jax = api._active, registry._active
    api.use_device("cpu")
    su.set_active_implementation(XLAImplementation())
    try:
        yield api, su
    finally:
        api._active = before
        with registry._lock:
            registry._active = before_jax


_ALPHABET = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff", "ÿ"]


def _text(seed: int, n: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET), n))


def _with(arr: np.ndarray, pos: int, value: int) -> bytes:
    out = arr.copy()
    out[pos] = value
    return out.tobytes()


def _same(a, b) -> bool:
    """Equal results of the two apis: (Result, bytes), bytes, or ints."""
    if isinstance(a, tuple):
        return ((int(a[0].error), a[0].count) == (int(b[0].error), b[0].count)
                and a[1] == b[1])
    return a == b


VALID = {"empty": "", "ascii": "plain. " * 100, "bmp": "aé東" * 300,
         "astral": "\U0001f642" * 200, "mixed": _text(1, 2500)}
U16 = {k: np.frombuffer(t.encode("utf-16-le"), np.uint16).copy() for k, t in VALID.items()}
U32 = {k: np.frombuffer(t.encode("utf-32-le"), np.uint32).copy() for k, t in VALID.items()}

#: (function, input encoding) -> {case: stored bytes}
FROM16 = ["convert_utf16%s_to_utf32_with_errors", "convert_utf16%s_to_utf32",
          "convert_valid_utf16%s_to_utf32"]
FROM32 = ["convert_utf32_to_utf16%s_with_errors", "convert_utf32_to_utf16%s",
          "convert_valid_utf32_to_utf16%s"]


def _u16_cases(be: bool):
    enc = "utf-16-be" if be else "utf-16-le"
    cases = {k: t.encode(enc) for k, t in VALID.items()}
    mixed = np.frombuffer(VALID["mixed"].encode(enc), np.uint16).copy()
    swap = (lambda v: ((v << 8) | (v >> 8)) & 0xFFFF) if be else (lambda v: v)
    cases["err_lone_high"] = _with(mixed, 1000, swap(0xD800))
    cases["err_lone_low_at_0"] = _with(mixed, 0, swap(0xDC00))
    cases["err_high_at_end"] = VALID["mixed"].encode(enc) + "\U0001f642".encode(enc)[:2]
    return cases


def _u32_cases():
    cases = {k: t.encode("utf-32-le") for k, t in VALID.items()}
    cases["err_surrogate"] = _with(U32["mixed"], 900, 0xDFFF)
    cases["err_too_large_at_0"] = _with(U32["mixed"], 0, 0x110000)
    cases["err_top_bit_at_end"] = _with(U32["mixed"], len(U32["mixed"]) - 1, 0x80000000)
    return cases


@pytest.mark.parametrize("form", FROM16)
@pytest.mark.parametrize("endian", ["le", "be", ""])
def test_utf16_to_utf32_entry_points(apis, form, endian):
    port, jax_api = apis
    name = form % endian
    for case, data in _u16_cases(endian == "be").items():
        got, want = getattr(port, name)(data), getattr(jax_api, name)(data)
        assert _same(got, want), (name, case)
        if case in VALID and "valid" not in name:
            out = got[1] if isinstance(got, tuple) else got
            assert out == VALID[case].encode("utf-32-le"), (name, case)


@pytest.mark.parametrize("form", FROM32)
@pytest.mark.parametrize("endian", ["le", "be", ""])
def test_utf32_to_utf16_entry_points(apis, form, endian):
    port, jax_api = apis
    name = form % endian
    enc = "utf-16-be" if endian == "be" else "utf-16-le"
    for case, data in _u32_cases().items():
        got, want = getattr(port, name)(data), getattr(jax_api, name)(data)
        assert _same(got, want), (name, case)
        if case in VALID and "valid" not in name:
            out = got[1] if isinstance(got, tuple) else got
            assert out == VALID[case].encode(enc), (name, case)


LATIN = {"empty": "", "ascii": "abc " * 200, "latin1": "naïve café ÿ ß " * 150}
ABOVE = {"above_ff": "naïve Āb café", "astral": "ab\U0001f642", "cjk_at_0": "東ab"}


def _to_latin1_inputs(source: str):
    enc = {"utf8": "utf-8", "utf16le": "utf-16-le", "utf16be": "utf-16-be",
           "utf16": "utf-16-le", "utf32": "utf-32-le"}[source]
    cases = {k: t.encode(enc) for k, t in {**LATIN, **ABOVE}.items()}
    if source == "utf8":
        cases["cont_at_0"] = b"\x80abc"
        cases["overlong"] = b"ab\xc1\xbf"
        cases["truncated"] = "é".encode() * 30 + b"\xc3"
    if source == "utf32":
        cases["top_bit"] = _with(np.frombuffer(cases["latin1"], np.uint32), 5, 0x800000E9)
    return cases


@pytest.mark.parametrize("source", ["utf8", "utf16le", "utf16be", "utf16", "utf32"])
@pytest.mark.parametrize("form", ["convert_%s_to_latin1_with_errors",
                                  "convert_%s_to_latin1", "convert_valid_%s_to_latin1"])
def test_to_latin1_entry_points(apis, source, form):
    port, jax_api = apis
    name = form % source
    for case, data in _to_latin1_inputs(source).items():
        got, want = getattr(port, name)(data), getattr(jax_api, name)(data)
        assert _same(got, want), (name, case)
        if case in LATIN:
            out = got[1] if isinstance(got, tuple) else got
            assert out == LATIN[case].encode("latin-1"), (name, case)
        elif "with_errors" in name:
            assert not got[0].is_ok


def _latin1_bytes():
    rng = np.random.default_rng(5)
    mixed = np.where(rng.random(5000) < 0.7, rng.integers(0x20, 0x7F, 5000),
                     rng.integers(0xC0, 0x100, 5000)).astype(np.uint8).tobytes()
    return {"empty": b"", "ascii": b"abc " * 300, "all_high": bytes([0xE9]) * 2000,
            "every_byte": bytes(range(256)) * 9, "mixed": mixed}


@pytest.mark.parametrize("name,enc", [
    ("convert_latin1_to_utf8", "utf-8"), ("convert_latin1_to_utf16le", "utf-16-le"),
    ("convert_latin1_to_utf16be", "utf-16-be"), ("convert_latin1_to_utf16", "utf-16-le"),
    ("convert_latin1_to_utf32", "utf-32-le")])
def test_latin1_to_x_entry_points(apis, name, enc):
    port, jax_api = apis
    for case, data in _latin1_bytes().items():
        got = getattr(port, name)(data)
        assert got == getattr(jax_api, name)(data), (name, case)
        assert got == data.decode("latin-1").encode(enc), (name, case)


@pytest.mark.parametrize("capacity", [0, 1, 2, 3, 7, 100, 4000, 10_000])
def test_latin1_to_utf8_safe_and_into(apis, capacity):
    port, jax_api = apis
    data = _latin1_bytes()["mixed"]
    assert (port.convert_latin1_to_utf8_safe(data, capacity)
            == jax_api.convert_latin1_to_utf8_safe(data, capacity))
    want = data.decode("latin-1").encode()
    if capacity >= len(want):
        dst = np.zeros(capacity, np.uint8)
        assert port.convert_latin1_to_utf8_into(data, dst) == len(want)
        assert dst[: len(want)].tobytes() == want
    else:
        with pytest.raises(ValueError):
            port.convert_latin1_to_utf8_into(data, np.zeros(capacity, np.uint8))


def test_latin1_length_helpers(apis):
    port, jax_api = apis
    for name in ("latin1_length_from_utf16", "latin1_length_from_utf32",
                 "utf16_length_from_latin1", "utf32_length_from_latin1"):
        for n in (0, 1, 12345):
            assert getattr(port, name)(n) == getattr(jax_api, name)(n) == n
    data = _latin1_bytes()["mixed"]
    assert port.utf8_length_from_latin1(data) == len(data.decode("latin-1").encode())
