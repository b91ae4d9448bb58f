"""``TorchPallasImplementation("cpu")`` against the JAX package's
``PallasImplementation()`` (kernels in interpret mode) on the same inputs,
for every method it overrides: UTF-8, ASCII and UTF-16LE/BE validation
(bool and Result), UTF-8 -> Latin-1 (validating and valid-only) and base64
decode (FullResult and bytes; every alphabet, padding, last-chunk mode,
whitespace, garbage, char16 and short inputs, so both the clean decode
and the forgiving route run). Then its ``internal_tests`` must all pass,
and a spy shows which kernels each route launched. Integer results and
bytes: exact.
"""

import base64 as pyb64

import numpy as np
import pytest

import helpers
from simdutf_tpu.kernels.impl import PallasImplementation
from simdutf_tpu_torch import api as tapi
from simdutf_tpu_torch.kernels.impl import TorchPallasImplementation

JAX = PallasImplementation()
PORT = TorchPallasImplementation("cpu")


def _utf8_inputs():
    out = [("empty", b""), ("ascii", b"plain ascii text " * 300),
           ("mixed", "a é 東 \U0001f642 ".encode() * 500),
           ("cut@len", b"A" * 32767 + b"\xf0\x9f\x98")]
    out += [(f"mut{s}", helpers.mutate(helpers.random_utf8(s, 800, 2, 1, 1, 1), s, 2))
            for s in range(10)]
    out += [(f"bytes{s}", helpers.random_bytes(s, 300)) for s in range(5)]
    base = "a é 東 \U0001f642 ".encode() * 700
    for pos in (0, 1, 4, 4095, 4096, len(base) - 1):
        for bad in (b"\xff", b"\x80", b"\xed\xa0\x80", b"\xf4\x90\x80\x80"):
            d = bytearray(base)
            d[pos:pos + len(bad)] = bad
            out.append((f"{bad.hex()}@{pos}", bytes(d[:len(base)])))
    ascii_end = bytearray(b"x" * 20_000)
    ascii_end[-1] = 0xE9
    out.append(("ascii-e9@end", bytes(ascii_end)))
    return out


def _utf16_inputs():
    base = np.frombuffer(("a é 東 \U0001f642 " * 400).encode("utf-16-le"), np.uint16)
    out = [("empty", base[:0]), ("valid", base.copy()), ("hi@len-1", base[:-1].copy())]
    for pos in (0, 1, 2, 2047, 2048, len(base) - 1):
        for bad in (0xD800, 0xDC00, 0xDBFF):
            d = base.copy()
            d[pos] = bad
            out.append((f"{bad:04x}@{pos}", d))
    return out


UTF8 = _utf8_inputs()
UTF16 = _utf16_inputs()


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


@pytest.mark.parametrize("name,data", UTF8, ids=[c[0] for c in UTF8])
def test_utf8_and_ascii_validation_match(name, data):
    b = _u8(data)
    assert PORT.validate_utf8(b) == JAX.validate_utf8(b)
    assert PORT.validate_utf8_with_errors(b) == JAX.validate_utf8_with_errors(b)
    assert PORT.validate_ascii(b) == JAX.validate_ascii(b)
    assert PORT.validate_ascii_with_errors(b) == JAX.validate_ascii_with_errors(b)


@pytest.mark.parametrize("name,units", UTF16, ids=[c[0] for c in UTF16])
@pytest.mark.parametrize("be", [False, True])
def test_utf16_validation_matches(name, units, be):
    w = units.byteswap() if be else units
    end = "be" if be else "le"
    for method in (f"validate_utf16{end}", f"validate_utf16{end}_with_errors"):
        assert getattr(PORT, method)(w) == getattr(JAX, method)(w), method


@pytest.mark.parametrize("data", [b"", b"ascii only " * 900, "café ".encode() * 300,
                                  b"x" * 9000 + b"\xc3", b"a\x80b" * 40],
                         ids=["empty", "ascii", "latin1", "cut", "bad"])
def test_utf8_to_latin1_matches(data):
    b = _u8(data)
    res, out = PORT.convert_utf8_to_latin1_with_errors(b)
    want_res, want_out = JAX.convert_utf8_to_latin1_with_errors(b)
    assert res == want_res and np.array_equal(out, want_out)
    if want_res.is_ok:
        assert np.array_equal(PORT.convert_valid_utf8_to_latin1(b),
                              JAX.convert_valid_utf8_to_latin1(b))


def _b64_inputs():
    raw = np.random.default_rng(64).integers(0, 256, 6000, dtype=np.uint8).tobytes()
    std, url = pyb64.b64encode(raw), pyb64.urlsafe_b64encode(raw)
    ws = b"\n".join(std[i:i + 76] for i in range(0, len(std), 76))
    return [("clean", std), ("clean-url", url), ("pad1", pyb64.b64encode(raw[:5000])),
            ("pad2", pyb64.b64encode(raw[:4999])), ("nopad", pyb64.b64encode(raw[:4999])[:-2]),
            ("trailing-ws", std + b"  \n"), ("mime", ws), ("bad-char", std[:3000] + b"*" + std[3000:]),
            ("eq-inside", std[:3000] + b"=" + std[3001:]), ("tail1", std[:4001]),
            ("short", b"QQ=="), ("tiny", b"QQ"), ("extra-bits", b"QR==")]


B64 = _b64_inputs()


@pytest.mark.parametrize("name,chars", B64, ids=[c[0] for c in B64])
@pytest.mark.parametrize("options", [0, 1, 2, 4, 8, 12])
@pytest.mark.parametrize("last_chunk", [0, 1, 2])
def test_base64_decode_matches(name, chars, options, last_chunk):
    src = _u8(chars)
    full, out = PORT.base64_to_binary_details(src, options, last_chunk)
    want_full, want_out = JAX.base64_to_binary_details(src, options, last_chunk)
    assert full == want_full
    assert np.array_equal(out, want_out)


def test_base64_char16_takes_the_forgiving_route():
    src = np.frombuffer(pyb64.b64encode(b"char16 input " * 50), np.uint8).astype(np.uint16)
    full, out = PORT.base64_to_binary_details(src, 0, 0)
    want_full, want_out = JAX.base64_to_binary_details(src, 0, 0)
    assert full == want_full and np.array_equal(out, want_out)
    assert out.tobytes() == b"char16 input " * 50


def test_routes_take_their_kernels(monkeypatch):
    """A spy on the wrappers: clean base64 launches the clean decode and
    nothing of the forgiving path; MIME base64 the forgiving path after a
    host peek; each validation one SWAR scan and no safety net."""
    from simdutf_tpu_torch.kernels import base64_kernel, swar
    from simdutf_tpu_torch.ops import base64_ops

    calls = []
    for mod, names in ((swar, ("utf8_swar_first_bad_word", "ascii_swar_first_bad_word",
                               "utf16_swar_first_bad_word")),
                       (base64_kernel, ("clean_decode",)),
                       (base64_ops, ("decode_bulk_routed",))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (calls.append(_n), _f(*a, **k))[1])
    impl = TorchPallasImplementation("cpu")
    raw = b"route check " * 400
    impl.base64_to_binary_details(_u8(pyb64.b64encode(raw)))
    assert calls == ["clean_decode"]
    calls.clear()
    mime = pyb64.encodebytes(raw)
    full, out = impl.base64_to_binary_details(_u8(mime))
    assert calls == ["decode_bulk_routed"] and out.tobytes() == raw
    calls.clear()
    impl.validate_utf8_with_errors(_u8(b"ok \xff"))
    impl.validate_ascii_with_errors(_u8(b"ok \xff"))
    impl.validate_utf16le_with_errors(np.array([0x61, 0xDC00], np.uint16))
    impl.convert_utf8_to_latin1_with_errors(_u8(b"ascii"))
    assert calls == ["utf8_swar_first_bad_word", "ascii_swar_first_bad_word",
                     "utf16_swar_first_bad_word", "ascii_swar_first_bad_word"]
    assert impl.safety_net == 0


@pytest.mark.parametrize("kind", ["utf8", "utf16"])
def test_an_unconfirmed_flag_takes_the_counted_safety_net(monkeypatch, kind):
    """The rewind of a flagged word that holds no error (a SWAR false
    positive, which no input above produces) falls back on the exact
    kernel over the whole buffer, and counts the entry."""
    from simdutf_tpu_torch.kernels import swar

    impl = TorchPallasImplementation("cpu")
    if kind == "utf8":
        monkeypatch.setattr(swar, "utf8_swar_first_bad_word", lambda b, n: 100)
        data = _u8("a é 東 ".encode() * 300 + b"\xff")
        assert impl.validate_utf8_with_errors(data) == JAX.validate_utf8_with_errors(data)
    else:
        monkeypatch.setattr(swar, "utf16_swar_first_bad_word", lambda w, n, be: 450)
        data = np.frombuffer(("x" * 2000 + "\U0001f642").encode("utf-16-le"), np.uint16)[:-1].copy()
        assert impl.validate_utf16le_with_errors(data) == JAX.validate_utf16le_with_errors(data)
    assert impl.safety_net == 1


def test_internal_tests_pass():
    names = []
    for name, check in PORT.internal_tests():
        check()
        names.append(name)
    assert names[:4] == [n for n, _ in JAX.internal_tests()]
    assert names[4:] == ["lane_shapecast"]


def test_api_runs_on_the_tier():
    try:
        tapi.use_device(TorchPallasImplementation("cpu"))
        assert tapi.get_implementation().name == "pallas"
        assert tapi.validate_utf8_with_errors(b"ab\xff") == (tapi.error_code.HEADER_BITS, 2)
    finally:
        tapi.use_device("cpu")
