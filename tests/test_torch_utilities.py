"""The port's ASCII validation, UTF-16 utilities, trim_partial,
autodetect_encoding and capacity-limited base64 decode against the JAX
package, on CPU.

* ``ops/utf8.validate_ascii_with_errors`` against the JAX op on the same
  padded buffer (garbage past the length included), and its kernel
  ``kernels/validate.ascii_first_bad`` against the Pallas
  ``ascii_first_bad`` (interpret mode) on the Pallas layout, ``_pad2d``;
* ``ops/utf16.change_endianness`` and ``ops/utf16.to_well_formed`` (LE and
  BE) against the JAX ops on full buffers, and the well-formed kernel
  against the Pallas ``utf16_to_well_formed`` (interpret mode) on
  ``_pad2d16``;
* ``trim_partial_*``, ``autodetect_encoding`` and ``base64_to_binary_safe``
  (capacities below, at and above the maximal length, every last-chunk
  mode, ``decode_up_to_bad_char``) through the two apis, the port on
  ``use_device("cpu")`` and the JAX package on its ``xla`` tier;
* the name pin: the port's api has every public name of the JAX api but
  the tier registry.

Integer results and buffers: exact.
"""

import base64 as pyb64
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdutf_tpu as su
import simdutf_tpu.api as japi
from simdutf_tpu import registry
from simdutf_tpu.kernels import utf16_kernels as jk16
from simdutf_tpu.kernels import validate as jkv
from simdutf_tpu.kernels.impl import _pad2d, _pad2d16
from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu.ops.impl import XLAImplementation
from simdutf_tpu_torch import api, impl
from simdutf_tpu_torch.kernels import utf16_kernels as tk16
from simdutf_tpu_torch.kernels import validate as tkv
from simdutf_tpu_torch.ops import utf8 as to8
from simdutf_tpu_torch.ops import utf16 as to16
from simdutf_tpu_torch.ops.common import BIG

_jascii = jax.jit(jo8.validate_ascii_with_errors)
_jswap = jax.jit(jo16.change_endianness)
_jwf = jax.jit(jo16.to_well_formed, static_argnums=2)


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


def _ascii_case(n: int, bad_at=()) -> bytes:
    d = bytearray(np.random.default_rng(n).integers(0x20, 0x7F, n).astype(np.uint8))
    for p in bad_at:
        d[p] = 0x80 + p % 0x80
    return bytes(d)


ASCII = {
    "empty": b"",
    "ascii": _ascii_case(3000),
    "high@0": _ascii_case(3000, [0]),
    "high@len-1": _ascii_case(3000, [2999]),
    "high@15,16": _ascii_case(600, [16, 15]),
    "high@511,512": _ascii_case(5000, [512, 511]),
    "high@4096": _ascii_case(9000, [4096, 8000]),
    "utf8": "ab é 東 \U0001f642".encode() * 50,
}


@pytest.mark.parametrize("name", sorted(ASCII))
@pytest.mark.parametrize("garbage", [False, True])
def test_validate_ascii_matches_jax(name, garbage):
    data = ASCII[name]
    buf, n = impl._pad(np.frombuffer(data, np.uint8))
    buf = buf.copy()
    if garbage:  # high bytes past the length are ignored by both
        buf[n:] = np.random.default_rng(n).integers(0x80, 0x100, len(buf) - n)
    code, pos = to8.validate_ascii_with_errors(torch.from_numpy(buf), int(n))
    want = _jascii(jnp.asarray(buf), n)
    assert (int(code), int(pos)) == tuple(int(v) for v in want)


@pytest.mark.parametrize("name", ["ascii", "high@0", "high@len-1", "high@511,512"])
def test_ascii_first_bad_matches_pallas(name):
    """On the Pallas layout (zeros past the length, one 32 KiB tile)."""
    data = ASCII[name]
    x2d, n = _pad2d(np.frombuffer(data, np.uint8))
    x2d = x2d.copy()
    want = int(jkv.ascii_first_bad(jnp.asarray(x2d)))
    got = int(tkv.ascii_first_bad(torch.from_numpy(x2d.reshape(-1)), int(n)))
    assert got == want and (got == BIG) == (name == "ascii")


def _units(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


def _with(units, pos, value) -> np.ndarray:
    out = np.array(units, np.uint16)
    out[pos] = value
    return out


_X = _units("x" * 5000)
_M = _units("ab é 東 \U0001f642 " * 400)
UNITS = {
    "empty": np.zeros(0, np.uint16),
    "mixed": _M,
    "lone_high@0": _with(_M, 0, 0xD800),
    "lone_low@0": _with(_M, 0, 0xDC00),
    "lone_high@len-1": np.concatenate([_M[:2999], [0xDBFF]]).astype(np.uint16),
    "lone_low@7,8": _with(_with(_X, 7, 0xDC00), 8, 0xDFFF),
    "lone_high@2047": _with(_X, 2047, 0xD800),
    "lone_low@2048": _with(_X, 2048, 0xDC00),
    "pair@2047": _units("x" * 2047 + "\U0001f642" + "é" * 100),
    "high_high_low": np.array([0x41, 0xD800, 0xD800, 0xDC00, 0x42], np.uint16),
}


def _staged16(units: np.ndarray, be: bool, garbage: bool):
    buf, n = impl._pad(units.byteswap() if be else units)
    buf = buf.copy()
    if garbage:  # stored past the length, and kept as stored
        buf[n:] = np.random.default_rng(n).integers(0, 1 << 16, len(buf) - n)
    return buf, int(n)


def _t16(buf: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(buf.view(np.int16)).view(torch.uint16)


def _np16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("name", sorted(UNITS))
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("garbage", [False, True])
def test_to_well_formed_and_swap_match_jax(name, be, garbage):
    buf, n = _staged16(UNITS[name], be, garbage)
    got = to16.to_well_formed(_t16(buf), n, be)
    assert np.array_equal(_np16(got), np.asarray(_jwf(jnp.asarray(buf), n, be)))
    assert np.array_equal(_np16(to16.change_endianness(_t16(buf))),
                          np.asarray(_jswap(jnp.asarray(buf))))


@pytest.mark.parametrize("be", [False, True])
def test_well_formed_high_at_length_minus_one_is_lone(be):
    """The low half stored at the length does not pair with a high at
    length-1; the stored unit itself is kept."""
    units = _units("ab\U0001f642")
    buf = units.byteswap() if be else units.copy()
    got = _np16(to16.to_well_formed(_t16(buf), 3, be))
    want = np.array([0x61, 0x62, 0xFFFD, units[3]], np.uint16)
    assert np.array_equal(got, want.byteswap() if be else want)


@pytest.mark.parametrize("name", ["mixed", "lone_low@0", "lone_high@len-1", "lone_high@2047"])
@pytest.mark.parametrize("be", [False, True])
def test_well_formed_kernel_matches_pallas(name, be):
    """On the Pallas layout (zero tiles fore and aft, zeros past the
    length): the in-range units and the zeros after them."""
    units = UNITS[name]
    stored = units.byteswap() if be else units
    x2d, n = _pad2d16(stored)
    want = np.asarray(jk16.utf16_to_well_formed(jnp.asarray(x2d.copy()), be)).reshape(-1)
    buf = np.zeros(len(units) + 9, np.uint16)
    buf[: len(units)] = stored
    got = _np16(tk16.utf16_to_well_formed(_t16(buf), int(n), be))
    assert np.array_equal(got, want[: len(buf)])


def test_trim_partial_matches_jax(apis):
    port, jax_api = apis
    text = "aé東\U0001f642".encode()
    for k in range(len(text) + 1):
        assert port.trim_partial_utf8(text[:k]) == jax_api.trim_partial_utf8(text[:k])
    for d in (b"", b"\xc3", b"\xe6\x9d", b"a\xf0\x9f\x99"):
        assert port.trim_partial_utf8(d) == jax_api.trim_partial_utf8(d)
    units = _units("a\U0001f642b\U0001f642")
    for k in range(len(units) + 1):
        for fn in ("trim_partial_utf16le", "trim_partial_utf16", "trim_partial_utf16be"):
            w = units[:k] if fn != "trim_partial_utf16be" else units[:k].byteswap()
            assert getattr(port, fn)(w) == getattr(jax_api, fn)(w), (fn, k)


def test_utf16_utilities_through_the_apis(apis):
    port, jax_api = apis
    for name, units in sorted(UNITS.items()):
        for fn in ("change_endianness_utf16", "to_well_formed_utf16le",
                   "to_well_formed_utf16be", "to_well_formed_utf16"):
            assert getattr(port, fn)(units) == getattr(jax_api, fn)(units), (fn, name)
    for name, data in sorted(ASCII.items()):
        assert port.validate_ascii_with_errors(data) == jax_api.validate_ascii_with_errors(data)
        assert port.validate_ascii(data) == jax_api.validate_ascii(data)


_DETECT = {
    "empty": b"", "ascii": b"plain text", "utf8": "aé東\U0001f642".encode(),
    "utf16le": "aé東\U0001f642".encode("utf-16-le"),
    "utf32le": "aé東\U0001f642".encode("utf-32-le"),
    "bom8": b"\xef\xbb\xbfabc", "bom16le": b"\xff\xfeab", "bom16be": b"\xfe\xff\x00a",
    "bom32le": b"\xff\xfe\x00\x00a\x00\x00\x00", "bom32be": b"\x00\x00\xfe\xff",
    "odd": b"\xff\xd8\x00", "lone_low": b"\x00\xdc\x41\x00",
    "garbage": bytes(np.random.default_rng(7).integers(0, 256, 401).astype(np.uint8)),
}


def test_autodetect_encoding_matches_jax(apis):
    port, jax_api = apis
    for name, data in sorted(_DETECT.items()):
        assert int(port.autodetect_encoding(data)) == int(jax_api.autodetect_encoding(data)), name


_B64 = [b"aGVsbG8gd29ybGQh", b"aGVs bG8g\nd29y bGQ=", b"aGVsbG8*d29ybGQh",
        b"QUJDREVGR0g", b"QQ==", b"QQ", b"Q", b"QUI=\n", b"", b" = ",
        pyb64.b64encode(bytes(range(100)))]


@pytest.mark.parametrize("options", [0, 1, 4, 8])
@pytest.mark.parametrize("chunk", [0, 1, 2])
@pytest.mark.parametrize("up_to_bad", [False, True])
def test_safe_decode_matches_jax(apis, options, chunk, up_to_bad):
    """Capacities below, at and above the maximal length."""
    port, jax_api = apis
    for data in _B64:
        top = port.maximal_binary_length_from_base64(data)
        for capacity in sorted({0, 1, 2, 3, 5, max(top - 1, 0), top, top + 7}):
            got = port.base64_to_binary_safe(data, capacity, options, chunk, up_to_bad)
            want = jax_api.base64_to_binary_safe(data, capacity, options, chunk, up_to_bad)
            assert got == want, (data, capacity, options, chunk, up_to_bad)
            assert port.atomic_base64_to_binary_safe(
                data, capacity, options, chunk, up_to_bad) == got
            assert len(got[1]) <= capacity
    wide = np.frombuffer(_B64[0], np.uint8).astype(np.uint16)
    assert port.base64_to_binary_safe(wide, 5) == jax_api.base64_to_binary_safe(wide, 5)
    assert port.atomic_binary_to_base64(b"hello", options) == jax_api.atomic_binary_to_base64(
        b"hello", options)


def _public(module) -> set:
    return {k for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


def test_api_has_every_public_name_of_the_jax_api():
    registry_trio = {"get_active_implementation", "set_active_implementation",
                     "get_available_implementations"}
    port_own = {"use_device", "get_implementation", "TorchImplementation"}
    assert _public(japi) - registry_trio == _public(api) - port_own
