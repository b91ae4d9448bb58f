"""simdutf_tpu_torch encoding detection against the JAX package, on CPU.

* ``ops/detect.detect_encodings`` (the detect kernel's wrapper, whose
  plain version composes the three first-error functions) against
  ``simdutf_tpu.ops.detect.detect_encodings`` on the same padded buffer,
  with zeros and with garbage past the length: odd lengths, lengths that
  are not multiples of 4, a high surrogate at the last unit, a low one at
  unit 0, words above 0x10FFFF, at or above 2^31 and in D800-DFFF;
* the kernel's wrapper against the Pallas ``detect_fused`` (interpret
  mode) on the Pallas layout, ``_pad2d``;
* ``detect_encodings`` through the two apis (the port on
  ``use_device("cpu")``, the JAX package on its ``xla`` tier), BOMs
  included.

Flags: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdutf_tpu as su
from simdutf_tpu import registry
from simdutf_tpu.kernels import detect_kernel as jdet
from simdutf_tpu.kernels.impl import _pad2d
from simdutf_tpu.ops import detect as jodet
from simdutf_tpu.ops.impl import XLAImplementation
from simdutf_tpu_torch import api, impl
from simdutf_tpu_torch.kernels import detect_kernel as tdet
from simdutf_tpu_torch.ops import detect as todet

_jdetect = jax.jit(jodet.detect_encodings)
_TEXT = "ab é 東 \U0001f642 "


def _with(data: bytes, pos: int, value: bytes) -> bytes:
    return data[:pos] + value + data[pos + len(value):]


_U16 = (_TEXT * 300).encode("utf-16-le")
_U32 = (_TEXT * 200).encode("utf-32-le")
CASES = {
    "empty": b"",
    "one": b"a",
    "utf8": (_TEXT * 300).encode(),
    "utf8_bad": _with((_TEXT * 300).encode(), 2001, b"\xff"),
    "utf16le": _U16,
    "utf16le_odd": _U16 + b"a",
    "utf16le_hi_last": _U16[:-4] + b"\x3d\xd8",
    "utf16le_hi_last_odd": _U16[:-4] + b"\x3d\xd8\x00",
    "utf16le_lo_first": b"\x00\xdc" + _U16[2:],
    "utf16le_lo_at_4096": _with(_U16, 4096, b"\x00\xdc"),
    "utf16le_hi_at_16382": _with(_U16, 16382, b"\x00\xd8"),
    "utf32le": _U32,
    "utf32le_plus_3": _U32 + b"abc",
    "utf32le_too_large": _with(_U32, 4096, b"\x00\x00\x11\x00"),
    "utf32le_top_bit": _with(_U32, 8188, b"\x00\x00\x00\x80"),
    "utf32le_surrogate": _with(_U32, len(_U32) - 4, b"\x00\xd8\x00\x00"),
    "random": bytes(np.random.default_rng(3).integers(0, 256, 3001).astype(np.uint8)),
    "ascii_words": b"abcd" * 1000,
}


def _port(buf: np.ndarray, n: int):
    return tuple(int(v) for v in todet.detect_encodings(torch.from_numpy(buf), n))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("garbage", [False, True])
def test_detect_matches_jax_ops(name, garbage):
    data = CASES[name]
    buf, n = impl._pad(np.frombuffer(data, np.uint8))
    buf = buf.copy()
    if garbage:  # bytes past the length: a low surrogate, a bad word, 0xFF
        buf[n:] = np.resize(np.frombuffer(b"\x00\xdc\xff\xff", np.uint8), len(buf) - n)
    want = tuple(int(v) for v in _jdetect(jnp.asarray(buf), n))
    assert _port(buf, int(n)) == want


@pytest.mark.parametrize("name", ["utf16le_hi_last", "utf32le_top_bit", "random"])
def test_detect_kernel_matches_pallas(name):
    """On the Pallas layout: zeros past the length, one 32 KiB tile."""
    data = CASES[name]
    x2d, n = _pad2d(np.frombuffer(data, np.uint8))
    x2d = x2d.copy()
    want = tuple(int(v) for v in jdet.detect_fused(jnp.asarray(x2d), n))
    got = tuple(int(v) for v in tdet.detect_fused(torch.from_numpy(x2d.reshape(-1)), int(n)))
    assert got == want


def test_plain_version_is_the_composition():
    buf, n = impl._pad(np.frombuffer(CASES["utf16le_hi_last"], np.uint8))
    got = tdet.detect_fused_ref(torch.from_numpy(buf.copy()), int(n))
    assert [int(v) for v in got] == [0, 0, 0]


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


BOMS = [b"", b"\xef\xbb\xbf", b"\xff\xfe", b"\xfe\xff", b"\xff\xfe\x00\x00", b"\x00\x00\xfe\xff"]


@pytest.mark.parametrize("bom", BOMS, ids=lambda b: b.hex() or "none")
def test_detect_encodings_through_the_apis(apis, bom):
    port, jax_api = apis
    for name, data in sorted(CASES.items()):
        d = bom + data
        assert port.detect_encodings(d) == jax_api.detect_encodings(d), name
        assert int(port.autodetect_encoding(d)) == int(jax_api.autodetect_encoding(d)), name
