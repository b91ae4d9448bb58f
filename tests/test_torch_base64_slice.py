"""The port's forgiving base64 through the public simdutf_tpu api, on CPU.

With ``TorchImplementation("cpu")`` installed as the active
implementation, ``base64_to_binary``, ``base64_to_binary_details``,
``base64_to_binary_safe`` and ``binary_to_base64`` must answer exactly as
the JAX ``xla`` tier and the golden tier do: across the options x
last-chunk matrix and the inputs of tests/test_base64.py, on char16
input, at small safe-decode capacities, and for encode at lengths 0-40
and around the 1536-byte pad multiple. The previous active
implementation is restored afterwards.
"""

import base64 as pyb64

import numpy as np
import pytest

import simdutf_tpu as su
from simdutf_tpu import registry
from simdutf_tpu.golden import base64_impl as gb
from simdutf_tpu.ops.impl import XLAImplementation
from test_base64 import CASES, CHUNKS, OPTIONS

import simdutf_tpu_torch


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


def _out(x) -> bytes:
    return bytes(np.asarray(x, np.uint8))


@pytest.mark.parametrize("options", OPTIONS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_decode_matrix_matches_xla_and_golden(torch_active, xla, options, chunk):
    for data in CASES:
        src = np.frombuffer(data, np.uint8)
        full, out = su.base64_to_binary_details(data, options, chunk)
        g_full, g_out = gb.decode(src, options, chunk)
        x_full, x_out = xla.base64_to_binary_details(src, options, chunk)
        assert full == g_full == x_full, (data, options, chunk)
        assert out == _out(g_out) == _out(x_out), (data, options, chunk)
        res, out2 = su.base64_to_binary(data, options, chunk)
        assert res == full.to_result() and out2 == out


@pytest.mark.parametrize("options", [0, 1, 4, 8, 12])
def test_char16_matches_golden(torch_active, options):
    rng = np.random.default_rng(options)
    alphabet = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnop0123456789+/-_ \t\n=",
                             np.uint8)
    for trial in range(30):
        units = rng.choice(alphabet, int(rng.integers(0, 60))).astype(np.uint16)
        if trial % 4 == 3 and len(units):
            units[int(rng.integers(len(units)))] = int(rng.integers(0x100, 0x10000))
        for chunk in CHUNKS:
            got = su.base64_to_binary_details(units, options, chunk)
            want = gb.decode(units, options, chunk)
            assert got == (want[0], _out(want[1])), (units, chunk)
    wrapped = np.frombuffer(b"\r\n".join([b"aGVsbG8gd29ybGQh"] * 40), np.uint8)
    res, out = su.base64_to_binary(wrapped.astype(np.uint16), options)
    assert res.is_ok and out == b"hello world!" * 40


@pytest.mark.parametrize("capacity", [0, 1, 2, 3, 5, 8, 40, 1000])
@pytest.mark.parametrize("up_to_bad", [False, True])
def test_safe_decode_matches_golden(torch_active, capacity, up_to_bad):
    """The port's own ``base64_to_binary_safe`` (its copy of the
    capacity-limited loop over its details decode), through the public
    api, answers as the golden tier does."""
    inputs = [b"aGVsbG8gd29ybGQh", b"aGVs bG8g\nd29y bGQ=", b"aGVsbG8*d29ybGQh",
              b"QUJDREVGR0g", b"QQ==", pyb64.b64encode(bytes(range(100)))]
    for data in inputs:
        src = np.frombuffer(data, np.uint8)
        for options, chunk in ((0, gb.LOOSE), (1, gb.STRICT), (4, gb.STOP_BEFORE_PARTIAL)):
            got = su.base64_to_binary_safe(data, capacity, options, chunk, up_to_bad)
            res, out = gb.decode_safe(src, capacity, options, chunk, up_to_bad)
            assert got == (res, _out(out)), (data, capacity, options, chunk)


@pytest.mark.parametrize("options", [0, 1, 2, 3])
def test_encode_matches_xla_and_golden(torch_active, xla, options):
    lengths = list(range(41)) + [1535, 1536, 1537, 1538, 3 * 1536 - 1, 3 * 1536, 3 * 1536 + 2]
    for n in lengths:
        data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
        got = su.binary_to_base64(data.tobytes(), options)
        assert got == _out(gb.encode(data, options)) == _out(xla.binary_to_base64(data, options))
        if options == 0:
            assert got == pyb64.b64encode(data.tobytes())
