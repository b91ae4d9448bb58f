"""The port's slice through the public simdutf_tpu api, on CPU.

With ``TorchImplementation("cpu")`` installed as the active implementation,
the public ``su.*`` entry points must answer exactly as the JAX ``xla``
tier and CPython's codecs do. The previous active implementation is
restored afterwards, and nothing is registered.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simdutf_tpu as su
from simdutf_tpu import registry
from simdutf_tpu.ops.impl import XLAImplementation

import simdutf_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ALPHABET = ["a", " ", "é", "Ж", "東", "\U0001f642"]


def _text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    return "".join(_ALPHABET[i] for i in rng.integers(0, len(_ALPHABET), n)).encode()


DATA = {
    "empty": b"",
    "ascii": b"The quick brown fox. " * 60,
    "u2": "é".encode() * 500,
    "u3": "東".encode() * 500,
    "u4": "\U0001f642".encode() * 300,
    "mixed": _text(7, 3000),
    "err_header": _text(8, 500) + b"\xff" + _text(9, 100),
    "err_orphan": b"\x80" + _text(10, 50),
    "err_truncated": _text(11, 400) + "東".encode()[:2],
    "err_surrogate": _text(12, 200) + b"\xed\xa0\x80",
}


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


@pytest.mark.parametrize("name", sorted(DATA))
@pytest.mark.parametrize("be", [False, True])
def test_transcode_matches_xla_and_codecs(torch_active, xla, name, be):
    data = DATA[name]
    api = su.convert_utf8_to_utf16be_with_errors if be else su.convert_utf8_to_utf16le_with_errors
    res, out = api(data)
    xfn = xla.convert_utf8_to_utf16be_with_errors if be else xla.convert_utf8_to_utf16le_with_errors
    xres, xout = xfn(np.frombuffer(data, np.uint8))
    assert (res.error, res.count) == (xres.error, xres.count)
    assert out == xout.tobytes()
    codec = "utf-16-be" if be else "utf-16-le"
    if name.startswith("err"):
        assert out == data[: res.count].decode().encode(codec)
    else:
        assert res.is_ok and out == data.decode().encode(codec)
        valid = su.convert_valid_utf8_to_utf16be if be else su.convert_valid_utf8_to_utf16le
        assert valid(data) == out


@pytest.mark.parametrize("name", sorted(DATA))
def test_validate_and_counts_match_xla(torch_active, xla, name):
    data = DATA[name]
    arr = np.frombuffer(data, np.uint8)
    assert su.validate_utf8_with_errors(data) == xla.validate_utf8_with_errors(arr)
    assert su.validate_utf8(data) == xla.validate_utf8(arr)
    assert su.count_utf8(data) == xla.count_utf8(arr)
    assert su.utf16_length_from_utf8(data) == xla.utf16_length_from_utf8(arr)
    assert su.utf32_length_from_utf8(data) == xla.utf32_length_from_utf8(arr)
    assert su.latin1_length_from_utf8(data) == xla.latin1_length_from_utf8(arr)
    assert su.utf8_length_from_latin1(data) == xla.utf8_length_from_latin1(arr)


def test_active_is_the_port_and_unregistered(torch_active):
    assert su.get_active_implementation() is torch_active
    assert torch_active.name == "torch"
    assert "torch" not in registry._implementations


def test_cuda_tier_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        simdutf_tpu_torch.TorchImplementation("cuda")


def test_port_runs_without_jax():
    """Import the port and run its slice on CPU in a fresh process: jax
    must never be loaded."""
    code = (
        "import sys\n"
        "import simdutf_tpu as su, simdutf_tpu_torch\n"
        "simdutf_tpu_torch.activate('cpu')\n"
        "d = 'a é 東 \\U0001f642'.encode() * 100\n"
        "res, out = su.convert_utf8_to_utf16le_with_errors(d)\n"
        "assert res.is_ok and out == d.decode().encode('utf-16-le')\n"
        "assert su.validate_utf8_with_errors(d + b'\\xff').count == len(d)\n"
        "assert su.count_utf8(d) == len(d.decode())\n"
        "assert su.utf16_length_from_utf8(d) == len(out) // 2\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
