"""The Hopper kernels against their plain torch versions, on the card.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip. On a
machine with the card:

    python -m pytest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(``chip_smoke.py`` runs the same comparisons at the full 64 MiB size.)
"""

import numpy as np
import pytest
import torch

from simdutf_tpu_torch.kernels import census as kcen
from simdutf_tpu_torch.kernels import compose16 as kc
from simdutf_tpu_torch.kernels import validate as kv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0")
    return torch.device("cuda")


def _inputs():
    rng = np.random.default_rng(0)
    alphabet = ["a", "é", "東", "\U0001f642", " "]
    bad = [b"\x80", b"\xff", b"\xe6\x9d", b"\xf0\x9f", b"\xed\xa0\x80"]
    out = [("u3", "東".encode() * 5000), ("empty", b"")]
    for t in range(12):
        size = int(rng.integers(1, 50_000))
        d = bytearray("".join(alphabet[i] for i in rng.integers(0, 5, size)).encode()[:size])
        for _ in range(t % 3):
            p = int(rng.integers(0, len(d) + 1))
            d[p:p] = bad[int(rng.integers(len(bad)))]
        out.append((f"fuzz{t}", bytes(d)))
    return out


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        if x.dtype == torch.uint16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x.to(torch.int64).cpu(), y.to(torch.int64).cpu()):
            return False
    return True


@pytest.mark.parametrize("name,data", _inputs())
def test_kernels_match_plain_versions(cuda, name, data):
    n = len(data) + 13  # bytes past the length are garbage
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    x, L = torch.from_numpy(buf).to(cuda), len(data)
    assert _same(kcen.census_bits(x, L), kcen.census_bits_ref(x, L))
    assert _same(kv.utf8_first_event_len(x, L), kv.utf8_first_event_len_ref(x, L))
    for what in ("count", "utf16", "latin1"):
        assert _same(kv._count_call(x, L, what), kv.count_ref(x, L, what))
    for be in (False, True):
        assert _same(kc.to_utf16_compose(x, L, be), kc.to_utf16_compose_ref(x, L, be))
    torch.cuda.synchronize()
