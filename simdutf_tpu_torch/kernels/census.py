"""UTF-8 structural census: the routing bits of a buffer in one read.

Port of simdutf_tpu/kernels/census.census_bits (Pallas ``_census_kernel``).
On a CUDA tensor :func:`census_bits` launches ``census_utf8``
(csrc/census.cu); on a CPU tensor it runs :func:`census_bits_ref`.

The Hopper kernel's floor is HBM bytes, one streaming read of the
in-range bytes, 16 per thread per step, OR-reduced per warp into one
atomic; this first version is bound by its per-byte checks (PERF.md).
The TPU kernel's bitcast word geometry (mod-3 lane masks) is a TPU layout
device; the port takes the positional classes from the flat byte
position.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import positions, shift_left

# result bits, value-for-value simdutf_tpu/kernels/census.py
BIT_NONASCII = 1
BIT_V2 = 2
BIT_V3 = 4
BIT_V4 = 8
BIT_HAS2 = 16
BIT_HAS4 = 32
BIT_HASLO = 64


def census_bits_ref(b: torch.Tensor, length: int) -> torch.Tensor:
    """Plain torch census (simdutf_tpu/ops/utf8.census + presence, plus
    BIT_HASLO). A bit is set iff some in-range byte violates the ASCII /
    uniform-2 / 3 / 4 pattern, or is a 2-byte lead / a byte >= 0xF0 / a
    byte < 0x80. The byte after the last in-range one is read as stored
    (zero past the buffer end). Returns a 0-d int32 tensor."""
    x = b.to(torch.int32)
    idx = positions(x.shape[0], x.device)
    in_r = idx < length
    x1 = shift_left(x, 1)
    cont = (x & 0xC0) == 0x80
    c1 = (x1 & 0xC0) == 0x80

    ok2 = torch.where((idx & 1) == 0, (x >= 0xC2) & (x <= 0xDF), cont)
    lead3ok = (((x & 0xF0) == 0xE0) & c1 & ~((x == 0xE0) & (x1 < 0xA0))
               & ~((x == 0xED) & (x1 >= 0xA0)))
    ok3 = torch.where(idx % 3 == 0, lead3ok, cont)
    lead4ok = ((x >= 0xF0) & (x <= 0xF4) & c1 & ~((x == 0xF0) & (x1 < 0x90))
               & ~((x == 0xF4) & (x1 >= 0x90)))
    ok4 = torch.where((idx & 3) == 0, lead4ok, cont)

    bits = torch.zeros((), dtype=torch.int32, device=x.device)
    for bit, viol in ((BIT_NONASCII, x >= 0x80), (BIT_V2, ~ok2),
                      (BIT_V3, ~ok3), (BIT_V4, ~ok4),
                      (BIT_HAS2, (x & 0xE0) == 0xC0), (BIT_HAS4, x >= 0xF0),
                      (BIT_HASLO, x < 0x80)):
        bits = bits | torch.where((viol & in_r).any(), bit, 0).to(torch.int32)
    return bits


def census_bits(b: torch.Tensor, length: int) -> torch.Tensor:
    """OR-reduced violation/presence bits of the in-range bytes, as a 0-d
    int32 tensor on ``b``'s device (see :func:`census_bits_ref`)."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return census_bits_ref(b, length)
    out = torch.zeros(1, dtype=torch.int32, device=b.device)
    _build.call("census_utf8", b.data_ptr(), b.shape[0], length,
                out.data_ptr())
    _build.count_launch("census_utf8")
    return out[0]
