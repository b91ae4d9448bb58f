"""Structural census: the routing bits of a buffer in one read.

Port of simdutf_tpu/kernels/census.census_bits (Pallas ``_census_kernel``)
and census16_bits (``_census16_kernel``). On a CUDA tensor
:func:`census_bits` launches ``census_utf8`` (csrc/census.cu) and
:func:`census16_bits` ``census_utf16`` (csrc/census16.cu); on a CPU tensor
they run :func:`census_bits_ref` / :func:`census16_bits_ref`.

Both Hopper kernels' floor is HBM bytes, one streaming read of the
in-range elements, OR-reduced per warp into one atomic. census_utf8 checks
four bytes at a time on 32-bit words, and a warp skips the checks whose
bits it already holds: after a warp's first chunks, text that no
fixed-rate class admits needs only the presence tests, so the read is
bound by bytes, not by checks. It also counts the 16-byte chunks that ran
a positional check (:func:`census_bits` with ``counted=True``;
:func:`read_bits` adds them to the trace's counts). census_utf16 runs near
the copy rate (PERF.md). The positional classes come from the flat
position, as lane masks of each word (mod 3 by the word's position).
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import bswap16, positions, shift_left, units_i32

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


def census_chunks(b: torch.Tensor, length: int) -> int:
    """The 16-byte chunks the census reads in range: those of the buffer's
    16-byte-aligned frame on a CUDA tensor (one more than
    ``ceil(length / 16)`` where the base is not aligned and the bytes
    straddle one more chunk), ``ceil(length / 16)`` on the CPU."""
    lead = b.data_ptr() & 15 if b.is_cuda else 0
    return (lead + length + 15) // 16


@trace.kernel
def census_bits(b: torch.Tensor, length: int, counted: bool = False) -> torch.Tensor:
    """OR-reduced violation/presence bits of the in-range bytes, as a 0-d
    int32 tensor on ``b``'s device (see :func:`census_bits_ref`). With
    ``counted``, a 0-d int64 tensor: the bits in its low 32 bits, and in
    its high 32 the in-range chunks (:func:`census_chunks`) that ran a
    positional check; the plain version checks every byte, so it reports
    them all."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        bits = census_bits_ref(b, length)
        if not counted:
            return bits
        return bits.to(torch.int64) | (census_chunks(b, length) << 32)
    out = torch.zeros(2, dtype=torch.int32, device=b.device)  # bits, checked chunks
    _build.call("census_utf8", b.data_ptr(), b.shape[0], length,
                out.data_ptr())
    return out.view(torch.int64)[0] if counted else out[0]


def read_bits(site: str, b: torch.Tensor, length: int) -> int:
    """The census bits on the host, from one read of the bits and the
    checked-chunk count as one int64 (``trace.sync`` at ``site``). While a
    profiler records, adds the chunks checked and the chunks in range to
    the trace's counts ``census.checked_chunks`` and ``census.chunks``."""
    both = trace.sync(site, int, census_bits(b, length, counted=True))
    if trace.recording():
        trace.count("census.checked_chunks", both >> 32)
        trace.count("census.chunks", census_chunks(b, length))
    return both & 0xFFFFFFFF


# UTF-16 census bits, value-for-value simdutf_tpu/kernels/census.py
BIT16_NONASCII = 1
BIT16_V2 = 2
BIT16_V3 = 4
BIT16_VASTRAL = 8


def census16_bits_ref(w: torch.Tensor, length: int, be: bool = False) -> torch.Tensor:
    """Plain torch UTF-16 census (simdutf_tpu/ops/utf16.census's jnp
    form). A bit is set iff some in-range unit (byte-swapped when ``be``)
    breaks the ASCII / uniform 0x80..0x7FF / uniform 0x800..0xFFFF
    non-surrogate / high-low pair pattern. Returns a 0-d int32 tensor."""
    x = units_i32(w)
    if be:
        x = bswap16(x)
    idx = positions(x.shape[0], x.device)
    in_r = idx < length
    sur = (x & 0xF800) == 0xD800
    pair_ok = torch.where((idx & 1) == 0, (x & 0xFC00) == 0xD800,
                          (x & 0xFC00) == 0xDC00)
    bits = torch.zeros((), dtype=torch.int32, device=x.device)
    for bit, viol in ((BIT16_NONASCII, x >= 0x80),
                      (BIT16_V2, (x < 0x80) | (x > 0x7FF)),
                      (BIT16_V3, (x < 0x800) | sur),
                      (BIT16_VASTRAL, ~pair_ok)):
        bits = bits | torch.where((viol & in_r).any(), bit, 0).to(torch.int32)
    return bits


@trace.kernel
def census16_bits(w: torch.Tensor, length: int, be: bool = False) -> torch.Tensor:
    """OR-reduced violation bits of the in-range units of a uint16 buffer
    (``length`` in units), as a 0-d int32 tensor on ``w``'s device (see
    :func:`census16_bits_ref`). ``be`` byte-swaps the units in registers."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return census16_bits_ref(w, length, be)
    out = torch.zeros(1, dtype=torch.int32, device=w.device)
    _build.call("census_utf16", w.data_ptr(), length, int(be), out.data_ptr())
    return out[0]
