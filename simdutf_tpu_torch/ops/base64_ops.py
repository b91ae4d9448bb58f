"""Forgiving base64 on torch tensors (port of simdutf_tpu/ops/base64_ops.py).

Decode = range-compare classification of each char (the to_base64 tables
of src/tables/base64_tables.h as compares) + compaction of the alphabet
codes past whitespace and invalid chars + 4->3 repack. The branchy tail
(< 4 chars, padding checks, the last-chunk modes) stays on the host
(``simdutf_tpu_torch.impl.b64_finish``).

Device outputs of a decode, each equal to the JAX package's on the same
padded buffer (0-d int64 tensors for the scalars):
  first_bad     - index of the first invalid char (BIG when none)
  nvalid        - number of alphabet chars
  nvalid_at_bad - alphabet chars strictly before first_bad; with no
                  invalid char, those before the last buffer element
  packed        - u8[3N/4], the decoded bytes of the dense code stream
  tail_vals     - u8[4], codes nfull .. nfull+3 (nfull = nvalid & ~3)
  tail_start    - source index of the kept char of rank nfull, or length
                  when nvalid == nfull

``alphabet_for`` (a device-resident encode alphabet) is not ported: the
JAX package has no caller for it, and the encode kernel maps values to
chars by compares.
"""

from __future__ import annotations

import torch

from .. import trace
from ..kernels import base64_kernel as kb
from ..kernels import compact64 as kc64
from .common import BIG, excl_scan, positions, scatter_writes, units_i32


def classify_chars(c: torch.Tensor, url: bool, both: bool) -> torch.Tensor:
    """int32 char values in [0, 255] -> 0..63 alphabet value, 64 ASCII
    space, 255 invalid (simdutf_tpu/ops/base64_ops.classify_chars)."""
    v = torch.full_like(c, 255)
    v = torch.where((c >= 65) & (c <= 90), c - 65, v)  # A-Z
    v = torch.where((c >= 97) & (c <= 122), c - 71, v)  # a-z
    v = torch.where((c >= 48) & (c <= 57), c + 4, v)  # 0-9
    if both or not url:
        v = torch.where(c == 43, 62, v)  # '+'
        v = torch.where(c == 47, 63, v)  # '/'
    if both or url:
        v = torch.where(c == 45, 62, v)  # '-'
        v = torch.where(c == 95, 63, v)  # '_'
    for sp in (32, 9, 10, 13, 12):
        v = torch.where(c == sp, 64, v)
    return v


def char_codes(chars: torch.Tensor, url: bool, both: bool) -> torch.Tensor:
    """uint8 chars, or uint16 char16 units, -> int32 codes; a unit above
    0xFF is invalid."""
    if chars.dtype == torch.uint16:
        c = units_i32(chars)
        return torch.where(c > 0xFF, 255, classify_chars(c, url, both))
    return classify_chars(chars.to(torch.int32), url, both)


def compact_plain(chars: torch.Tensor, length: int, url: bool, both: bool):
    """Exclusive scan + scatter of the alphabet codes (base64_ops.py:96-132
    of the JAX package), in the contract of kernels/compact64.compact_codes:
    (codes u8[N] dense, zero past nvalid; nvalid; first_bad; nvalid_at_bad,
    0 when no char is invalid; tail_start). The buffer is not empty."""
    n = chars.shape[0]
    dev = chars.device
    idx = positions(n, dev)
    in_r = idx < length
    codes = char_codes(chars, url, both)
    valid = (codes <= 63) & in_r
    invalid = (codes > 64) & in_r
    big = torch.full_like(idx, BIG)
    first_bad = torch.where(invalid, idx, big).min()
    rank, rank_inc = excl_scan(valid.to(torch.int64))
    nvalid = rank_inc[-1]
    vals = scatter_writes(n, [(valid, rank, codes)], dev).to(torch.uint8)
    nvalid_at_bad = torch.where(
        first_bad < BIG, rank[torch.clamp(first_bad, max=n - 1)], 0)
    nfull = nvalid // 4 * 4
    hit = valid & (rank == nfull)
    tail_start = torch.where(nvalid > nfull, torch.where(hit, idx, big).min(),
                             length)
    return vals, nvalid, first_bad, nvalid_at_bad, tail_start


def sextets_to_bytes(vals_u8: torch.Tensor, n: int) -> torch.Tensor:
    """u8[n] compacted sextet values (n % 4 == 0; zeros beyond the valid
    prefix) -> u8[3n/4] decoded bytes, by the 4->3 repack kernel
    (kernels/base64_kernel.pack). The JAX package packs through (R, 512)
    word planes to keep TPU layouts unpadded; a flat byte stream has no
    such hazard here."""
    return kb.pack(vals_u8[:n])


def _finish(chars, length: int, url: bool, both: bool, compacted):
    """The decode outputs from a compaction's (codes, nvalid, first_bad,
    nvalid_at_bad, tail_start)."""
    codes, nvalid, first_bad, nab_ev, tail_start = compacted
    n = chars.shape[0]
    packed = sextets_to_bytes(codes, n)
    nfull = nvalid // 4 * 4
    tail_vals = codes[torch.clamp(nfull + positions(4, chars.device), max=n - 1)]
    # with no invalid char the JAX scatter engine reads rank[n-1]: nvalid
    # less the last buffer element's own validity (in range only when
    # length == n)
    last_valid = 0
    if length == n:
        last_valid = (char_codes(chars[n - 1:], url, both)[0] <= 63).to(torch.int64)
    nvalid_at_bad = torch.where(first_bad < BIG, nab_ev, nvalid - last_valid)
    return first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start


def _check(chars: torch.Tensor, length: int) -> int:
    n = chars.shape[0]
    if n == 0 or n % 4:
        raise ValueError(f"decode needs a non-empty buffer of 4k chars, got {n}")
    if not 0 <= int(length) <= n:
        raise ValueError(f"length {length} outside [0, {n}]")
    return int(length)


def decode_bulk(chars: torch.Tensor, length, url: bool, both: bool):
    """The plain formulation: scan + scatter compaction, then the repack.
    chars: padded uint8[N] (N % 4 == 0) or uint16 for char16 input."""
    length = _check(chars, length)
    return _finish(chars, length, url, both,
                   compact_plain(chars, length, url, both))


@trace.route
def decode_bulk_routed(chars: torch.Tensor, length, url: bool, both: bool):
    """The port's device route: the compaction kernel
    (kernels/compact64.compact_codes) for uint8 and uint16 chars at every
    buffer size, then the repack kernel. Invalid chars and dense
    whitespace need no fallback: the kernel's result is exact on every
    input. Outputs equal :func:`decode_bulk`'s."""
    length = _check(chars, length)
    return _finish(chars, length, url, both,
                   kc64.compact_codes(chars, length, url, both))


def encode_small(data: torch.Tensor, url: bool) -> torch.Tensor:
    """3->4 encode of uint8[N] (N % 3 == 0) as plain torch ops: the JAX
    package's minor-dim form, which is the encode kernel's plain version
    (kernels/base64_kernel.encode_ref)."""
    return kb.encode_ref(data, url)


@trace.route
def encode_bulk(data: torch.Tensor, url: bool) -> torch.Tensor:
    """data: padded uint8[N] with N % 3 == 0. Encodes whole 3-byte groups
    (the caller appends the <= 2-byte tail and padding on the host).
    Returns u8[4N/3], by the encode kernel (kernels/base64_kernel.encode)
    at every size: the JAX package sends buffers that are not
    1536-aligned to :func:`encode_small` only to keep TPU layouts
    unpadded."""
    return kb.encode(data, url)
