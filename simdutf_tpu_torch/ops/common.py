"""Shared tensor helpers (port of simdutf_tpu/ops/common.py).

Everything computes in int32/int64: this torch build has no CPU kernels
for shifts, compares, ``where``, ``index_put`` or ``min`` on uint16/uint32,
so unsigned dtypes appear only as ``.view()`` at the output boundary.
"""

from __future__ import annotations

import torch

#: sentinel for "no error" positions; exceeds any buffer index (the JAX
#: package's value, so positions compare equal across packages).
BIG = 2**31 - 1


def bswap16(w: torch.Tensor) -> torch.Tensor:
    """Byteswap the low 16 bits of each int32 element (UTF-16 BE<->LE)."""
    return ((w << 8) | (w >> 8)) & 0xFFFF


def shift_left(b: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = b[i+k], zero-filled past the end."""
    if k == 0:
        return b
    return torch.cat([b[k:], b.new_zeros(min(k, b.shape[0]))])[: b.shape[0]]


def shift_right(b: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = b[i-k], zero-filled before the start (look-back carry)."""
    if k == 0:
        return b
    return torch.cat([b.new_zeros(min(k, b.shape[0])), b[:-k]])[: b.shape[0]]


def positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def zero_tail(b: torch.Tensor, length: int) -> torch.Tensor:
    """Force elements at/after ``length`` to zero, so a padded tail reads
    like the reference's zero-padded last block."""
    idx = positions(b.shape[0], b.device)
    return torch.where(idx < length, b, torch.zeros_like(b))


def excl_scan(k: torch.Tensor):
    """Exclusive prefix sum of an int tensor -> (exclusive, inclusive),
    both int64."""
    inc = torch.cumsum(k, 0, dtype=torch.int64)
    return inc - k, inc


def scatter_writes(cap: int, writes, device) -> torch.Tensor:
    """Compaction scatter: out[off] = vals where mask, capacity ``cap``.
    Masked-off writes land in one extra slot past the capacity, which is
    sliced away. ``writes`` is a list of (mask, off, vals); returns int32."""
    out = torch.zeros(cap + 1, dtype=torch.int32, device=device)
    for mask, off, vals in writes:
        tgt = torch.where(mask, off, torch.full_like(off, cap))
        out.index_put_((tgt,), vals.to(torch.int32))
    return out[:cap]


def route(branches, default):
    """Host-side pick of the first branch whose predicate holds, else
    ``default``. ``branches`` = [(bool, fn), ...]; the predicates are
    Python bools, so the caller pays one device sync per call to read
    them (one ``.item()`` on the census bits), where the JAX package
    selects on the device with ``lax.switch``."""
    for pred, fn in branches:
        if pred:
            return fn()
    return default()


def to_u16(units: torch.Tensor) -> torch.Tensor:
    """int32 tensor of 16-bit unit values -> the same values as uint16
    (narrowed through int16, which every backend supports)."""
    return units.to(torch.int16).view(torch.uint16)
