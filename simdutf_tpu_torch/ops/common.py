"""Shared tensor helpers (port of simdutf_tpu/ops/common.py).

Everything computes in int32/int64: this torch build has no CPU kernels
for shifts, compares, ``where``, ``index_put`` or ``min`` on uint16/uint32,
so unsigned dtypes appear only as ``.view()`` at the output boundary.
"""

from __future__ import annotations

import torch

from .. import trace

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


def scalar(x: int, device) -> torch.Tensor:
    """``x`` as a 0-d int64 tensor on ``device``."""
    return torch.full((), x, dtype=torch.int64, device=device)


def count_before(off: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``off[pos]`` of an exclusive scan, the output before an error at
    ``pos``, as a 0-d int64 tensor; 0 when ``pos`` is BIG (no error) and
    for an empty scan. ``off[0] == 0``, so ``pos == 0`` needs no case."""
    n = off.shape[0]
    if n == 0:
        return scalar(0, off.device)
    at = off.index_select(0, pos.clamp(max=n - 1).view(1))[0]
    return torch.where(pos == BIG, 0, at)


def bytes_out(by: torch.Tensor, count: int, size: int) -> torch.Tensor:
    """int32 byte values -> uint8[size]: the first ``count`` of ``by``,
    zero after them."""
    idx = positions(by.shape[0], by.device)
    by = torch.where(idx < count, by & 0xFF, torch.zeros_like(by))
    out = torch.zeros(size, dtype=torch.uint8, device=by.device)
    out[: by.shape[0]] = by.to(torch.uint8)
    return out


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


def _fast(facts, fast):
    """(out, count) of the first fast branch whose census fact holds, else
    None. The facts are Python bools from the census's one read (one
    ``trace.sync`` a call), where the JAX package selects on the device
    with ``lax.switch``."""
    for fact, branch in zip(facts, fast):
        if fact:
            return branch()
    return None


def routed(facts, fast, compose, length: int):
    """A validating census-routed transcode: the first of ``fast`` whose
    fact in ``facts`` holds, else ``compose``. Each fast branch returns
    (out, count as a Python int) on a class its fact proves valid;
    ``compose`` returns a compose kernel's (out, total, err_any, err_pos,
    err_code, err_len), whose error lies in range and which reports
    err_code 0 and err_pos BIG where err_any is False. Returns (err_code,
    err_pos, out, out_len), the scalars 0-d int64 tensors on ``out``'s
    device: err_pos is ``length`` and out_len the total where there is no
    error."""
    hit = _fast(facts, fast)
    if hit is not None:
        out, count = hit
        dev = out.device
        return scalar(0, dev), scalar(length, dev), out, scalar(count, dev)
    out, total, err_any, err_pos, err_code, err_len = compose()
    # err_pos < length on error and BIG without: one op, where a ``where``
    # against the int would fill a device tensor with it first
    return (err_code, err_pos.clamp(max=length), out,
            torch.where(err_any, err_len, total))


def routed_valid(facts, fast, compose):
    """A valid-only census-routed transcode, picked as :func:`routed`
    picks. Returns (out, out_len): a fast branch's count as a 0-d int64
    tensor, or the first two elements of ``compose()``."""
    hit = _fast(facts, fast)
    if hit is not None:
        out, count = hit
        return out, scalar(count, out.device)
    return compose()[:2]


@trace.spanned(trace.PREFIX + "passglue.tile_glue")
def tile_glue(counts: torch.Tensor, keys: torch.Tensor, prefix: torch.Tensor):
    """The glue between a compose kernel's count and emit passes, on the
    per-tile vectors (the JAX butterflies' own, as torch ops): each
    tile's output count, least event key ``pos << 8 | code`` (BIG << 8
    when none) and output before that event. Tile events are disjoint and
    increasing, so the least key is the first error, and the reporting
    tile's offset plus its prefix is the output before it. A layer of its
    own in the trace (span ``simdutf.passglue.tile_glue``), inside the
    kernel wrapper's span. Returns
    (off, total, err_any, err_pos, err_code, err_len, out_len), ``off``
    the exclusive per-tile offsets, the rest 0-d int64 tensors (err_any
    bool); ``out_len`` is err_len on error, else total."""
    inc = torch.cumsum(counts, 0, dtype=torch.int64)
    off = inc - counts
    total = inc[-1]
    # a 1-element index keeps the reads on the device: indexing with the
    # 0-d argmin would make torch read it back to the host first
    first = torch.argmin(keys).view(1)
    key = keys.index_select(0, first)[0]
    err_pos, err_code = key >> 8, key & 0xFF
    err_any = err_pos != BIG
    before = off.index_select(0, first) + prefix.index_select(0, first)
    err_len = torch.where(err_any, before[0], 0)
    out_len = torch.where(err_any, err_len, total)
    return off, total, err_any, err_pos, err_code, err_len, out_len


def units_i32(w: torch.Tensor) -> torch.Tensor:
    """uint16 tensor -> the same unit values as int32 (widened through
    int16, which every backend supports)."""
    return w.view(torch.int16).to(torch.int32) & 0xFFFF


def to_u16(units: torch.Tensor) -> torch.Tensor:
    """int32 tensor of 16-bit unit values -> the same values as uint16
    (narrowed through int16, which every backend supports)."""
    return units.to(torch.int16).view(torch.uint16)
