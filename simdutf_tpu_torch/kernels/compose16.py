"""General-path validating UTF-8 -> UTF-16LE/BE transcode.

Port of simdutf_tpu/kernels/butterfly.to_utf16_compose (Pallas
``_phase_b_kernel`` + ``_phase_c_kernel``) with the same contract, but not
the same algorithm: on a CUDA tensor :func:`to_utf16_compose` makes one
launch of csrc/compose16.cu, a single pass with a decoupled look-back scan
across tiles (csrc/lookback.cuh) that also writes the zeros past out_len
and the five scalars; on a CPU tensor it runs :func:`to_utf16_compose_ref`.

The traffic floor is HBM bytes: one read of the input, one write of the
whole uint16 output. Each 16 KiB tile (256 threads x 64 bytes) is read
once, checked with a mask test that may flag valid text but never misses
an event (only a flagged tile computes the exact event keys), and its
units are staged in shared memory and stored as aligned 16-byte runs at
the offset its look-back finds. The TPU engine compacts each tile with
roll/select butterflies because scatters were slow on that chip. There is
no alignment demand on the buffer size: the ragged last tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG, positions, shift_right, to_u16

TILE = 16384  # bytes per tile; = TILE in csrc/compose16.cu
_NO_EVENT = BIG << 8
_TOO_LONG = 3


def to_utf16_compose_ref(b: torch.Tensor, length: int, big_endian: bool,
                         clamp: bool = True):
    """Plain version (ops/utf8's classify -> scan -> scatter engine), in
    the compose contract. See :func:`to_utf16_compose`."""
    from ..ops import utf8 as o8

    err_pos, err_code, out, total, err_len = o8._utf16_general_parts(
        b, length, big_endian, clamp)
    return to_u16(out), total, err_pos != BIG, err_pos, err_code, err_len


def _tiles(n: int, length: int) -> int:
    """Tiles of a call: the byte at ``length`` may carry a unit (the low
    surrogate of a 4-byte lead at ``length - 1``)."""
    return -(-min(n, length + 1) // TILE)


@trace.kernel
def to_utf16_compose(b: torch.Tensor, length: int, big_endian: bool,
                     clamp: bool = True):
    """Transcode ``b[:length]`` to UTF-16 (byte-swapped units when
    ``big_endian``). Returns (out uint16[N], total, err_any, err_pos,
    err_code, err_len), the scalars as 0-d tensors on ``b``'s device:

    * ``total``: units of the whole buffer (the output length if valid);
    * ``err_pos``/``err_code``: the exact first error (BIG and 0 if none);
    * ``err_len``: units of the valid prefix before the error (0 if none).

    With ``clamp``, ``out`` is zero at/after ``err_len`` on error and
    ``total`` if valid. Without it (the valid-only converters), every
    in-range lead writes its mechanically decoded unit(s), past the first
    error too, as the JAX package's ``to_utf16_valid`` does."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return to_utf16_compose_ref(b, length, big_endian, clamp)
    n = b.shape[0]
    if length == 0:  # nothing carries a unit: nothing to launch
        out = torch.zeros(n, dtype=torch.int16, device=b.device)
        return _build.nothing_in_range(out.view(torch.uint16))
    nt = _tiles(n, length)
    out = torch.empty(n, dtype=torch.int16, device=b.device).view(torch.uint16)
    return _build.lookback_compose("compose16", nt, out, b.data_ptr(), n, length, nt,
                                   int(big_endian), int(clamp))[0]


def event_keys_ref(b: torch.Tensor, length: int):
    """Plain event key (pos << 8 | code, BIG << 8 where none) of every byte
    of ``b`` under the event lattice of csrc/utf8.cuh (a bad lead reports
    its code at itself, a continuation that no lead among the three bytes
    before it covers reports TOO_LONG at itself), and ops/utf8.classify's
    dict of the bytes."""
    from ..ops import utf8 as o8

    n = b.shape[0]
    cls = o8.classify(b, length)
    idx = positions(n, b.device)
    seqlen = cls["seqlen"]
    covered = ((shift_right(seqlen, 1) > 1) | (shift_right(seqlen, 2) > 2)
               | (shift_right(seqlen, 3) > 3))
    code = torch.where(cls["is_cont"],
                       torch.where(covered, 0, _TOO_LONG), cls["err"])
    return torch.where((idx < length) & (code != 0), (idx << 8) | code, _NO_EVENT), cls


def tile_triples(keep: torch.Tensor, key: torch.Tensor, nt: int, tile: int):
    """Per tile of ``tile`` bytes, the first ``nt``: (marked bytes, least
    key, marked bytes before that key's position; BIG << 8 and the tile's
    marked bytes when it has no event), each an int64 tensor."""
    n = keep.shape[0]
    idx = positions(n, keep.device)

    def tiled(x, fill):
        pad = nt * tile - n
        x = torch.cat([x, x.new_full((max(pad, 0),), fill)])[: nt * tile]
        return x.view(nt, tile)

    keep_t = tiled(keep.to(torch.int64), 0)
    kmin = tiled(key, _NO_EVENT).min(dim=1).values
    before = (keep_t * (tiled(idx, BIG) < (kmin >> 8).unsqueeze(1))).sum(dim=1)
    return keep_t.sum(dim=1), kmin, before


def tile_aggregates_ref(b: torch.Tensor, length: int):
    """Plain per-tile (units, least event key pos << 8 | code, units before
    that key; BIG << 8 and the tile's units when it has no event) of the
    tiles of a call, each an int64 tensor, from :func:`event_keys_ref`'s
    lattice."""
    key, cls = event_keys_ref(b, length)
    keep = ((positions(b.shape[0], b.device) < length) & ~cls["is_cont"]) | shift_right(
        cls["lead4"], 1)
    return tile_triples(keep, key, _tiles(b.shape[0], length), TILE)


def _tile_aggregates(b: torch.Tensor, length: int):
    """The per-tile aggregates the kernel publishes for its look-back, as
    (count, key, before) int64 tensors, for tests: on a CUDA tensor read
    from the launch's scratch (a tile the fast check passes publishes no
    event, so each key equals :func:`tile_aggregates_ref`'s only if the
    check misses no event), on a CPU tensor the plain version's."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu" or length == 0:
        return tile_aggregates_ref(b, length)
    n = b.shape[0]
    nt = _tiles(n, length)
    out = torch.empty(n, dtype=torch.int16, device=b.device)
    _, scratch = _build.lookback_compose("compose16", nt, out, b.data_ptr(), n, length,
                                         nt, 0, 1)
    return published_aggregates(scratch, nt)


def published_aggregates(scratch: torch.Tensor, nt: int):
    """(count, key, before) int64 tensors of the ``nt`` aggregate slots of
    a look-back scratch (csrc/lookback.cuh: count | (before | 2^31) << 32,
    then key | 2^63)."""
    slots = scratch[16: 16 + 16 * nt].view(torch.int64).view(nt, 2)
    lo, hi = slots[:, 0], slots[:, 1]
    return lo & 0x7FFFFFFF, hi & (2**63 - 1), (lo >> 32) & 0x7FFFFFFF


def tile_flags_ref(b: torch.Tensor, length: int, tile: int = TILE):
    """Plain version of csrc/compose16.cu's fast check, per byte where the
    kernel works on words: bool per tile (of ``tile`` bytes), True where
    the check flags. A tile flags when a byte of it or of the four after it
    fails the structural test (a byte is a continuation exactly when a lead
    one, two or three bytes before asks for one) or a value test (F8-FF;
    C0/C1; F5-F7; E0, ED, F0, F4 against the next byte's bits 5 and 4), or
    when one of the four bytes before it is F8-FF. It may flag valid text;
    it must flag every tile that holds an event of
    :func:`tile_aggregates_ref`'s lattice."""
    n = b.shape[0]
    nt = -(-min(n, length + 1) // tile)
    x = torch.zeros(nt * tile + 8, dtype=torch.int32, device=b.device)
    m = min(n, length)
    x[4: 4 + m] = b[:m].to(torch.int32)  # 4 zero bytes before position 0
    cont = (x & 0xC0) == 0x80
    lead, l3, l4, l5 = x >= 0xC0, x >= 0xE0, x >= 0xF0, x >= 0xF8
    lo = x & 0x0F
    need = shift_right(lead, 1) | shift_right(l3, 2) | shift_right(l4, 3)
    err = (need ^ cont) | l5 | (lead & ~l3 & ((x & 0x1E) == 0))
    err |= l4 & ~l5 & ((x & 7) >= 5)
    b5, b54 = (x & 0x20) != 0, (x & 0x30) != 0
    err |= shift_right(l3 & ~l4 & (lo == 0), 1) & ~b5
    err |= shift_right(l3 & ~l4 & (lo == 0xD), 1) & b5
    err |= shift_right(l4 & ~l5 & (lo == 0), 1) & ~b54
    err |= shift_right(l4 & ~l5 & (lo == 4), 1) & b54
    # tile k covers x[4 + k*tile, 4 + (k+1)*tile); it looks at errors in
    # [start, end + 4) and at F8-FF in [start - 4, start)
    e = err.to(torch.int32)
    win = torch.cumsum(torch.cat([e.new_zeros(1), e]), 0)
    f5 = torch.cumsum(torch.cat([e.new_zeros(1), l5.to(torch.int32)]), 0)
    start = 4 + tile * torch.arange(nt, device=b.device)
    flag = (win[start + tile + 4] - win[start]) > 0
    return flag | ((f5[start] - f5[start - 4]) > 0)
