"""General-path validating UTF-8 -> UTF-32 transcode.

Port of simdutf_tpu/kernels/butterfly32.to_utf32_compose (Pallas
``_phase_b32_kernel`` + ``_phase_c32_kernel``) with the contract of the
JAX package's final result, not of the butterfly alone: on a CUDA tensor
:func:`to_utf32_compose` makes one launch of csrc/compose32.cu, a single
pass with a decoupled look-back scan across tiles (csrc/lookback.cuh) that
also writes the zeros past the total and the five scalars; on a CPU
tensor it runs :func:`to_utf32_compose_ref`.

The butterfly returns ``err_any`` and its caller reruns the scatter engine
(ops/utf8._to_utf32_general) on any error; that engine writes the
mechanically decoded code point of every in-range lead, valid or not, and
does not zero the buffer past ``out_len``. This kernel gives that final
buffer in one pass: every lead writes its word through ``total``. The
traffic floor is HBM bytes (one read of the input, one write of the whole
int32 output); above it the kernel is bound by integer instructions a byte
and by its look-back's latency. Design: a block is eight data warps and
one look-back warp, three blocks a SM. Each 8 KiB tile (256 data threads x
32 bytes) is read once, into registers, while the previous tile is
stored; it is checked with compose16's mask test (csrc/utf8_tile.cuh; only
a flagged tile stages its bytes and computes exact event keys); each word
is decoded in the registers of the thread that owns its lead (a warp with
no 4-byte lead, on a tile the check passed, accumulates each sequence's
payload as its bytes go by; any other decodes each lead on its own) and
written once to one of two 32 KiB staging buffers; the look-back warp
finds the tile's offset while the data warps go on with the next tile, and
the words are then stored as aligned 16-byte runs, with the tile's share
of the zeros past the total. Words take 4 bytes a byte of shared memory,
so the tiles are half compose16's: 16 KiB tiles at one block a SM were
slower on the card, and 12 KiB tiles at two no faster (PERF.md). There is
no alignment demand on the buffer size: the ragged last tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from .compose16 import event_keys_ref, published_aggregates, tile_flags_ref, tile_triples
from ..ops.common import BIG, positions

TILE = 8192  # bytes per tile; = TILE in csrc/compose32.cu
WARPS = 8  # data warps a tile; = THREADS / 32 in csrc/compose32.cu


def to_utf32_compose_ref(b: torch.Tensor, length: int):
    """Plain version (ops/utf8's classify -> scan -> scatter engine), in
    the compose contract. See :func:`to_utf32_compose`."""
    from ..ops import utf8 as o8

    err_pos, err_code, out, total, err_len = o8._utf32_general_parts(b, length)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


def _tiles(length: int) -> int:
    """Tiles of a call: only in-range leads carry a word."""
    return -(-length // TILE)


@trace.kernel
def to_utf32_compose(b: torch.Tensor, length: int):
    """Transcode ``b[:length]`` to UTF-32. Returns (out int32[N], total,
    err_any, err_pos, err_code, err_len), the scalars as 0-d int64 tensors
    (err_any bool) on ``b``'s device:

    * ``out``: the code point of every in-range lead, in order (0 for
      F8..FF; a sequence cut short reads zero bytes), zero past ``total``;
    * ``total``: the leads of the whole buffer (the output length if
      valid);
    * ``err_pos``/``err_code``: the exact first error (BIG and 0 if none);
    * ``err_len``: the words before the error (0 if none)."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return to_utf32_compose_ref(b, length)
    n = b.shape[0]
    if length == 0:  # nothing in range: nothing to launch
        return _build.nothing_in_range(torch.zeros(n, dtype=torch.int32, device=b.device))
    return _launch("compose32", b, length)[0]


def _launch(entry: str, b: torch.Tensor, length: int, *extra):
    """One launch of C entry point ``entry`` (``compose32``, or
    ``compose32_grid`` with its grid cap in ``extra``) on a CUDA tensor
    with ``length`` > 0: the compose result and the look-back scratch."""
    n = b.shape[0]
    nt = _tiles(length)
    out = torch.empty(n, dtype=torch.int32, device=b.device)
    return _build.lookback_compose(entry, nt, out, b.data_ptr(), n, length, nt, *extra)


def _on_blocks(b: torch.Tensor, length: int, blocks: int):
    """:func:`to_utf32_compose` of a CUDA tensor with ``length`` > 0 on a
    grid of at most ``blocks`` blocks (0: as many as are resident at once),
    for tests: one block takes every tile in turn."""
    return _launch("compose32_grid", b, int(length), int(blocks))[0]


def tile_aggregates_ref(b: torch.Tensor, length: int):
    """Plain per-tile (words, least event key pos << 8 | code, words
    before that key; BIG << 8 and the tile's words when it has no event)
    of the tiles of a call, each an int64 tensor: a word for every
    in-range byte that is not a continuation, keys from compose16's
    ``event_keys_ref`` lattice."""
    key, cls = event_keys_ref(b, length)
    keep = (positions(b.shape[0], b.device) < length) & ~cls["is_cont"]
    return tile_triples(keep, key, _tiles(length), TILE)


def _tile_aggregates(b: torch.Tensor, length: int):
    """The per-tile aggregates the kernel publishes for its look-back, as
    (count, key, before) int64 tensors, for tests: on a CUDA tensor read
    from the launch's scratch, on a CPU tensor the plain version's."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu" or length == 0:
        return tile_aggregates_ref(b, length)
    return published_aggregates(_launch("compose32", b, length)[1], _tiles(length))


def tile_paths_ref(b: torch.Tensor, length: int) -> torch.Tensor:
    """Plain count, per tile of a call, of the data warps that take the
    accumulating decode, int64: none on a tile the fast check flags
    (compose16's ``tile_flags_ref``), else the warps with no in-range byte
    >= 0xF0 among their bytes and the byte before them."""
    nt = _tiles(length)
    m = min(b.shape[0], length)
    lead4 = torch.zeros(nt * TILE, dtype=torch.bool, device=b.device)
    lead4[:m] = b[:m] >= 0xF0
    per_warp = lead4.view(nt * WARPS, TILE // WARPS)
    held = per_warp.any(dim=1)
    held[1:] |= per_warp[:-1, -1]
    flagged = tile_flags_ref(b, length, TILE)[:nt]
    return torch.where(flagged, 0, (~held).view(nt, WARPS).sum(dim=1))


def _tile_paths(b: torch.Tensor, length: int) -> torch.Tensor:
    """The data warps of each tile that took the accumulating decode, as
    an int64 tensor, for tests: on a CUDA tensor read from the launch's
    scratch (each tile's first extra word, csrc/lookback.cuh), on a CPU
    tensor the plain version's."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu" or length == 0:
        return tile_paths_ref(b, length)
    nt = _tiles(length)
    scratch = _launch("compose32", b, length)[1]
    return scratch[16 + 32 * nt: 16 + 48 * nt].view(torch.int32).view(nt, 4)[:, 0].to(torch.int64)
