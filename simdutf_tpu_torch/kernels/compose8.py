"""General-path validating UTF-16LE/BE -> UTF-8 transcode.

Port of simdutf_tpu/kernels/butterfly16.to_utf8_compose (Pallas
``_phase_b16_kernel`` + ``_phase_c16_kernel``) with the same contract, but
not the same algorithm: on a CUDA tensor :func:`to_utf8_compose` launches
the count pass and the emit pass of csrc/compose8.cu, with the small glue
that the JAX to_utf8_compose runs between its two kernels, as torch ops on
the per-tile vectors; on a CPU tensor it runs :func:`to_utf8_compose_ref`.

The traffic floor is HBM bytes (two reads of the units, one write of the
output bytes). The TPU engine compacts four candidate byte planes per
tile with roll/select butterflies because scatters were slow on that
chip; here a block-wide scan gives every unit its output slot, the bytes
are staged in shared memory, and each tile writes them as contiguous
runs. Tiles are 2048 units (256 threads x 8 units), with no alignment
demand on the buffer size: the ragged last tile is masked.

``total`` follows the butterfly's accounting: every in-range surrogate
emits 2 bytes, paired or not, so ``total`` equals the "utf8len" count of
kernels/utf16_kernels on every input, valid or not.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import BIG, tile_glue

TILE = 2048  # units per block; = TILE in csrc/compose8.cu


def to_utf8_compose_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version (ops/utf16's scan -> scatter engine in the
    butterfly's accounting), in the compose contract. See
    :func:`to_utf8_compose`."""
    from ..ops import utf16 as o16

    err_pos, err_code, out, total, err_len = o16._utf8_general_parts(
        w, length, be)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


def to_utf8_compose(w: torch.Tensor, length: int, be: bool):
    """Transcode ``w[:length]`` (units byte-swapped when ``be``) to UTF-8.
    Returns (out uint8[3N], total, err_any, err_pos, err_code, err_len),
    the scalars as 0-d int64 tensors (err_any bool) on ``w``'s device:

    * ``total``: bytes of the whole buffer, 2 per surrogate (the output
      length if valid);
    * ``err_pos``/``err_code``: the first lone surrogate and SURROGATE
      (BIG and 0 if none);
    * ``err_len``: bytes of the valid prefix before the error (0 if none).

    ``out`` is zero at/after ``err_len`` on error and ``total`` if valid."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return to_utf8_compose_ref(w, length, be)
    n = w.shape[0]
    dev = w.device
    out = torch.zeros(3 * n, dtype=torch.uint8, device=dev)
    nt = -(-length // TILE)
    if nt == 0:  # nothing in range: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out, z, z != 0, z + BIG, z, z
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call("compose8_count", w.data_ptr(), length, int(be), nt,
                counts.data_ptr(), keys.data_ptr(), prefix.data_ptr())

    off, total, err_any, err_pos, err_code, err_len, out_len = tile_glue(
        counts, keys, prefix)

    _build.call("compose8_emit", w.data_ptr(), length, int(be), nt,
                off.data_ptr(), out_len.data_ptr(), out.data_ptr())
    _build.count_launch("utf16_to_utf8_compose")
    return out, total, err_any, err_pos, err_code, err_len
