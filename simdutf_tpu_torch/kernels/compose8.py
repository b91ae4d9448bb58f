"""General-path UTF-16LE/BE -> UTF-8 transcode, validating or valid-only.

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

In the validating mode ``total`` follows the butterfly's accounting:
every in-range surrogate emits 2 bytes, paired or not, so ``total`` equals
the "utf8len" count of kernels/utf16_kernels on every input, valid or not.
The valid-only mode follows the JAX package's ``convert_valid`` engine
(simdutf_tpu/ops/utf16.to_utf8_valid) on every input: a high surrogate
makes a code point with whatever unit follows it (0 past the length), a
low surrogate writes nothing, and nothing is clamped but the buffer's end.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG, tile_glue

TILE = 2048  # units per block; = TILE in csrc/compose8.cu
_MODES = {"validate": 0, "valid": 1}


def _mode(mode: str) -> int:
    if mode not in _MODES:
        raise ValueError(f"unknown compose mode {mode!r}")
    return _MODES[mode]


def to_utf8_compose_ref(w: torch.Tensor, length: int, be: bool,
                        mode: str = "validate"):
    """Plain version (ops/utf16's scan -> scatter engines: the butterfly's
    accounting, or the valid-only one), in the compose contract. See
    :func:`to_utf8_compose`."""
    from ..ops import utf16 as o16

    if _mode(mode):
        out, total = o16._utf8_valid_parts(w, length, be)
        z = torch.zeros((), dtype=torch.int64, device=w.device)
        return out, total, z != 0, z + BIG, z, z
    err_pos, err_code, out, total, err_len = o16._utf8_general_parts(
        w, length, be)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


@trace.kernel
def to_utf8_compose(w: torch.Tensor, length: int, be: bool,
                    mode: str = "validate"):
    """Transcode ``w[:length]`` (units byte-swapped when ``be``) to UTF-8.
    Returns (out uint8[3N], total, err_any, err_pos, err_code, err_len),
    the scalars as 0-d int64 tensors (err_any bool) on ``w``'s device.

    ``mode="validate"``:

    * ``total``: bytes of the whole buffer, 2 per surrogate (the output
      length if valid);
    * ``err_pos``/``err_code``: the first lone surrogate and SURROGATE
      (BIG and 0 if none);
    * ``err_len``: bytes of the valid prefix before the error (0 if none);
    * ``out`` is zero at/after ``err_len`` on error and ``total`` if valid.

    ``mode="valid"``: ``total`` and ``out`` are those of the JAX
    package's valid-only engine on any input (``total`` may exceed 3N,
    and ``out`` then holds its first 3N bytes); no error is reported
    (err_any False, err_pos BIG, err_code and err_len 0)."""
    length = int(length)
    valid = _mode(mode)
    if _build.check_units(w, length) == "cpu":
        return to_utf8_compose_ref(w, length, be, mode)
    n = w.shape[0]
    dev = w.device
    out = torch.zeros(3 * n, dtype=torch.uint8, device=dev)
    trace.count("compose.fill_bytes", out.nbytes)
    nt = -(-length // TILE)
    if nt == 0:  # nothing in range: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out, z, z != 0, z + BIG, z, z
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call("compose8_count", w.data_ptr(), length, int(be), valid, nt,
                counts.data_ptr(), keys.data_ptr(), prefix.data_ptr())

    off, total, err_any, err_pos, err_code, err_len, out_len = tile_glue(
        counts, keys, prefix)

    _build.call("compose8_emit", w.data_ptr(), length, int(be), valid, nt,
                off.data_ptr(), out_len.data_ptr(), 3 * n, out.data_ptr())
    return out, total, err_any, err_pos, err_code, err_len
