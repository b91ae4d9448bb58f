"""General-path validating UTF-8 -> UTF-16LE/BE transcode.

Port of simdutf_tpu/kernels/butterfly.to_utf16_compose (Pallas
``_phase_b_kernel`` + ``_phase_c_kernel``) with the same contract, but not
the same algorithm: on a CUDA tensor :func:`to_utf16_compose` launches the
count pass and the emit pass of csrc/compose16.cu, with the small glue
that the JAX to_utf16_compose runs between its two kernels, as torch ops
on the per-tile vectors; on a CPU tensor it runs
:func:`to_utf16_compose_ref`.

The traffic floor is HBM bytes (two reads of the input, one write of the
units); this first version sits well above it, bound by per-byte lattice
work (PERF.md). The TPU engine compacts each tile with roll/select
butterflies because scatters were slow on that chip; here a block-wide
scan gives every unit its slot, the units are staged in shared memory, and
each tile writes them as contiguous runs. Tiles are 4 KiB (256 threads x
16 bytes), with no alignment demand on the buffer size: the ragged last
tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import BIG, to_u16

TILE = 4096  # bytes per block; = TILE in csrc/compose16.cu


def to_utf16_compose_ref(b: torch.Tensor, length: int, big_endian: bool):
    """Plain version (ops/utf8's classify -> scan -> scatter engine), in
    the compose contract. See :func:`to_utf16_compose`."""
    from ..ops import utf8 as o8

    err_pos, err_code, out, total, err_len = o8._utf16_general_parts(
        b, length, big_endian)
    return to_u16(out), total, err_pos != BIG, err_pos, err_code, err_len


def to_utf16_compose(b: torch.Tensor, length: int, big_endian: bool):
    """Transcode ``b[:length]`` to UTF-16 (byte-swapped units when
    ``big_endian``). Returns (out uint16[N], total, err_any, err_pos,
    err_code, err_len), the scalars as 0-d tensors on ``b``'s device:

    * ``total``: units of the whole buffer (the output length if valid);
    * ``err_pos``/``err_code``: the exact first error (BIG and 0 if none);
    * ``err_len``: units of the valid prefix before the error (0 if none).

    ``out`` is zero at/after ``err_len`` on error and ``total`` if valid."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return to_utf16_compose_ref(b, length, big_endian)
    n = b.shape[0]
    dev = b.device
    out = torch.zeros(n, dtype=torch.int16, device=dev).view(torch.uint16)
    nt = -(-min(n, length + 1) // TILE)
    if nt == 0:  # empty buffer: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out, z, z != 0, z + BIG, z, z
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call("compose16_count", b.data_ptr(), n, length, nt,
                counts.data_ptr(), keys.data_ptr(), prefix.data_ptr())

    # glue on the nt-vectors (butterfly.to_utf16_compose's, as torch ops):
    # tile events are disjoint and increasing, so the least key is the
    # first error, and the reporting tile's offset + prefix the units
    # before it
    inc = torch.cumsum(counts, 0, dtype=torch.int64)
    off = inc - counts
    total = inc[-1]
    first = torch.argmin(keys)
    key = keys[first]
    err_pos, err_code = key >> 8, key & 0xFF
    err_any = err_pos != BIG
    err_len = torch.where(err_any, off[first] + prefix[first], 0)
    out_len = torch.where(err_any, err_len, total)

    _build.call("compose16_emit", b.data_ptr(), n, length, nt,
                int(big_endian), off.data_ptr(), out_len.data_ptr(),
                out.data_ptr())
    _build.count_launch("utf8_to_utf16_compose")
    return out, total, err_any, err_pos, err_code, err_len
