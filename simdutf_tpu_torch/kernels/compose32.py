"""General-path validating UTF-8 -> UTF-32 transcode.

Port of simdutf_tpu/kernels/butterfly32.to_utf32_compose (Pallas
``_phase_b32_kernel`` + ``_phase_c32_kernel``) with the contract of the
JAX package's final result, not of the butterfly alone: on a CUDA tensor
:func:`to_utf32_compose` launches the count pass and the emit pass of
csrc/compose32.cu, with ops/common.tile_glue between them; on a CPU tensor
it runs :func:`to_utf32_compose_ref`.

The butterfly returns ``err_any`` and its caller reruns the scatter engine
(ops/utf8._to_utf32_general) on any error; that engine writes the
mechanically decoded code point of every in-range lead, valid or not, and
does not zero the buffer past ``out_len``. This kernel gives that final
buffer in one pass: its emit pass writes every lead's word through
``total``. The traffic floor is HBM bytes (two reads of the input, one
write of the words). Tiles are 4 KiB (256 threads x 16 bytes), with no
alignment demand on the buffer size: the ragged last tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import BIG, tile_glue

TILE = 4096  # bytes per block; = TILE in csrc/compose32.cu


def to_utf32_compose_ref(b: torch.Tensor, length: int):
    """Plain version (ops/utf8's classify -> scan -> scatter engine), in
    the compose contract. See :func:`to_utf32_compose`."""
    from ..ops import utf8 as o8

    err_pos, err_code, out, total, err_len = o8._utf32_general_parts(b, length)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


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
    dev = b.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    nt = -(-length // TILE)
    if nt == 0:  # nothing in range: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out, z, z != 0, z + BIG, z, z
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call("compose32_count", b.data_ptr(), length, nt,
                counts.data_ptr(), keys.data_ptr(), prefix.data_ptr())

    off, total, err_any, err_pos, err_code, err_len, _ = tile_glue(
        counts, keys, prefix)

    _build.call("compose32_emit", b.data_ptr(), length, nt, off.data_ptr(),
                out.data_ptr())
    _build.count_launch("utf8_to_utf32_compose")
    return out, total, err_any, err_pos, err_code, err_len
