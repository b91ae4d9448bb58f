"""Whitespace compaction for forgiving base64 decode.

Port of simdutf_tpu/kernels/butterfly64.compact_codes (Pallas
``_phase_b64_kernel`` + phase C16's placement) with the decode's exact
contract, but not the same algorithm: on a CUDA tensor
:func:`compact_codes` launches the count pass and the emit pass of
csrc/base64.cu with the glue of ops/common.tile_glue between them, as
compose8 does; on a CPU tensor it runs :func:`compact_codes_ref`.

The TPU kernel compacts each 32 KiB tile with butterfly rounds because its
scatter serialised, and bounds how many tile segments an output window
may span (``cand_ok``), so all-whitespace stretches send the JAX caller
to its scatter engine. Here a block scan gives every alphabet char its
slot, the codes are staged in shared memory, and each tile writes one
contiguous run: no bound, no fallback, one result for every input. Tiles
are 4096 chars (256 threads x 16), uint8 or uint16 (char16) chars, with
no alignment demand on the buffer size: the ragged last tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import BIG, tile_glue

TILE = 4096  # chars per block; = TILE in csrc/base64.cu


def compact_codes_ref(chars: torch.Tensor, length: int, url: bool, both: bool):
    """Plain version (ops/base64_ops' scan -> scatter). See
    :func:`compact_codes`."""
    from ..ops import base64_ops as ob

    return ob.compact_plain(chars, length, url, both)


def compact_codes(chars: torch.Tensor, length: int, url: bool, both: bool):
    """Compact the alphabet codes of ``chars[:length]`` (uint8, or uint16
    char16 units; not empty). Returns (codes uint8[N], nvalid, first_bad,
    nvalid_at_bad, tail_start), the scalars as 0-d int64 tensors on
    ``chars``' device:

    * ``codes``: the 0..63 code of every alphabet char in order, those
      after an invalid char too, zero past ``nvalid``;
    * ``first_bad``: index of the first invalid char (BIG if none);
    * ``nvalid_at_bad``: alphabet chars before it (0 if none);
    * ``tail_start``: source index of the kept char of rank
      ``nvalid & ~3``, or ``length`` when ``nvalid`` is a multiple of 4.
    """
    length = int(length)
    wide = chars.dtype == torch.uint16
    check = _build.check_units if wide else _build.check_bytes
    n = chars.shape[0]
    if n == 0:
        raise ValueError("compact_codes needs a non-empty buffer")
    if check(chars, length) == "cpu":
        return compact_codes_ref(chars, length, url, both)
    dev = chars.device
    codes = torch.zeros(n, dtype=torch.uint8, device=dev)
    tail_start = torch.full((), length, dtype=torch.int64, device=dev)
    nt = -(-length // TILE)
    if nt == 0:  # nothing in range: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return codes, z, z + BIG, z, tail_start
    kind = "16" if wide else "8"
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call(f"b64_compact{kind}_count", chars.data_ptr(), length, int(url),
                int(both), nt, counts.data_ptr(), keys.data_ptr(),
                prefix.data_ptr())

    off, nvalid, _, first_bad, _, nvalid_at_bad, _ = tile_glue(counts, keys, prefix)

    _build.call(f"b64_compact{kind}_emit", chars.data_ptr(), length, int(url),
                int(both), nt, off.data_ptr(), nvalid.data_ptr(),
                codes.data_ptr(), tail_start.data_ptr())
    _build.count_launch("b64_compact")
    return codes, nvalid, first_bad, nvalid_at_bad, tail_start
