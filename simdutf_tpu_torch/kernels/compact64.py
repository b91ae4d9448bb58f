"""Whitespace compaction for forgiving base64 decode.

Port of simdutf_tpu/kernels/butterfly64.compact_codes (Pallas
``_phase_b64_kernel`` + phase C16's placement) with the decode's exact
contract, but not the same algorithm: on a CUDA tensor
:func:`compact_codes` makes one launch of csrc/base64.cu's compaction
kernel (uint8 or char16 chars), a single pass with a decoupled look-back
scan across tiles (csrc/lookback.cuh) that also writes the zeros past
nvalid and the four scalars; on a CPU tensor it runs
:func:`compact_codes_ref`.

The TPU kernel compacts each 32 KiB tile with butterfly rounds because its
scatter serialised, and bounds how many tile segments an output window
may span (``cand_ok``), so all-whitespace stretches send the JAX caller
to its scatter engine. Here each char is read and classified once through
a shared table, a block scan gives every alphabet char its slot, the codes
are staged in shared memory, and each tile writes one contiguous run at
the offset its look-back finds: no bound, no fallback, one result for
every input. Tiles are 16384 chars (256 threads x 64), with no alignment
demand on the buffer size: the ragged last tile is masked. ``tail_start``
needs the total, so the last tile walks back over the per-tile counts to
the tile holding the kept char of rank ``nvalid & ~3``.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG

TILE = 16384  # chars per tile; = TILE in csrc/base64.cu


def compact_codes_ref(chars: torch.Tensor, length: int, url: bool, both: bool):
    """Plain version (ops/base64_ops' scan -> scatter). See
    :func:`compact_codes`."""
    from ..ops import base64_ops as ob

    return ob.compact_plain(chars, length, url, both)


@trace.kernel
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
    if length == 0:  # nothing in range: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return torch.zeros(n, dtype=torch.uint8, device=dev), z, z + BIG, z, z
    nt = -(-length // TILE)
    codes = torch.empty(n, dtype=torch.uint8, device=dev)
    res = torch.empty(4, dtype=torch.int64, device=dev)
    scratch = _build.lookback_scratch(nt, dev)
    _build.call("b64_compact16" if wide else "b64_compact8", chars.data_ptr(),
                n, length, int(url), int(both), nt, scratch.data_ptr(),
                codes.data_ptr(), res.data_ptr())
    return codes, res[0], res[1], res[2], res[3]
