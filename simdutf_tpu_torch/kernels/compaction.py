"""Stable per-row compaction by a keep mask.

Port of simdutf_tpu/kernels/compaction.py's ``row_compact_pallas`` (Pallas
``_compact_kernel``, math ``_row_compact``): ``out[r, j]`` is the j-th kept
value of row r, 0 beyond the row's count, and ``counts[r]`` the number
kept. The TPU forms it by a Hillis-Steele scan and a binary search of lane
gathers, limited on Mosaic to 128-lane rows; on a CUDA tensor
:func:`row_compact` launches ``row_compact`` (csrc/compaction.cu, a
block-wide scan per row, any power-of-two width), on a CPU tensor it runs
:func:`row_compact_ref`. The JAX package keeps the primitive for
``internal_tests`` (``lane_compaction``) and its own tests; so does the
port (``kernels.impl.TorchPallasImplementation.internal_tests``).
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace


def _check(val: torch.Tensor, keep: torch.Tensor):
    """(val, keep) as contiguous (R, W) int32 tensors on one device; W
    must be a power of two, as the Pallas function requires."""
    if val.dim() != 2 or keep.shape != val.shape:
        raise ValueError(f"val and keep must be (R, W) alike, got "
                         f"{tuple(val.shape)} and {tuple(keep.shape)}")
    width = val.shape[1]
    if width < 1 or width & (width - 1):
        raise ValueError(f"row width {width} must be a power of two")
    if keep.device != val.device:
        raise ValueError(f"val on {val.device}, keep on {keep.device}")
    return (val.to(torch.int32).contiguous(),
            keep.to(torch.int32).contiguous())


def row_compact_ref(val: torch.Tensor, keep: torch.Tensor):
    """Plain version of :func:`row_compact`."""
    val, keep = _check(val, keep)
    rows, width = val.shape
    k = keep != 0
    slot = torch.where(k, k.to(torch.int64).cumsum(1) - 1, width)
    out = torch.zeros(rows, width + 1, dtype=torch.int32, device=val.device)
    out.scatter_(1, slot, val)  # dropped values all land in column W
    return out[:, :width].contiguous(), k.sum(1).to(torch.int32)


@trace.kernel
def row_compact(val: torch.Tensor, keep: torch.Tensor):
    """(val, keep): (R, W) int32 (keep any integer or bool; nonzero keeps),
    W a power of two, else ValueError. Returns (out (R, W) int32, counts
    (R,) int32): each row's kept values in order, then zeros."""
    val, keep = _check(val, keep)
    if val.device.type == "cpu":
        return row_compact_ref(val, keep)
    if val.device.type != "cuda" or val.device.index != torch.cuda.current_device():
        raise ValueError(f"unsupported device {val.device}")
    rows, width = val.shape
    out = torch.empty_like(val)
    counts = torch.empty(rows, dtype=torch.int32, device=val.device)
    if rows:
        _build.call("row_compact", val.data_ptr(), keep.data_ptr(), rows, width,
                    out.data_ptr(), counts.data_ptr())
    return out, counts
