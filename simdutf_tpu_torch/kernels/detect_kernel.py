"""Fused one-pass encoding detection.

Port of simdutf_tpu/kernels/detect_kernel.detect_fused (Pallas
``_detect_kernel``): the UTF-8, UTF-16LE and UTF-32LE validity of one byte
buffer from one read. On a CUDA tensor :func:`detect_fused` launches
``detect_encodings`` (csrc/detect.cu); on a CPU tensor it runs the plain
version, ops/detect's composition of the three first-error functions.

The Hopper kernel is a streaming read of the in-range bytes, so its floor
is HBM bytes; each warp reduces and makes one atomic update of the UTF-8
event key and of the two flags. The Pallas kernel takes the (R + 64, 512)
zero-padded layout and relies on its zero tail; this one takes a flat 1-D
uint8 tensor and the length, and ignores every byte past it. BOM sniffing
and the ``length % 2`` / ``length % 4`` gating stay with the caller.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG


def detect_fused_ref(b: torch.Tensor, length: int):
    """Plain version: ops/detect.detect_encodings_plain."""
    from ..ops import detect as odet

    return odet.detect_encodings_plain(b, length)


@trace.kernel
def detect_fused(b: torch.Tensor, length: int):
    """(utf8_ok, utf16le_ok, utf32le_ok) of ``b[:length]`` as 0-d int64
    tensors (1 or 0) on ``b``'s device: UTF-8 valid; no lone surrogate in
    the ``length // 2`` little-endian units; no word above 0x10FFFF or in
    D800-DFFF in the ``length // 4`` little-endian words."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return detect_fused_ref(b, length)
    key = torch.full((1,), BIG << 8, dtype=torch.int64, device=b.device)
    flags = torch.zeros(1, dtype=torch.int32, device=b.device)
    if length:
        _build.call("detect_encodings", b.data_ptr(), length, key.data_ptr(),
                    flags.data_ptr())
    f = flags[0].to(torch.int64)
    return ((key[0] == BIG << 8).to(torch.int64), 1 - (f & 1), 1 - (f >> 1 & 1))
