"""Fused one-pass encoding detection on torch tensors (port of
simdutf_tpu/ops/detect.py).

The three validators share one read of the buffer: on a CUDA tensor
:func:`detect_encodings` launches the detect kernel
(kernels/detect_kernel.detect_fused); on a CPU tensor it runs
:func:`detect_encodings_plain`, the composition of the three plain
first-error functions. BOM sniffing stays on the host
(simdutf_tpu_torch.encodings.check_bom).
"""

from __future__ import annotations

import torch

from .. import trace
from ..kernels import detect_kernel as kdet
from . import utf8 as o8, utf16 as o16, utf32 as o32
from .common import BIG


def detect_encodings_plain(b: torch.Tensor, length: int):
    """(utf8_ok, utf16le_ok, utf32le_ok) of ``b[:length]`` as 0-d int64
    tensors, from the plain first-error functions of ops/utf8, ops/utf16
    and ops/utf32; the caller masks by ``length % 2`` / ``% 4``."""
    n = b.shape[0]
    pos8, _ = o8._first_error_from(o8.classify(b, length), length)
    x = b.to(torch.int64)
    pr = x[: n // 2 * 2].view(-1, 2)
    pos16 = o16.first_error((pr[:, 0] | (pr[:, 1] << 8)).to(torch.int32), length // 2)
    q = x[: n // 4 * 4].view(-1, 4)
    words = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
    # the uint32 words' bits as int32, as ops/utf32 takes them
    pos32, _ = o32.first_error(words.to(torch.int32), length // 4)
    return tuple((p == BIG).to(torch.int64) for p in (pos8, pos16, pos32))


@trace.route
def detect_encodings(b: torch.Tensor, length: int):
    """(utf8_ok, utf16le_ok, utf32le_ok) of ``b[:length]`` as 0-d int64
    tensors: one launch of the detect kernel."""
    return kdet.detect_fused(b, length)
