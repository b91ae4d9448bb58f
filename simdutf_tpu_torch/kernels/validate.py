"""UTF-8 first-error and count kernels.

Port of simdutf_tpu/kernels/validate.py: ``utf8_first_event_len`` and
``utf8_first_event`` (Pallas ``_utf8_kernel_len`` / ``_utf8_kernel``) and
the ``_count_call`` family (``_count_kernel``: ``utf8_count``,
``utf8_utf16_length``, ``latin1_utf8_length``). On a CUDA tensor the
wrappers launch ``utf8_first_event`` / ``utf8_count`` (csrc/validate.cu);
on a CPU tensor they run the plain versions beside them.

Both Hopper kernels are streaming reads of the in-range bytes, so their
floor is HBM bytes; the count reaches it, the first-event kernel is bound
by its per-byte lattice work (PERF.md). The TPU kernels keep a running
result in an output block across a sequential grid; Hopper blocks run in
no order, so each warp reduces its threads and makes one atomic update (a
64-bit atomicMin on the key pos << 8 | code, an atomicAdd on the count).

Inputs are flat 1-D uint8 tensors; the TPU's (R + 64, 512) row layout with
a zero halo row is not needed here.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import BIG, positions

_MODES = {"count": 0, "utf16": 1, "latin1": 2}


def utf8_first_event_len_ref(b: torch.Tensor, length: int):
    """Plain version: ops/utf8.classify + _first_error_from. Returns
    (pos, code) as 0-d int64 tensors, pos == BIG when valid."""
    from ..ops import utf8 as o8

    return o8._first_error_from(o8.classify(b, length), length)


def utf8_first_event_len(b: torch.Tensor, length: int):
    """Exact first UTF-8 error of ``b[:length]``; bytes at/after
    ``length`` read as zero, so a sequence cut at the length reports
    TOO_SHORT at its lead. Returns (pos, code) as 0-d int64 tensors on
    ``b``'s device; pos == BIG and code == 0 when valid."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return utf8_first_event_len_ref(b, length)
    key = torch.full((1,), BIG << 8, dtype=torch.int64, device=b.device)
    _build.call("utf8_first_event", b.data_ptr(), length, key.data_ptr())
    _build.count_launch("utf8_first_event")
    return key[0] >> 8, key[0] & 0xFF


def utf8_first_event(b: torch.Tensor):
    """:func:`utf8_first_event_len` over the whole buffer."""
    return utf8_first_event_len(b, b.shape[0])


def count_ref(b: torch.Tensor, length: int, what: str) -> torch.Tensor:
    """Plain version of the three count modes, as a 0-d int64 tensor:
    "count" = code points (non-continuation bytes), "utf16" = UTF-16
    units (+1 per byte >= 0xF0), "latin1" = UTF-8 bytes of Latin-1 input
    (+1 per byte >= 0x80)."""
    x = b.to(torch.int32)
    in_r = positions(x.shape[0], x.device) < length
    if what == "latin1":
        return (in_r.sum() + ((x >= 0x80) & in_r).sum()).to(torch.int64)
    part = (((x & 0xC0) != 0x80) & in_r).sum()
    if what == "utf16":
        part = part + ((x >= 0xF0) & in_r).sum()
    return part.to(torch.int64)


def _count_call(b: torch.Tensor, length: int, what: str) -> torch.Tensor:
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return count_ref(b, length, what)
    out = torch.zeros(1, dtype=torch.int64, device=b.device)
    _build.call("utf8_count", b.data_ptr(), length, _MODES[what],
                out.data_ptr())
    _build.count_launch("utf8_count")
    return out[0]


def utf8_count(b: torch.Tensor, length: int) -> torch.Tensor:
    return _count_call(b, length, "count")


def utf8_utf16_length(b: torch.Tensor, length: int) -> torch.Tensor:
    return _count_call(b, length, "utf16")


def latin1_utf8_length(b: torch.Tensor, length: int) -> torch.Tensor:
    """utf8_length_from_latin1: length + count of high bytes."""
    return _count_call(b, length, "latin1")
