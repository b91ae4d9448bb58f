"""UTF-16 first-error, count and well-formed kernels.

Port of simdutf_tpu/kernels/utf16_kernels.py: ``utf16_first_bad`` (Pallas
``_utf16_kernel``), ``utf16_reduce`` (``_count16_kernel``, modes "count"
and "utf8len") and ``utf16_to_well_formed`` (``_wf_kernel``). On a CUDA
tensor the wrappers launch ``utf16_first_bad`` / ``utf16_count`` /
``utf16_to_well_formed`` (csrc/utf16.cu); on a CPU tensor they run the
plain versions beside them.

The first-bad and count kernels are streaming reads of the in-range
units, the well-formed kernel a read and a write of the whole buffer, so
their floor is HBM bytes; the reductions make one atomic update per warp.
Inputs are flat 1-D uint16 tensors with a length in units: the TPU's
(64 + R + 64, 256) layout with zero tiles fore and aft is not needed, and
the kernels take the length where the Pallas kernels rely on that zero
padding, so a unit stored at ``length`` never pairs with a high surrogate
at ``length - 1``.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG, bswap16, positions, to_u16, units_i32

_MODES = {"count": 0, "utf8len": 1}


def _mode(what: str) -> int:
    if what not in _MODES:
        raise ValueError(f"unknown count mode {what!r}")
    return _MODES[what]


def utf16_first_bad_ref(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """Plain version: ops/utf16.native + first_error. Returns the position
    of the first lone surrogate as a 0-d int64 tensor, BIG when valid."""
    from ..ops import utf16 as o16

    return o16.first_error(o16.native(w, length, be), length)


@trace.kernel
def utf16_first_bad(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """Least position in ``w[:length]`` of a high surrogate not followed by
    a low one or a low one not preceded by a high one (units byte-swapped
    when ``be``), as a 0-d int64 tensor on ``w``'s device; BIG when
    valid."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return utf16_first_bad_ref(w, length, be)
    out = torch.full((1,), BIG, dtype=torch.int64, device=w.device)
    _build.call("utf16_first_bad", w.data_ptr(), length, int(be), out.data_ptr())
    return out[0]


def utf16_reduce_ref(w: torch.Tensor, length: int, be: bool, what: str) -> torch.Tensor:
    """Plain version of the two modes, as a 0-d int64 tensor: "count" =
    code points (in-range units that are not low surrogates), "utf8len" =
    UTF-8 bytes in the scalar/utf16.h:80-94 form (each surrogate counts
    2)."""
    _mode(what)
    x = units_i32(w)
    if be:
        x = bswap16(x)
    in_r = positions(x.shape[0], x.device) < length
    if what == "count":
        return (((x & 0xFC00) != 0xDC00) & in_r).sum()
    part = in_r.sum() + ((x > 0x7F) & in_r).sum()
    wide = ((x > 0x7FF) & (x <= 0xD7FF)) | (x >= 0xE000)
    return part + (wide & in_r).sum()


@trace.kernel
def utf16_reduce(w: torch.Tensor, length: int, be: bool, what: str) -> torch.Tensor:
    """Count ``what`` ("count" or "utf8len") over ``w[:length]``, as a 0-d
    int64 tensor on ``w``'s device (see :func:`utf16_reduce_ref`)."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return utf16_reduce_ref(w, length, be, what)
    out = torch.zeros(1, dtype=torch.int64, device=w.device)
    _build.call("utf16_count", w.data_ptr(), length, int(be), _mode(what),
                out.data_ptr())
    return out[0]


def utf16_to_well_formed_ref(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """Plain version (the JAX package's ``ops/utf16.to_well_formed``): see
    :func:`utf16_to_well_formed`."""
    from ..ops import utf16 as o16

    bad = o16.lone_surrogates(o16._native16(w, be), length)
    return to_u16(torch.where(bad, 0xFDFF if be else 0xFFFD, units_i32(w)))


@trace.kernel
def utf16_to_well_formed(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """``w`` (units byte-swapped when ``be``) with every lone surrogate of
    ``w[:length]`` (a high one not followed by a low one below the
    length, or a low one not preceded by a high one) replaced by U+FFFD in
    the same byte order, as a new uint16 tensor of ``w``'s size on ``w``'s
    device; units at/after ``length`` keep their stored value."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return utf16_to_well_formed_ref(w, length, be)
    n = w.shape[0]
    out = torch.empty(n, dtype=torch.int16, device=w.device).view(torch.uint16)
    if n:
        _build.call("utf16_to_well_formed", w.data_ptr(), n, length, int(be),
                    out.data_ptr())
    return out
