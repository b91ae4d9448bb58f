"""UTF-8, ASCII and UTF-32 first-error and count kernels.

Port of simdutf_tpu/kernels/validate.py: ``utf8_first_event_len`` and
``utf8_first_event`` (Pallas ``_utf8_kernel_len`` / ``_utf8_kernel``),
``ascii_first_bad`` (``_ascii_kernel``), the ``_count_call`` family
(``_count_kernel``: ``utf8_count``, ``utf8_utf16_length``,
``latin1_utf8_length``), ``utf32_first_bad`` (``_utf32_validate_kernel``)
and ``utf32_count`` (``_utf32_len_kernel``, the JAX ``utf32_reduce``). On
a CUDA tensor the wrappers launch ``utf8_first_event`` /
``ascii_first_bad`` / ``utf8_count`` (csrc/validate.cu) or
``utf32_first_bad`` / ``utf32_count`` (csrc/utf32.cu); on a CPU tensor
they run the plain versions beside them.

Both Hopper kernels are streaming reads of the in-range bytes, so their
floor is HBM bytes; the count reaches it, the first-event kernel is bound
by its per-byte lattice work (PERF.md), whose chunks it counts on the
device while a profiler records (``trace.device_counter``). The TPU
kernels keep a running result in an output block across a sequential
grid; Hopper blocks run in no order, so each warp reduces its threads
and makes one atomic update (a 64-bit atomicMin on the key
pos << 8 | code, an atomicAdd on the count).

Inputs are flat 1-D uint8 tensors, or int32 tensors of UTF-32 words; the
TPU's (R + 64, 512) and (R, 512) row layouts are not needed here.

``lane_shapecast_probe`` computes the function of the inline probe kernel
of ``lane_shapecast_supported`` (csrc/probe.cu), for the port's
``internal_tests``; the port has no Mosaic toolchain to probe.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG, positions

_MODES = {"count": 0, "utf16": 1, "latin1": 2}
#: the trace's counts of the first-event kernel's 16-byte chunks: those in
#: range, and those that ran its exact event lattice (held a byte >= 0x80)
CHUNKS = "validate.chunks"
EXACT_CHUNKS = "validate.exact_chunks"


def utf8_first_event_len_ref(b: torch.Tensor, length: int):
    """Plain version: ops/utf8.classify + _first_error_from. Returns
    (pos, code) as 0-d int64 tensors, pos == BIG when valid."""
    from ..ops import utf8 as o8

    return o8._first_error_from(o8.classify(b, length), length)


def exact_chunks_ref(b: torch.Tensor, length: int) -> int:
    """The 16-byte chunks of ``b[:length]`` that hold a byte >= 0x80: those
    the first-event kernel runs its event lattice on."""
    high = torch.nonzero(b[:length] >= 0x80).flatten() // 16
    return int(torch.unique(high).numel())


@trace.kernel
def utf8_first_event_len(b: torch.Tensor, length: int):
    """Exact first UTF-8 error of ``b[:length]``; bytes at/after
    ``length`` read as zero, so a sequence cut at the length reports
    TOO_SHORT at its lead. Returns (pos, code) as 0-d int64 tensors on
    ``b``'s device; pos == BIG and code == 0 when valid. While a profiler
    records, counts the chunks in range and those that ran the event
    lattice (:data:`CHUNKS`, :data:`EXACT_CHUNKS`), the latter on the
    device; otherwise nothing is counted."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        if trace.recording():
            trace.count(CHUNKS, (length + 15) // 16)
            trace.count(EXACT_CHUNKS, exact_chunks_ref(b, length))
        return utf8_first_event_len_ref(b, length)
    key = torch.full((1,), BIG << 8, dtype=torch.int64, device=b.device)
    counter = trace.device_counter(EXACT_CHUNKS, b.device)
    if counter is not None:
        trace.count(CHUNKS, (length + 15) // 16)
        counter = counter.data_ptr()
    _build.call("utf8_first_event", b.data_ptr(), length, key.data_ptr(), counter)
    return key[0] >> 8, key[0] & 0xFF


def utf8_first_event(b: torch.Tensor):
    """:func:`utf8_first_event_len` over the whole buffer."""
    return utf8_first_event_len(b, b.shape[0])


def ascii_first_bad_ref(b: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version: the least index ``< length`` of a byte >= 0x80, as a
    0-d int64 tensor, BIG when there is none."""
    if b.numel() == 0:
        return torch.full((), BIG, dtype=torch.int64, device=b.device)
    idx = positions(b.shape[0], b.device)
    bad = (b >= 0x80) & (idx < length)
    return torch.where(bad, idx, torch.full_like(idx, BIG)).min()


@trace.kernel
def ascii_first_bad(b: torch.Tensor, length: int) -> torch.Tensor:
    """The first position of ``b[:length]`` whose byte is >= 0x80, as a
    0-d int64 tensor on ``b``'s device; BIG when every byte is ASCII.
    Bytes at/after ``length`` are ignored (the Pallas kernel takes no
    length and relies on a zero tail)."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return ascii_first_bad_ref(b, length)
    out = torch.full((1,), BIG, dtype=torch.int64, device=b.device)
    if length:
        _build.call("ascii_first_bad", b.data_ptr(), length, out.data_ptr())
    return out[0]


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
    return out[0]


@trace.kernel
def utf8_count(b: torch.Tensor, length: int) -> torch.Tensor:
    return _count_call(b, length, "count")


@trace.kernel
def utf8_utf16_length(b: torch.Tensor, length: int) -> torch.Tensor:
    return _count_call(b, length, "utf16")


@trace.kernel
def latin1_utf8_length(b: torch.Tensor, length: int) -> torch.Tensor:
    """utf8_length_from_latin1: length + count of high bytes."""
    return _count_call(b, length, "latin1")


# -- UTF-32: port of validate.utf32_first_bad (Pallas _utf32_validate_kernel)
# and validate.utf32_reduce (_utf32_len_kernel); csrc/utf32.cu ------------

_MODES32 = {"utf8len": 0, "utf16len": 1}


def _mode32(what: str) -> int:
    if what not in _MODES32:
        raise ValueError(f"unknown count mode {what!r}")
    return _MODES32[what]


def utf32_first_bad_ref(w: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version: ops/utf32.native + first_error. Returns the least
    invalid-word position as a 0-d int64 tensor, BIG when valid."""
    from ..ops import utf32 as o32

    return o32.first_error(o32.native(w, length), length)[0]


@trace.kernel
def utf32_first_bad(w: torch.Tensor, length: int) -> torch.Tensor:
    """Least index ``< length`` of a word above 0x10FFFF (a word >= 2^31,
    negative in ``w``'s int32, included) or in D800-DFFF, as a 0-d int64
    tensor on ``w``'s device; BIG when valid."""
    length = int(length)
    if _build.check_words(w, length) == "cpu":
        return utf32_first_bad_ref(w, length)
    out = torch.full((1,), BIG, dtype=torch.int64, device=w.device)
    _build.call("utf32_first_bad", w.data_ptr(), length, out.data_ptr())
    return out[0]


def utf32_count_ref(w: torch.Tensor, length: int, what: str) -> torch.Tensor:
    """Plain version of the two modes, as a 0-d int64 tensor: "utf8len" =
    UTF-8 bytes, "utf16len" = UTF-16 units of ``w[:length]``, by the
    scalar/utf32.h ladder (validate.py:510-520): a negative int32 word
    (>= 2^31 as uint32) counts above every threshold."""
    _mode32(what)
    x = w[:length]
    neg = x < 0
    n = (x > 0xFFFF) | neg
    if what == "utf8len":
        n = n.to(torch.int64) + ((x > 0x7F) | neg) + ((x > 0x7FF) | neg)
    return (x.shape[0] + n.sum()).to(torch.int64)


@trace.kernel
def utf32_count(w: torch.Tensor, length: int, what: str) -> torch.Tensor:
    """Count ``what`` ("utf8len" or "utf16len") over ``w[:length]``, as a
    0-d int64 tensor on ``w``'s device (see :func:`utf32_count_ref`)."""
    length = int(length)
    mode = _mode32(what)
    if _build.check_words(w, length) == "cpu":
        return utf32_count_ref(w, length, what)
    out = torch.zeros(1, dtype=torch.int64, device=w.device)
    _build.call("utf32_count", w.data_ptr(), length, mode, out.data_ptr())
    return out[0]


# -- the lane shape-cast probe: port of the inline kernel ``k`` of
# validate.lane_shapecast_supported; csrc/probe.cu -----------------------

def lane_shapecast_probe_ref(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Plain version of :func:`lane_shapecast_probe`."""
    q = (x.to(torch.int32) ^ salt).reshape(-1, 4)
    a = q[:, 0] ^ q[:, 3]
    b = q[:, 1] ^ q[:, 2]
    return torch.stack([a, b, a, b], dim=1).reshape(x.shape)


@trace.kernel
def lane_shapecast_probe(x: torch.Tensor, salt: int) -> torch.Tensor:
    """(R, C) int32, C % 4 == 0 -> (R, C) int32: ``x ^ salt``, then in each
    quad q0..q3 of a row the lanes ``q0 ^ q3, q1 ^ q2, q0 ^ q3, q1 ^ q2``
    (the probe's k=4 split, k=2 interleave and split, k=4 interleave; on
    its (64, 512) tile)."""
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] % 4 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous (R, 4k) int32 tensor, got "
                         f"{x.dtype}{tuple(x.shape)}")
    if _build.check_words(x.view(-1), x.numel()) == "cpu":
        return lane_shapecast_probe_ref(x, salt)
    if x.data_ptr() % 16:
        raise ValueError("lane_shapecast_probe needs a 16-byte aligned tensor")
    out = torch.empty_like(x)
    if x.numel():
        _build.call("lane_shapecast_probe", x.data_ptr(), x.numel() // 4, int(salt),
                    out.data_ptr())
    return out
