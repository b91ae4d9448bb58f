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
floor is HBM bytes. The first-event kernel screens each chunk with SWAR
flags that mark exactly the bytes its event lattice reports an event on
(:func:`screen_flags_ref` is their plain twin) and runs the lattice only
on the chunks they flag, which it counts on the device while a profiler
records (``trace.device_counter``). The TPU
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
#: range, and those that ran its exact event lattice (held a byte its
#: screen flagged)
CHUNKS = "validate.chunks"
EXACT_CHUNKS = "validate.exact_chunks"


def utf8_first_event_len_ref(b: torch.Tensor, length: int):
    """Plain version: ops/utf8.classify + _first_error_from. Returns
    (pos, code) as 0-d int64 tensors, pos == BIG when valid."""
    from ..ops import utf8 as o8

    return o8._first_error_from(o8.classify(b, length), length)


_M32 = 0xFFFFFFFF


def _leads(x: torch.Tensor):
    """Bit 7 of each byte of the 32-bit words ``x``: leads of 2-, 3- and
    4-byte sequences (C0..F7, E0..F7, F0..F7)."""
    c0 = x & (x << 1)
    e0 = c0 & (x << 2)
    f0 = e0 & (x << 3)
    f8 = f0 & (x << 4)
    return [(y & ~f8) & _M32 for y in (c0, e0, f0)]


def _funnel_l(lo: torch.Tensor, hi: torch.Tensor, s: int) -> torch.Tensor:
    """CUDA's __funnelshift_l: the high word of (hi:lo) << s."""
    return ((hi << s) | (lo >> (32 - s))) & _M32


def _funnel_r(lo: torch.Tensor, hi: torch.Tensor, s: int) -> torch.Tensor:
    """CUDA's __funnelshift_r: the low word of (hi:lo) >> s."""
    return ((lo >> s) | (hi << (32 - s))) & _M32


def screen_words_ref(x: torch.Tensor, xp: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """The first-event kernel's SWAR screen (csrc/validate.cu ``screen``),
    operation for operation on int64 tensors of 32-bit little-endian
    words ``x`` with the words before (``xp``) and after (``xn``) each:
    bit 7 of each byte set where su::event_key reports an event."""
    lp, lx = _leads(xp), _leads(x)
    cx = (x & ~(x << 1)) & _M32
    cn = (xn & ~(xn << 1)) & _M32
    covered = (_funnel_l(lp[0], lx[0], 8) | _funnel_l(lp[1], lx[1], 16)
               | _funnel_l(lp[2], lx[2], 24))
    orphan = cx & ~covered
    cut = ((lx[0] & ~_funnel_r(cx, cn, 8)) | (lx[1] & ~_funnel_r(cx, cn, 16))
           | (lx[2] & ~_funnel_r(cx, cn, 24)))
    s1, s2, s3 = x << 1, x << 2, x << 3
    c0c1 = x & s1 & ~s2 & ~((x & 0x1E1E1E1E) + 0x7F7F7F7F)
    x1 = _funnel_r(x, xn, 8)
    barred = ((x1 >> 5) & 0x01010101) * 0x0D
    bad3 = x & s1 & s2 & ~s3 & ~(((x ^ barred) & 0x0F0F0F0F) + 0x7F7F7F7F)
    up = ((x1 >> 4) | (x1 >> 5)) & 0x01010101
    v = (x & 0x0F0F0F0F) + up
    bad4 = x & s1 & s2 & s3 & ~((v + 0x7F7F7F7F) & ~(v + 0x7B7B7B7B))
    return (orphan | cut | c0c1 | bad3 | bad4) & 0x80808080


def screen_flags_ref(b: torch.Tensor, length: int) -> torch.Tensor:
    """Plain twin of the first-event kernel's screen: bool[n], True on each
    byte of ``b`` (uint8[n]) that the screen flags, with bytes at/after
    ``length`` and before 0 read as zero (so they are never flagged)."""
    n = b.shape[0]
    pad = -n % 4
    x = torch.cat([b.to(torch.int64), b.new_zeros(pad, dtype=torch.int64)])
    x = torch.where(positions(n + pad, b.device) < length, x, torch.zeros_like(x))
    x = x.view(-1, 4)
    w = x[:, 0] | (x[:, 1] << 8) | (x[:, 2] << 16) | (x[:, 3] << 24)
    zero = w.new_zeros(1)
    f = screen_words_ref(w, torch.cat([zero, w[:-1]]), torch.cat([w[1:], zero]))
    bits = torch.stack([(f >> (8 * j + 7)) & 1 for j in range(4)], dim=1)
    return bits.flatten()[:n].bool()


def exact_chunks_ref(b: torch.Tensor, length: int) -> int:
    """The 16-byte chunks of ``b[:length]`` that hold a byte the screen
    flags (:func:`screen_flags_ref`): those the first-event kernel runs
    its event lattice on when it reads the whole buffer. On valid text
    none; with an error the kernel stops at the first flagged chunks of
    each warp, so it counts at most this many."""
    flagged = torch.nonzero(screen_flags_ref(b, length)).flatten() // 16
    return int(torch.unique(flagged).numel())


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
