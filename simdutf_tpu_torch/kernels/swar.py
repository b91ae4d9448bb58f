"""SWAR first-bad-word scans: 4 bytes, or 2 UTF-16 units, per 32-bit word.

Port of simdutf_tpu/kernels/swar.py: ``utf8_swar_first_bad_word``
(Pallas ``_swar_kernel`` / ``_swar_body``), ``ascii_swar_first_bad_word``
(``_ascii_swar_kernel``) and ``utf16_swar_first_bad_word``
(``_utf16_swar_kernel`` / ``_utf16_swar_body``, LE and BE). Each answers
"which is the first word that holds an error?", the vector pass of the
reference's vector-pass-then-rescan validation (scalar/utf8.h:207-228);
the caller rewinds on the host to the exact (code, position). On a CUDA
tensor the wrappers launch the entry points of csrc/swar.cu; on a CPU
tensor they run the plain versions beside them.

The per-word predicates are the Pallas ones term for term: the zero-byte
trick ``haszero(v) = (v - 0x01010101) & ~v & 0x80808080`` per masked
compare, the must-be-continuation XOR is-continuation structure and the
range masks on the next byte (UTF-8), the halfword analog for surrogate
pairing (UTF-16). The result is the Pallas word index on its
zero-padded layout, a word past the length included (a cut sequence
flags on the zero after it). The TPU layout's zero tiles fore and aft are
not needed: each function takes a flat buffer and the logical length,
and elements at/after the length read as zero. The plain versions compute
on int64 words that hold the uint32 bits.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG, positions, zero_tail

_M = 0xFFFFFFFF
_ONES = 0x01010101
_HIGH = 0x80808080
_HONES = 0x00010001
_HHIGH = 0x80008000


def _hz(v):
    return (v - _ONES) & ~v & _HIGH


def _eq(b, mask, val):
    return _hz((b & (mask * _ONES)) ^ (val * _ONES))


def _hz16(v):
    return (v - _HONES) & ~v & _HHIGH


def _eq16(w, mask, val):
    return _hz16((w & (mask * _HONES)) ^ (val * _HONES))


def _first(err: torch.Tensor, nwords: int) -> torch.Tensor:
    """The least word index below ``nwords`` whose mask is nonzero, as a
    0-d int32 tensor; BIG when none is."""
    hit = torch.where(err[:nwords] != 0, positions(nwords, err.device), BIG)
    return torch.cat([hit, hit.new_full((1,), BIG)]).min().to(torch.int32)


def _words(elems: torch.Tensor, per: int, bits: int, nwords: int) -> torch.Tensor:
    """int64 words -1 .. nwords of the element values ``elems`` (int32,
    zero past the length), ``per`` elements of ``bits`` bits a word,
    little-endian; zero outside the buffer."""
    need = per * (nwords + 1)
    x = elems[:need].to(torch.int64)
    x = torch.cat([x, x.new_zeros(need - x.shape[0])]).view(-1, per)
    w = x[:, 0]
    for i in range(1, per):
        w = w | (x[:, i] << (bits * i))
    return torch.cat([w.new_zeros(1), w])


def _utf8_nwords(length: int) -> int:
    return (length + 3) // 4 + 1


def utf8_swar_first_bad_word_ref(b: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version of :func:`utf8_swar_first_bad_word`."""
    nw = _utf8_nwords(length)
    w = _words(zero_tail(b.to(torch.int32), length), 4, 8, nw)
    prev, cur, nxt = w[:-2], w[1:-1], w[2:]
    cont = _eq(cur, 0xC0, 0x80)
    bm1 = ((cur << 8) & _M) | (prev >> 24)
    bm2 = ((cur << 16) & _M) | (prev >> 16)
    bm3 = ((cur << 24) & _M) | (prev >> 8)
    must = (_eq(bm1, 0xE0, 0xC0) | _eq(bm1, 0xF0, 0xE0) | _eq(bm1, 0xF8, 0xF0)
            | (_eq(bm2, 0xF0, 0xE0) | _eq(bm2, 0xF8, 0xF0))
            | _eq(bm3, 0xF8, 0xF0))
    err = must ^ cont
    b1 = (cur >> 8) | ((nxt << 24) & _M)
    a_80_9f = _eq(b1, 0xE0, 0x80)
    a_a0_bf = _eq(b1, 0xE0, 0xA0)
    a_80_8f = _eq(b1, 0xF0, 0x80)
    err = err | _eq(cur, 0xFE, 0xC0)
    err = err | (_eq(cur, 0xFF, 0xE0) & a_80_9f)
    err = err | (_eq(cur, 0xFF, 0xED) & a_a0_bf)
    err = err | (_eq(cur, 0xFF, 0xF0) & a_80_8f)
    err = err | (_eq(cur, 0xFF, 0xF4) & ~a_80_8f & _HIGH)
    err = err | (_eq(cur, 0xFC, 0xF4) & ~_eq(cur, 0xFF, 0xF4))
    err = err | _eq(cur, 0xF8, 0xF8)
    return _first(err, nw)


def ascii_swar_first_bad_word_ref(b: torch.Tensor, length: int) -> torch.Tensor:
    """Plain version of :func:`ascii_swar_first_bad_word`."""
    nw = (length + 3) // 4
    w = _words(zero_tail(b.to(torch.int32), length), 4, 8, nw)
    return _first(w[1:-1] & _HIGH, nw)


def utf16_swar_first_bad_word_ref(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """Plain version of :func:`utf16_swar_first_bad_word`."""
    from ..ops import utf16 as o16

    nw = (length + 1) // 2
    x = _words(o16.native(w, length, be), 2, 16, nw)
    prev, cur, nxt = x[:-2], x[1:-1], x[2:]
    high = _eq16(cur, 0xFC00, 0xD800)
    low = _eq16(cur, 0xFC00, 0xDC00)
    next_low = (low >> 16) | ((_eq16(nxt, 0xFC00, 0xDC00) << 16) & _M)
    prev_high = ((high << 16) & _M) | (_eq16(prev, 0xFC00, 0xD800) >> 16)
    return _first((high & ~next_low) | (low & ~prev_high), nw)


def _launch(name: str, x: torch.Tensor, length: int, *extra) -> torch.Tensor:
    out = torch.full((1,), BIG, dtype=torch.int32, device=x.device)
    _build.call(name, x.data_ptr(), length, *extra, out.data_ptr())
    return out[0]


@trace.kernel
def utf8_swar_first_bad_word(b: torch.Tensor, length: int) -> torch.Tensor:
    """Index of the first 32-bit word of ``b[:length]`` (4 bytes each, the
    bytes at/after ``length`` zero) that holds a byte of the SWAR UTF-8
    error set, as a 0-d int32 tensor on ``b``'s device; BIG when there is
    none. Words up to one past the last in-range byte's word count."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return utf8_swar_first_bad_word_ref(b, length)
    return _launch("utf8_swar_first_bad_word", b, length)


@trace.kernel
def ascii_swar_first_bad_word(b: torch.Tensor, length: int) -> torch.Tensor:
    """Index of the first 32-bit word of ``b[:length]`` with a byte >= 0x80,
    as a 0-d int32 tensor on ``b``'s device; BIG when every byte is ASCII."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return ascii_swar_first_bad_word_ref(b, length)
    return _launch("ascii_swar_first_bad_word", b, length)


@trace.kernel
def utf16_swar_first_bad_word(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """Index of the first 32-bit word (2 units) of ``w[:length]`` (stored
    byte-swapped when ``be``) that holds a high surrogate not followed by
    a low one or a low one not preceded by a high one, as a 0-d int32
    tensor on ``w``'s device; BIG when there is none. A high surrogate at
    ``length - 1`` is lone."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return utf16_swar_first_bad_word_ref(w, length, be)
    return _launch("utf16_swar_first_bad_word", w, length, int(be))
