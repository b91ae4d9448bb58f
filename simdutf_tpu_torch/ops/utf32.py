"""UTF-32 ops on torch tensors (port of the validation, counts, census and
the UTF-8, UTF-16 and Latin-1 transcodes of simdutf_tpu/ops/utf32.py).

Every function takes a padded 1-D ``torch.int32`` buffer holding the bits
of little-endian uint32 words (a word >= 2^31 is negative here) and the
logical ``length`` in words (an int); words at/after ``length`` are
ignored. Results stay on the buffer's device as 0-d int64 tensors, except
where a routing decision needs a host value. On a CUDA tensor the kernel
wrappers in ``simdutf_tpu_torch.kernels`` launch their Hopper kernels; on
a CPU tensor they run their plain versions, which are written from the
functions here.
"""

from __future__ import annotations

import torch

from .. import trace
from ..errors import error_code as ec
from ..kernels import composex as kcx
from ..kernels import transcode32 as ktr32
from ..kernels import validate as kv
from .common import (BIG, bswap16, bytes_out, count_before, excl_scan, positions,
                     routed, routed_valid, scalar, scatter_writes, to_u16, zero_tail)

_SURROGATE = int(ec.SURROGATE)
_TOO_LARGE = int(ec.TOO_LARGE)



def native(w: torch.Tensor, length: int) -> torch.Tensor:
    """The words, zero at/after ``length``."""
    return zero_tail(w, length)


def _too_large(x: torch.Tensor) -> torch.Tensor:
    """Above 0x10FFFF as uint32: negative int32 words included."""
    return (x < 0) | (x > 0x10FFFF)


def _surrogate(x: torch.Tensor) -> torch.Tensor:
    """In D800-DFFF: the words whose bits above the 11th are 0x1B (a
    negative word shifts to a negative value)."""
    return (x >> 11) == 0xD800 >> 11


def first_error(x: torch.Tensor, length: int):
    """(pos, code) of the first invalid word of ``x`` (tail zeroed) as 0-d
    int64 tensors: TOO_LARGE above 0x10FFFF, SURROGATE in D800-DFFF; pos
    == BIG and code == 0 when valid."""
    n = x.shape[0]
    if n == 0:
        return scalar(BIG, x.device), scalar(0, x.device)
    idx = positions(n, x.device)
    bad = (_too_large(x) | _surrogate(x)) & (idx < length)
    pos = torch.where(bad, idx, torch.full_like(idx, BIG)).min()
    return pos, _code_at(x, pos)


def _code_at(w: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The error code of the word at ``pos`` (0 when pos == BIG), read on
    the device."""
    word = w.index_select(0, pos.clamp(max=w.shape[0] - 1).view(1))[0]
    code = torch.where(_too_large(word), _TOO_LARGE, _SURROGATE)
    return torch.where(pos == BIG, 0, code).to(torch.int64)


@trace.route
def validate_with_errors(w: torch.Tensor, length: int):
    """-> (err_code, err_pos); (0, length) on success. One pass of the
    first-bad kernel (kernels/validate.utf32_first_bad); the code is read
    off the flagged word on the device."""
    pos = kv.utf32_first_bad(w, length)
    ok = pos == BIG
    code = _code_at(w, pos) if w.shape[0] else scalar(0, w.device)
    return (torch.where(ok, 0, code).to(torch.int64),
            torch.where(ok, torch.full_like(pos, length), pos))


@trace.route
def utf8_length(w: torch.Tensor, length: int) -> torch.Tensor:
    return kv.utf32_count(w, length, "utf8len")


@trace.route
def utf16_length(w: torch.Tensor, length: int) -> torch.Tensor:
    return kv.utf32_count(w, length, "utf16len")


def census(w: torch.Tensor, length: int):
    """The five facts of simdutf_tpu/ops/utf32.census as Python bools:
    (ascii, u2, u3, astral, bmp), each an exact validity proof for its
    class (every in-range word below 0x80; in 0x80-0x7FF; in 0x800-0xFFFF
    and no surrogate; in 0x10000-0x10FFFF; at most 0xFFFF and no
    surrogate). One min/max reduction of the in-range words (plain torch,
    as the JAX package computes its census in XLA) and one pass of the
    first-bad kernel, read back to the host together: where every word is
    at most 0xFFFF, the first bad word is a surrogate, and elsewhere the
    surrogate fact decides nothing."""
    if length == 0:
        return True, False, False, False, True
    lo, hi = torch.aminmax(w[:length])
    lo, hi, bad = trace.sync("utf32.census", torch.Tensor.tolist,
                             torch.stack([lo.to(torch.int64), hi.to(torch.int64),
                                          kv.utf32_first_bad(w, length)]))
    if lo < 0:  # a word >= 2^31: above every class
        return False, False, False, False, False
    sur = bad != BIG
    return (hi < 0x80,
            lo >= 0x80 and hi <= 0x7FF,
            lo >= 0x800 and hi <= 0xFFFF and not sur,
            lo >= 0x10000 and hi <= 0x10FFFF,
            hi <= 0xFFFF and not sur)


def _u8_fast_branches(w: torch.Tensor, length: int):
    """The four fixed-rate utf32->utf8 branches (ascii, u2, u3, astral);
    each returns (out uint8[4n], out_len) bit-identical to the general
    engine on its class (simdutf_tpu/ops/utf32._u8_fast_branches). The u2,
    u3 and astral branches are the fixed-rate kernels of
    kernels/transcode32 (the JAX ``pallas`` tier's
    ``uniform2_utf32_to_utf8``, ``uniform3_utf32_to_utf8`` and
    ``astral_wordmap``'s ``u32_to_u8`` variant); the census has proved the
    class, so their flag is not read. The ascii branch is plain torch on
    every device: no Pallas kernel computes it either (the ``pallas``
    tier's ``_u32_to_u8_fast`` has no ASCII arm)."""

    def br_ascii():
        return bytes_out(native(w, length), length, 4 * w.shape[0]), length

    def br_u2():
        return ktr32.uniform2_utf32_to_utf8(w, length)[0], 2 * length

    def br_u3():
        return ktr32.uniform3_utf32_to_utf8(w, length)[0], 3 * length

    def br_astral():
        return ktr32.astral_utf32_to_utf8(w, length)[0], 4 * length

    return br_ascii, br_u2, br_u3, br_astral


def _utf8_general_parts(w: torch.Tensor, length: int):
    """The plain engine, scan -> scatter (the JAX package's scatter form of
    ``to_utf8`` with ``_emit_utf8``), and the compose kernel's plain
    version. Every in-range word emits its bytes, a word above 0x10FFFF
    the one byte 0x00 and a surrogate its 3 bytes, and nothing is zeroed
    past the valid prefix. Returns (err_pos, err_code, out uint8[4n],
    total, err_len): err_pos == BIG when valid, total counts every byte,
    err_len the bytes before err_pos."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length)
    err_pos, err_code = first_error(x, length)
    in_r = positions(n, dev) < length
    cp = torch.where(_too_large(x), 0, x)
    width = (in_r.to(torch.int64) + (in_r & (cp > 0x7F))
             + (in_r & (cp > 0x7FF)) + (in_r & (cp > 0xFFFF)))
    off, inc = excl_scan(width)
    total = inc[n - 1] if n else scalar(0, dev)
    b0 = torch.where(width == 1, cp, 0)
    b0 = torch.where(width == 2, (cp >> 6) | 0xC0, b0)
    b0 = torch.where(width == 3, (cp >> 12) | 0xE0, b0)
    b0 = torch.where(width == 4, (cp >> 18) | 0xF0, b0)
    b1 = torch.where(width == 2, (cp & 0x3F) | 0x80, 0)
    b1 = torch.where(width == 3, ((cp >> 6) & 0x3F) | 0x80, b1)
    b1 = torch.where(width == 4, ((cp >> 12) & 0x3F) | 0x80, b1)
    b2 = torch.where(width == 3, (cp & 0x3F) | 0x80, 0)
    b2 = torch.where(width == 4, ((cp >> 6) & 0x3F) | 0x80, b2)
    b3 = (cp & 0x3F) | 0x80
    out = scatter_writes(4 * n, [(in_r, off, b0), (width >= 2, off + 1, b1),
                                 (width >= 3, off + 2, b2),
                                 (width >= 4, off + 3, b3)], dev)
    err_len = count_before(off, err_pos)
    return err_pos, err_code, out.to(torch.uint8), total, err_len


@trace.route
def to_utf8(w: torch.Tensor, length: int):
    """Validating transcode, routed on the census: whole-buffer ASCII,
    uniform 2-, 3-byte or astral input takes a fixed-rate branch (the
    census predicate is its validity proof); all other input takes the
    compose kernel (kernels/composex).

    Returns (err_code, err_pos, out uint8[4N], out_len); on error out_len
    counts the bytes of the valid prefix, and the bytes of every later
    in-range word stay in ``out`` past it, as in the JAX package."""
    return routed(census(w, length)[:4], _u8_fast_branches(w, length),
                  lambda: kcx.u32_to_utf8_compose(w, length), length)


@trace.route
def to_utf8_valid(w: torch.Tensor, length: int):
    """convert_valid_utf32_to_utf8: assumes valid input. Returns
    (out uint8[4N], out_len), census-routed like :func:`to_utf8`."""
    return routed_valid(census(w, length)[:4], _u8_fast_branches(w, length),
                        lambda: kcx.u32_to_utf8_compose(w, length))


def _u16_fast_branches(w: torch.Tensor, length: int, big_endian: bool):
    """The two fixed-rate utf32->utf16 branches (bmp: a narrowing store;
    astral: two units per word); each returns (out uint16[2n], out_len)
    bit-identical to the general engine on its class
    (simdutf_tpu/ops/utf32._u16_fast_branches). Each is a fixed-rate kernel
    of kernels/transcode32 (the JAX ``pallas`` tier's ``bmp_narrow_utf16``
    and ``astral_wordmap``'s ``u32_to_u16pair`` variant); the census has
    proved the class, so their flag is not read."""

    def br_bmp():
        return ktr32.bmp_narrow_utf16(w, length, big_endian)[0], length

    def br_astral():
        return ktr32.astral_utf32_to_utf16(w, length, big_endian)[0], 2 * length

    return br_bmp, br_astral


def _utf16_general_parts(w: torch.Tensor, length: int, big_endian: bool):
    """The plain engine, scan -> scatter (the JAX package's scatter form of
    ``to_utf16`` with ``_emit_utf16``), and the compose kernel's plain
    version. Every in-range word emits its units, a word above 0x10FFFF
    the one unit 0x0000 and a surrogate itself, and nothing is zeroed past
    the valid prefix. Returns (err_pos, err_code, out uint16[2n], total,
    err_len)."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length)
    err_pos, err_code = first_error(x, length)
    in_r = positions(n, dev) < length
    cp = torch.where(_too_large(x), 0, x)
    is4 = (cp > 0xFFFF) & in_r
    off, inc = excl_scan(in_r.to(torch.int64) + is4)
    total = inc[n - 1] if n else scalar(0, dev)
    cpx = cp - 0x10000
    unit0 = torch.where(is4, 0xD800 + (cpx >> 10), cp)
    unit1 = 0xDC00 + (cpx & 0x3FF)
    if big_endian:
        unit0, unit1 = bswap16(unit0), bswap16(unit1)
    out = scatter_writes(2 * n, [(in_r, off, unit0), (is4, off + 1, unit1)], dev)
    return err_pos, err_code, to_u16(out), total, count_before(off, err_pos)


@trace.route
def to_utf16(w: torch.Tensor, length: int, big_endian: bool):
    """Validating UTF-32 -> UTF-16, routed on the census: whole-buffer BMP
    (no surrogate) or astral input takes a fixed-rate branch (the census
    predicate is its validity proof); all other input takes the compose
    kernel (kernels/composex.u32_to_utf16_compose).

    Returns (err_code, err_pos, out uint16[2N], out_len); on error out_len
    counts the units of the valid prefix, and the units of every later
    in-range word stay in ``out`` past it, as in the JAX package."""
    _, _, _, astral, bmp = census(w, length)
    return routed((bmp, astral), _u16_fast_branches(w, length, big_endian),
                  lambda: kcx.u32_to_utf16_compose(w, length, big_endian), length)


@trace.route
def to_utf16_valid(w: torch.Tensor, length: int, big_endian: bool):
    """convert_valid_utf32_to_utf16*: assumes valid input. Returns
    (out uint16[2N], out_len), census-routed like :func:`to_utf16`."""
    _, _, _, astral, bmp = census(w, length)
    return routed_valid((bmp, astral), _u16_fast_branches(w, length, big_endian),
                        lambda: kcx.u32_to_utf16_compose(w, length, big_endian))


@trace.route
def to_latin1(w: torch.Tensor, length: int):
    """Returns (err_code, err_pos, out uint8[N], out_len): the first word
    above 0xFF (as uint32) is TOO_LARGE, and ``out`` holds the low byte of
    every in-range word, past the error too. Plain torch, as in the JAX
    package."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length)
    idx = positions(n, dev)
    bad = ((x < 0) | (x > 0xFF)) & (idx < length)
    err_pos = torch.where(bad, idx, torch.full_like(idx, BIG)).min() if n else scalar(BIG, dev)
    ok = err_pos == BIG
    return (torch.where(ok, 0, _TOO_LARGE).to(torch.int64),
            torch.where(ok, length, err_pos),
            (x & 0xFF).to(torch.uint8),
            torch.where(ok, length, err_pos))


@trace.route
def to_latin1_valid(w: torch.Tensor, length: int):
    """convert_valid_utf32_to_latin1: a narrowing store. (out uint8[N],
    out_len)."""
    return (native(w, length) & 0xFF).to(torch.uint8), scalar(length, w.device)
