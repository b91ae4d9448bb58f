"""UTF-8 ops on torch tensors (port of the UTF-16, UTF-32 and Latin-1
transcodes, validation and counts of simdutf_tpu/ops/utf8.py).

Every function takes a padded 1-D ``torch.uint8`` buffer and the logical
``length`` (an int); bytes at/after ``length`` are ignored. Results stay on
the buffer's device as 0-d int64 tensors, except where a routing decision
needs a host value. On a CUDA tensor the kernel wrappers in
``simdutf_tpu_torch.kernels`` launch their Hopper kernels; on a CPU tensor
they run their plain versions, which are written from the functions here.
"""

from __future__ import annotations

import torch

from .. import trace
from ..errors import error_code as ec

from ..kernels import census as kcen
from ..kernels import compose16 as kc16
from ..kernels import compose32 as kc32
from ..kernels import transcode as ktr
from ..kernels import transcode32 as ktr32
from ..kernels import validate as kv
from .common import (
    BIG,
    bswap16,
    count_before,
    excl_scan,
    positions,
    routed,
    routed_valid,
    scalar,
    scatter_writes,
    shift_left,
    shift_right,
    zero_tail,
)

_TOO_SHORT = int(ec.TOO_SHORT)
_TOO_LONG = int(ec.TOO_LONG)
_OVERLONG = int(ec.OVERLONG)
_TOO_LARGE = int(ec.TOO_LARGE)
_SURROGATE = int(ec.SURROGATE)
_HEADER_BITS = int(ec.HEADER_BITS)



def classify(b_u8: torch.Tensor, length: int) -> dict:
    """Structural classification of a UTF-8 buffer (per-byte int32/bool
    tensors; see simdutf_tpu/ops/utf8.classify for the fields)."""
    b = zero_tail(b_u8.to(torch.int32), length)
    b1, b2, b3 = shift_left(b, 1), shift_left(b, 2), shift_left(b, 3)

    is_cont = (b & 0xC0) == 0x80
    c1 = (b1 & 0xC0) == 0x80
    c2 = (b2 & 0xC0) == 0x80
    c3 = (b3 & 0xC0) == 0x80

    ascii_ = b < 0x80
    lead2 = (b & 0xE0) == 0xC0
    lead3 = (b & 0xF0) == 0xE0
    lead4 = (b & 0xF8) == 0xF0
    badlead = b >= 0xF8

    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)

    z = torch.zeros_like(b)

    def put(err, cond, code):
        return torch.where(cond, torch.full_like(err, code), err)

    err = put(z, lead2 & ~c1, _TOO_SHORT)
    err = put(err, lead2 & c1 & (cp2 < 0x80), _OVERLONG)
    ok3 = c1 & c2
    err = put(err, lead3 & ~ok3, _TOO_SHORT)
    err = put(err, lead3 & ok3 & (cp3 < 0x800), _OVERLONG)
    err = put(err, lead3 & ok3 & (cp3 >= 0xD800) & (cp3 <= 0xDFFF), _SURROGATE)
    ok4 = c1 & c2 & c3
    err = put(err, lead4 & ~ok4, _TOO_SHORT)
    err = put(err, lead4 & ok4 & (cp4 <= 0xFFFF), _OVERLONG)
    err = put(err, lead4 & ok4 & (cp4 > 0x10FFFF), _TOO_LARGE)
    err = put(err, badlead, _HEADER_BITS)

    seqlen = ascii_.to(torch.int32)
    seqlen = put(seqlen, lead2, 2)
    seqlen = put(seqlen, lead3, 3)
    seqlen = put(seqlen, lead4, 4)

    cp = torch.where(ascii_, b, z)
    cp = torch.where(lead2, cp2, cp)
    cp = torch.where(lead3, cp3, cp)
    cp = torch.where(lead4, cp4, cp)

    return dict(b=b, lead=~is_cont, is_cont=is_cont, c1=c1, c2=c2, c3=c3,
                seqlen=seqlen, cp=cp, err=err, badlead=badlead, lead4=lead4)


def _first_error_from(cls: dict, length: int):
    """(err_pos, err_code) as 0-d int64 tensors; err_pos == BIG when valid."""
    n = cls["b"].shape[0]
    dev = cls["b"].device
    idx = positions(n, dev)
    big = torch.full_like(idx, BIG)
    lead = cls["lead"] & (idx < length)
    err = cls["err"]

    # (1) invalid lead sequences, at the lead
    bad = torch.where(lead & (err != 0), idx, big)
    pos1 = bad.min() if n else scalar(BIG, dev)
    code1 = err[bad.argmin()].to(torch.int64) if n else scalar(0, dev)
    # (2) continuation left over after a valid sequence: TOO_LONG there
    seqlen = cls["seqlen"]
    c4 = shift_left(cls["is_cont"], 4)
    gap = (((seqlen == 1) & cls["c1"]) | ((seqlen == 2) & cls["c2"])
           | ((seqlen == 3) & cls["c3"]) | ((seqlen == 4) & c4))
    good = lead & (err == 0)
    pos2 = torch.where(good & gap, idx + seqlen, big).min() if n else scalar(BIG, dev)
    # (3) the buffer starts with a continuation byte
    pos3 = scalar(BIG, dev)
    if n and length > 0:
        pos3 = torch.where(cls["is_cont"][0], scalar(0, dev), pos3)

    err_pos = torch.minimum(torch.minimum(pos1, pos2), pos3)
    err_code = torch.where(err_pos == pos1, code1, scalar(_TOO_LONG, dev))
    err_code = torch.where(err_pos == BIG, scalar(0, dev), err_code)
    return err_pos, err_code


@trace.route
def validate_ascii_with_errors(b: torch.Tensor, length: int):
    """-> (err_code, err_pos): TOO_LARGE at the first in-range byte >= 0x80,
    else (0, length). One pass of kernels/validate.ascii_first_bad."""
    pos = kv.ascii_first_bad(b, length)
    ok = pos == BIG
    return (torch.where(ok, 0, _TOO_LARGE).to(torch.int64),
            torch.where(ok, torch.full_like(pos, length), pos))


@trace.route
def validate_with_errors(b: torch.Tensor, length: int):
    """-> (err_code, err_pos); (0, length) on success. One pass of the
    first-event kernel (kernels/validate.utf8_first_event_len)."""
    pos, code = kv.utf8_first_event_len(b, length)
    ok = pos == BIG
    return (torch.where(ok, torch.zeros_like(code), code),
            torch.where(ok, torch.full_like(pos, length), pos))


@trace.route
def count_code_points(b: torch.Tensor, length: int) -> torch.Tensor:
    return kv.utf8_count(b, length)


@trace.route
def utf16_length(b: torch.Tensor, length: int) -> torch.Tensor:
    return kv.utf8_utf16_length(b, length)


def census_full(b: torch.Tensor, length: int):
    """(ascii, u2, u3, u4, has2, has4) as Python bools from ONE census
    pass plus one device sync. Each of ascii/u2/u3/u4 is an exact
    validity proof for its class (see simdutf_tpu/ops/utf8.census)."""
    bits = kcen.read_bits("utf8.census", b, length)
    pos = length > 0
    return (
        (bits & kcen.BIT_NONASCII) == 0,
        (bits & kcen.BIT_V2) == 0 and length % 2 == 0 and pos,
        (bits & kcen.BIT_V3) == 0 and length % 3 == 0 and pos,
        (bits & kcen.BIT_V4) == 0 and length % 4 == 0 and pos,
        (bits & kcen.BIT_HAS2) != 0,
        (bits & kcen.BIT_HAS4) != 0,
    )


def census(b: torch.Tensor, length: int):
    return census_full(b, length)[:4]


def _u16_fast_branches(b: torch.Tensor, length: int, big_endian: bool):
    """The four fixed-rate utf8->utf16 branches; each returns
    (out uint16[n], out_len) bit-identical to the general engine on its
    class. Each is a fixed-rate kernel of kernels/transcode (the JAX
    ``pallas`` tier's ``ascii_widen_utf16``, ``uniform2_utf8_to_utf16``,
    ``uniform3_utf8_to_utf16`` and ``astral_wordmap``'s ``u8_to_u16``
    variant); the census has proved the class, so their flag is not
    read."""

    def br_ascii():
        return ktr.ascii_widen_utf16(b, length, big_endian)[0], length

    def br_u2():
        return ktr.uniform2_utf8_to_utf16(b, length, big_endian)[0], length // 2

    def br_u3():
        return ktr.uniform3_utf8_to_utf16(b, length, big_endian)[0], length // 3

    def br_u4():
        return ktr.astral_utf8_to_utf16(b, length, big_endian)[0], length // 2

    return br_ascii, br_u2, br_u3, br_u4


def _emit_utf16_units(cp, lead, lead4, n: int, big_endian: bool):
    """Unit-per-byte emission: unit0 at each lead, unit1 (astral only) at
    the byte after a 4-byte lead, so one scatter places every unit.
    Returns (out int32[n], off, total): off[i] = units before byte i."""
    cpx = cp - 0x10000
    unit0 = torch.where(cp > 0xFFFF, 0xD800 + (cpx >> 10), cp)
    unit1 = 0xDC00 + (cpx & 0x3FF)
    if big_endian:
        unit0 = bswap16(unit0)
        unit1 = bswap16(unit1)
    after_lead4 = shift_right(lead & lead4, 1)
    keep = lead | after_lead4
    val = torch.where(after_lead4, shift_right(unit1, 1), unit0)
    off, inc = excl_scan(keep.to(torch.int64))
    total = inc[n - 1] if n else scalar(0, cp.device)
    out = scatter_writes(n, [(keep, off, val)], cp.device)
    return out, off, total


def _utf16_general_parts(b: torch.Tensor, length: int, big_endian: bool,
                         clamp: bool = True):
    """The plain mixed-script engine, classify -> scan -> scatter (the JAX
    package's ``_to_utf16_general``, and without ``clamp`` its
    ``to_utf16_valid`` engine), and the compose kernel's plain version.
    Returns (err_pos, err_code, out int32[n], total, err_len): err_pos ==
    BIG when valid, total counts every unit, err_len the units before
    err_pos; with ``clamp`` out is zeroed at/after out_len."""
    n = b.shape[0]
    idx = positions(n, b.device)
    cls = classify(b, length)
    err_pos, err_code = _first_error_from(cls, length)
    lead = cls["lead"] & (idx < length)
    out, off, total = _emit_utf16_units(cls["cp"], lead, cls["lead4"], n,
                                        big_endian)
    ok = err_pos == BIG
    err_len = count_before(off, err_pos)
    if clamp:
        out_len = torch.where(ok, total, err_len)
        out = torch.where(idx < out_len, out, torch.zeros_like(out))
    return err_pos, err_code, out, total, err_len


@trace.route
def to_utf16(b: torch.Tensor, length: int, big_endian: bool):
    """Validating transcode, routed on a one-pass census: whole-buffer
    ASCII / uniform 2-, 3-, 4-byte input takes a fixed-rate branch (the
    census predicate is its validity proof); all other input takes the
    compose kernel. The JAX package's census-pruned no_l2/no_l4 routes
    compute the same function as the default, so they are not separate
    routes here.

    Returns (err_code, err_pos, out uint16[N], out_len); on error out_len
    counts the units of the valid prefix, and units at/after out_len are
    zero."""
    return routed(census(b, length), _u16_fast_branches(b, length, big_endian),
                  lambda: kc16.to_utf16_compose(b, length, big_endian), length)


@trace.route
def to_utf16_valid(b: torch.Tensor, length: int, big_endian: bool):
    """convert_valid_utf8_to_utf16*: assumes valid input. Returns
    (out uint16[N], out_len), census-routed like :func:`to_utf16`; all
    other input takes the compose kernel without its clamp, which gives
    the JAX package's output on invalid input too."""
    return routed_valid(census(b, length), _u16_fast_branches(b, length, big_endian),
                        lambda: kc16.to_utf16_compose(b, length, big_endian, clamp=False))


def _u32_fast_branches(b: torch.Tensor, length: int):
    """The four fixed-rate utf8->utf32 branches (ascii, u2, u3, u4); each
    returns (out int32[n] of code points, out_len) bit-identical to the
    general engine on its class (simdutf_tpu/ops/utf8._u32_fast_branches).
    Each is a fixed-rate kernel of kernels/transcode32 (the JAX ``pallas``
    tier's ``latin1_widen_utf32``, ``uniform2_utf8_to_utf32``,
    ``uniform3_utf8_to_utf32`` and ``astral_wordmap``'s ``u8_to_u32``
    variant); the census has proved the class, so their flag is not
    read."""

    def br_ascii():
        return ktr32.latin1_widen_utf32(b, length)[0], length

    def br_u2():
        return ktr32.uniform2_utf8_to_utf32(b, length)[0], length // 2

    def br_u3():
        return ktr32.uniform3_utf8_to_utf32(b, length)[0], length // 3

    def br_u4():
        return ktr32.astral_utf8_to_utf32(b, length)[0], length // 4

    return br_ascii, br_u2, br_u3, br_u4


def _utf32_general_parts(b: torch.Tensor, length: int):
    """The plain mixed-script engine, classify -> scan -> scatter (the JAX
    package's ``_to_utf32_general``), and the compose32 kernel's plain
    version. Every in-range lead writes its mechanically decoded code
    point, valid or not, and nothing is zeroed past the valid prefix.
    Returns (err_pos, err_code, out int32[n], total, err_len): err_pos ==
    BIG when valid, total counts every lead, err_len the leads before
    err_pos."""
    n = b.shape[0]
    dev = b.device
    cls = classify(b, length)
    err_pos, err_code = _first_error_from(cls, length)
    lead = cls["lead"] & (positions(n, dev) < length)
    off, inc = excl_scan(lead.to(torch.int64))
    total = inc[n - 1] if n else scalar(0, dev)
    out = scatter_writes(n, [(lead, off, cls["cp"])], dev)
    err_len = count_before(off, err_pos)
    return err_pos, err_code, out, total, err_len


@trace.route
def to_utf32(b: torch.Tensor, length: int):
    """Validating UTF-8 -> UTF-32, routed on the one-pass census like
    :func:`to_utf16`: whole-buffer ASCII / uniform 2-, 3-, 4-byte input
    takes a fixed-rate branch; all other input takes the compose kernel
    (kernels/compose32).

    Returns (err_code, err_pos, out int32[N] of uint32 code points,
    out_len); on error out_len counts the words of the valid prefix, and
    the code points of every later in-range lead stay in ``out`` past it,
    as in the JAX package."""
    return routed(census(b, length), _u32_fast_branches(b, length),
                  lambda: kc32.to_utf32_compose(b, length), length)


@trace.route
def to_utf32_valid(b: torch.Tensor, length: int):
    """convert_valid_utf8_to_utf32: assumes valid input. Returns
    (out int32[N], out_len), census-routed like :func:`to_utf32`."""
    return routed_valid(census(b, length), _u32_fast_branches(b, length),
                        lambda: kc32.to_utf32_compose(b, length))


def _latin1_leads(bb: torch.Tensor, length: int):
    """(lead mask, off, total, out uint8[n]) of the UTF-8 -> Latin-1
    scatter: every in-range lead writes its 1- or 2-byte value's low byte
    (a 3- or 4-byte lead its mechanical 2-byte value's), valid or not."""
    n = bb.shape[0]
    dev = bb.device
    b1 = shift_left(bb, 1)
    lead = ((bb & 0xC0) != 0x80) & (positions(n, dev) < length)
    vals = torch.where(bb < 0x80, bb, ((bb & 0x1F) << 6) | (b1 & 0x3F))
    off, inc = excl_scan(lead.to(torch.int64))
    total = inc[n - 1] if n else scalar(0, dev)
    out = scatter_writes(n, [(lead, off, vals)], dev)
    return lead, off, total, (out & 0xFF).to(torch.uint8)


@trace.route
def to_latin1(b: torch.Tensor, length: int):
    """UTF-8 -> Latin-1 with its own error lattice (simdutf_tpu/ops/utf8
    .to_latin1): a 2-byte sequence above 0xFF and every 3- or 4-byte lead
    are TOO_LARGE, a continuation left over after a sequence is TOO_LONG
    at itself, and a continuation at 0 is TOO_LONG there; the first lead's
    code wins. Plain torch scan -> scatter, as in the JAX package, which
    has no kernel here.

    Returns (err_code, err_pos, out uint8[N], out_len); ``out`` holds the
    value of every in-range lead, past the error too."""
    n = b.shape[0]
    dev = b.device
    idx = positions(n, dev)
    big = torch.full_like(idx, BIG)
    bb = zero_tail(b.to(torch.int32), length)
    b1 = shift_left(bb, 1)
    ascii_ = bb < 0x80
    lead2 = (bb & 0xE0) == 0xC0
    c1 = (b1 & 0xC0) == 0x80
    cp2 = ((bb & 0x1F) << 6) | (b1 & 0x3F)

    err = torch.zeros_like(bb)
    for cond, code in ((lead2 & ~c1, _TOO_SHORT),
                       (lead2 & c1 & (cp2 < 0x80), _OVERLONG),
                       (lead2 & c1 & (cp2 > 0xFF), _TOO_LARGE),
                       (((bb & 0xF0) == 0xE0) | ((bb & 0xF8) == 0xF0), _TOO_LARGE),
                       (bb >= 0xF8, _HEADER_BITS)):
        err = torch.where(cond, code, err)

    lead, off, total, out = _latin1_leads(bb, length)
    bad = torch.where(lead & (err != 0), idx, big)
    pos1 = bad.min()
    code1 = err[bad.argmin()].to(torch.int64)
    seqlen = torch.where(ascii_, 1, 2)
    c2 = (shift_left(bb, 2) & 0xC0) == 0x80
    gap = ((seqlen == 1) & c1) | ((seqlen == 2) & c2)
    pos2 = torch.where(lead & (err == 0) & gap, idx + seqlen, big).min()
    pos3 = torch.where(((bb[0] & 0xC0) == 0x80), 0, BIG).to(torch.int64)
    err_pos = torch.minimum(torch.minimum(pos1, pos2), pos3)
    ok = err_pos == BIG
    err_code = torch.where(err_pos == pos1, code1, _TOO_LONG)
    return (torch.where(ok, 0, err_code).to(torch.int64),
            torch.where(ok, length, err_pos),
            out,
            torch.where(ok, total, count_before(off, err_pos)))


@trace.route
def to_latin1_valid(b: torch.Tensor, length: int):
    """convert_valid_utf8_to_latin1: valid Latin-1-range UTF-8 has only
    ASCII and 2-byte sequences, so this skips the error lattice. Returns
    (out uint8[N], out_len)."""
    _, _, total, out = _latin1_leads(zero_tail(b.to(torch.int32), length), length)
    return out, total
