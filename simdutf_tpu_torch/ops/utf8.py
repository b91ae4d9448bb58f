"""UTF-8 ops on torch tensors (port of the main path of
simdutf_tpu/ops/utf8.py).

Every function takes a padded 1-D ``torch.uint8`` buffer and the logical
``length`` (an int); bytes at/after ``length`` are ignored. Results stay on
the buffer's device as 0-d int64 tensors, except where a routing decision
needs a host value. On a CUDA tensor the kernel wrappers in
``simdutf_tpu_torch.kernels`` launch their Hopper kernels; on a CPU tensor
they run their plain versions, which are written from the functions here.
"""

from __future__ import annotations

import torch

from simdutf_tpu.errors import error_code as ec

from ..kernels import census as kcen
from ..kernels import compose16 as kc16
from ..kernels import validate as kv
from .common import (
    BIG,
    bswap16,
    excl_scan,
    positions,
    route,
    scatter_writes,
    shift_left,
    shift_right,
    to_u16,
    zero_tail,
)

_TOO_SHORT = int(ec.TOO_SHORT)
_TOO_LONG = int(ec.TOO_LONG)
_OVERLONG = int(ec.OVERLONG)
_TOO_LARGE = int(ec.TOO_LARGE)
_SURROGATE = int(ec.SURROGATE)
_HEADER_BITS = int(ec.HEADER_BITS)


def _scalar(x: int, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.int64, device=device)


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
    pos1 = bad.min() if n else _scalar(BIG, dev)
    code1 = err[bad.argmin()].to(torch.int64) if n else _scalar(0, dev)
    # (2) continuation left over after a valid sequence: TOO_LONG there
    seqlen = cls["seqlen"]
    c4 = shift_left(cls["is_cont"], 4)
    gap = (((seqlen == 1) & cls["c1"]) | ((seqlen == 2) & cls["c2"])
           | ((seqlen == 3) & cls["c3"]) | ((seqlen == 4) & c4))
    good = lead & (err == 0)
    pos2 = torch.where(good & gap, idx + seqlen, big).min() if n else _scalar(BIG, dev)
    # (3) the buffer starts with a continuation byte
    pos3 = _scalar(BIG, dev)
    if n and length > 0:
        pos3 = torch.where(cls["is_cont"][0], _scalar(0, dev), pos3)

    err_pos = torch.minimum(torch.minimum(pos1, pos2), pos3)
    err_code = torch.where(err_pos == pos1, code1, _scalar(_TOO_LONG, dev))
    err_code = torch.where(err_pos == BIG, _scalar(0, dev), err_code)
    return err_pos, err_code


def validate_with_errors(b: torch.Tensor, length: int):
    """-> (err_code, err_pos); (0, length) on success. One pass of the
    first-event kernel (kernels/validate.utf8_first_event_len)."""
    pos, code = kv.utf8_first_event_len(b, length)
    ok = pos == BIG
    return (torch.where(ok, torch.zeros_like(code), code),
            torch.where(ok, torch.full_like(pos, length), pos))


def count_code_points(b: torch.Tensor, length: int) -> torch.Tensor:
    return kv.utf8_count(b, length)


def utf16_length(b: torch.Tensor, length: int) -> torch.Tensor:
    return kv.utf8_utf16_length(b, length)


def census_full(b: torch.Tensor, length: int):
    """(ascii, u2, u3, u4, has2, has4) as Python bools from ONE census
    pass plus one device sync. Each of ascii/u2/u3/u4 is an exact
    validity proof for its class (see simdutf_tpu/ops/utf8.census)."""
    bits = int(kcen.census_bits(b, length))
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


def presence(b: torch.Tensor, length: int):
    return census_full(b, length)[4:]


def _mask_units(units: torch.Tensor, count: int) -> torch.Tensor:
    idx = positions(units.shape[0], units.device)
    return torch.where(idx < count, units, torch.zeros_like(units))


def _swp16(u: torch.Tensor, big_endian: bool) -> torch.Tensor:
    return bswap16(u) if big_endian else u


def _pad_to(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([u, u.new_zeros(n - u.shape[0])])


def _u16_fast_branches(b: torch.Tensor, length: int, n: int, big_endian: bool):
    """The four fixed-rate utf8->utf16 branches; each returns
    (out int32[n] of unit values, out_len) bit-identical to the general
    engine on its class. Plain torch on every device: the JAX package has
    no Pallas kernel here either."""

    def br_ascii():
        u = zero_tail(b.to(torch.int32), length)
        return _swp16(u, big_endian), length

    def br_u2():
        pr = b[: n // 2 * 2].to(torch.int32).view(-1, 2)
        u = ((pr[:, 0] & 0x1F) << 6) | (pr[:, 1] & 0x3F)
        cnt = length // 2
        return _pad_to(_mask_units(_swp16(u, big_endian), cnt), n), cnt

    def br_u3():
        tr = b[: n // 3 * 3].to(torch.int32).view(-1, 3)
        u = (((tr[:, 0] & 0x0F) << 12) | ((tr[:, 1] & 0x3F) << 6)
             | (tr[:, 2] & 0x3F))
        cnt = length // 3
        return _pad_to(_mask_units(_swp16(u, big_endian), cnt), n), cnt

    def br_u4():
        q = b[: n // 4 * 4].to(torch.int32).view(-1, 4)
        # surrogates straight from the bytes: hi = D7C0 + cp >> 10 folds
        # the -0x10000 in (simdutf_tpu/ops/utf8._u16_fast_branches)
        hi = 0xD7C0 + (((q[:, 0] & 0x07) << 8) | ((q[:, 1] & 0x3F) << 2)
                       | ((q[:, 2] >> 4) & 0x03))
        lo = 0xDC00 + (((q[:, 2] & 0x0F) << 6) | (q[:, 3] & 0x3F))
        u = torch.stack([_swp16(hi, big_endian), _swp16(lo, big_endian)],
                        dim=1).reshape(-1)
        cnt = length // 2
        return _pad_to(_mask_units(u, cnt), n), cnt

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
    total = inc[n - 1] if n else _scalar(0, cp.device)
    out = scatter_writes(n, [(keep, off, val)], cp.device)
    return out, off, total


def _utf16_general_parts(b: torch.Tensor, length: int, big_endian: bool):
    """The plain mixed-script engine, classify -> scan -> scatter (the JAX
    package's ``_to_utf16_general``), and the compose kernel's plain
    version. Returns (err_pos, err_code, out int32[n] zeroed at/after
    out_len, total, err_len): err_pos == BIG when valid, total counts
    every unit, err_len the units before err_pos."""
    n = b.shape[0]
    idx = positions(n, b.device)
    cls = classify(b, length)
    err_pos, err_code = _first_error_from(cls, length)
    lead = cls["lead"] & (idx < length)
    out, off, total = _emit_utf16_units(cls["cp"], lead, cls["lead4"], n,
                                        big_endian)
    ok = err_pos == BIG
    # off[0] == 0 for an exclusive scan, so err_pos == 0 needs no case
    err_len = torch.where(ok, _scalar(0, b.device),
                          off[torch.clamp(err_pos, max=max(n - 1, 0))]
                          if n else _scalar(0, b.device))
    out_len = torch.where(ok, total, err_len)
    out = torch.where(idx < out_len, out, torch.zeros_like(out))
    return err_pos, err_code, out, total, err_len


def _general_utf16(b: torch.Tensor, length: int, big_endian: bool):
    """Mixed input: the compose kernel (kernels/compose16) at every buffer
    size. Its output is already zero at/after the valid-prefix end.
    Returns (err_code, err_pos, out uint16[n], out_len)."""
    out, total, err_any, err_pos, err_code, err_len = kc16.to_utf16_compose(
        b, length, big_endian)
    zero = torch.zeros_like(err_code)
    return (torch.where(err_any, err_code, zero),
            torch.where(err_any, err_pos, _scalar(length, b.device)),
            out,
            torch.where(err_any, err_len, total))


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
    n = b.shape[0]
    ascii_, u2, u3, u4, _, _ = census_full(b, length)
    fast = _u16_fast_branches(b, length, n, big_endian)
    dev = b.device

    def wrap(br):
        def f():
            out, cnt = br()
            return (_scalar(0, dev), _scalar(length, dev), to_u16(out),
                    _scalar(cnt, dev))
        return f

    return route(
        [(p, wrap(br)) for p, br in zip((ascii_, u2, u3, u4), fast)],
        lambda: _general_utf16(b, length, big_endian),
    )


def to_utf16_valid(b: torch.Tensor, length: int, big_endian: bool):
    """convert_valid_utf8_to_utf16*: assumes valid input. Returns
    (out uint16[N], out_len), census-routed like :func:`to_utf16`."""
    n = b.shape[0]
    ascii_, u2, u3, u4, _, _ = census_full(b, length)
    fast = _u16_fast_branches(b, length, n, big_endian)
    dev = b.device

    def wrap(br):
        def f():
            out, cnt = br()
            return to_u16(out), _scalar(cnt, dev)
        return f

    def general():
        return kc16.to_utf16_compose(b, length, big_endian)[:2]

    return route(
        [(p, wrap(br)) for p, br in zip((ascii_, u2, u3, u4), fast)],
        general,
    )
