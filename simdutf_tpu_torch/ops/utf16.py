"""UTF-16 ops on torch tensors (port of the validation, counts and the
UTF-8, UTF-32 and Latin-1 transcodes of simdutf_tpu/ops/utf16.py).

Every function takes a padded 1-D ``torch.uint16`` buffer of units in
storage order, the logical ``length`` in units (an int), and
``big_endian``; units at/after ``length`` are ignored. Results stay on the
buffer's device as 0-d int64 tensors, except where a routing decision
needs a host value. On a CUDA tensor the kernel wrappers in
``simdutf_tpu_torch.kernels`` launch their Hopper kernels; on a CPU tensor
they run their plain versions, which are written from the functions here.
"""

from __future__ import annotations

import torch

from .. import trace
from ..errors import error_code as ec

from ..kernels import census as kcen
from ..kernels import compose8 as kc8
from ..kernels import composex as kcx
from ..kernels import transcode as ktr
from ..kernels import transcode32 as ktr32
from ..kernels import utf16_kernels as k16
from .common import (
    BIG,
    bswap16,
    bytes_out,
    count_before,
    excl_scan,
    positions,
    routed,
    routed_valid,
    scalar,
    scatter_writes,
    shift_left,
    shift_right,
    to_u16,
    units_i32,
    zero_tail,
)

_SURROGATE = int(ec.SURROGATE)
_TOO_LARGE = int(ec.TOO_LARGE)



def _native16(w: torch.Tensor, big_endian: bool) -> torch.Tensor:
    """Unit values as int32 in native order, the tail NOT zeroed (the
    census and fast-branch form)."""
    x = units_i32(w)
    return bswap16(x) if big_endian else x


def native(w: torch.Tensor, length: int, big_endian: bool) -> torch.Tensor:
    """Native-order int32 unit values, zero at/after ``length``."""
    return zero_tail(_native16(w, big_endian), length)


def lone_surrogates(wn: torch.Tensor, length: int) -> torch.Tensor:
    """Mask of the lone surrogates among native units ``wn[:length]``: a
    high one not followed by a low one below the length, or a low one not
    preceded by a high one."""
    in_r = positions(wn.shape[0], wn.device) < length
    is_high = ((wn & 0xFC00) == 0xD800) & in_r
    is_low = ((wn & 0xFC00) == 0xDC00) & in_r
    return (is_high & ~shift_left(is_low, 1)) | (is_low & ~shift_right(is_high, 1))


def first_error(wn: torch.Tensor, length: int) -> torch.Tensor:
    """Position of the first lone surrogate of native units ``wn`` as a
    0-d int64 tensor; BIG when valid."""
    n = wn.shape[0]
    if n == 0:
        return scalar(BIG, wn.device)
    idx = positions(n, wn.device)
    return torch.where(lone_surrogates(wn, length), idx, torch.full_like(idx, BIG)).min()


@trace.route
def validate_with_errors(w: torch.Tensor, length: int, big_endian: bool):
    """-> (err_code, err_pos); (0, length) on success. One pass of the
    first-bad kernel (kernels/utf16_kernels.utf16_first_bad)."""
    pos = k16.utf16_first_bad(w, length, big_endian)
    ok = pos == BIG
    return (torch.where(ok, 0, _SURROGATE).to(torch.int64),
            torch.where(ok, torch.full_like(pos, length), pos))


@trace.route
def count_code_points(w: torch.Tensor, length: int, big_endian: bool) -> torch.Tensor:
    return k16.utf16_reduce(w, length, big_endian, "count")


@trace.route
def utf8_length(w: torch.Tensor, length: int, big_endian: bool) -> torch.Tensor:
    return k16.utf16_reduce(w, length, big_endian, "utf8len")


def census(w: torch.Tensor, length: int, big_endian: bool):
    """(ascii, u2r, u3r, astral) as Python bools from ONE census pass plus
    one device sync; each is an exact validity proof for its class (see
    simdutf_tpu/ops/utf16.census)."""
    bits = trace.sync("utf16.census", int, kcen.census16_bits(w, length, big_endian))
    pos = length > 0
    return (
        (bits & kcen.BIT16_NONASCII) == 0,
        (bits & kcen.BIT16_V2) == 0 and pos,
        (bits & kcen.BIT16_V3) == 0 and pos,
        (bits & kcen.BIT16_VASTRAL) == 0 and length % 2 == 0 and pos,
    )


def _u8_fast_branches(w: torch.Tensor, length: int, big_endian: bool):
    """The fixed-rate utf16->utf8 branches (ascii, u2r, u3r, astral); each
    returns (out uint8[3n], out_len) bit-identical to the general engine
    on its class. The ascii, u2r and u3r branches are the fixed-rate
    kernels of kernels/transcode (the JAX ``pallas`` tier's
    ``ascii_narrow_utf8``, ``uniform2_utf16_to_utf8`` and
    ``uniform3_utf16_to_utf8``; the JAX ``xla`` tier sends the uniform-3
    class to its general engine, which gives the same bytes); the census
    has proved the class, so their flag is not read. The astral branch is
    plain torch on every device: no Pallas kernel computes it either
    (``astral_wordmap`` has no UTF-16-pair -> UTF-8 variant)."""

    def br_ascii():
        return ktr.ascii_narrow_utf8(w, length, big_endian)[0], length

    def br_u2r():
        return ktr.uniform2_utf16_to_utf8(w, length, big_endian)[0], 2 * length

    def br_u3r():
        return ktr.uniform3_utf16_to_utf8(w, length, big_endian)[0], 3 * length

    def br_astral():
        n = w.shape[0]
        pr = _native16(w[: n // 2 * 2], big_endian).view(-1, 2)
        hi, lo = pr[:, 0], pr[:, 1]
        hb = hi - 0xD7C0  # cp >> 10, 11 bits
        by = torch.stack([0xF0 | (hb >> 8), 0x80 | ((hb >> 2) & 0x3F),
                          0x80 | ((hb & 0x03) << 4) | ((lo >> 6) & 0x0F),
                          0x80 | (lo & 0x3F)], dim=1)
        return bytes_out(by.reshape(-1), 2 * length, 3 * n), 2 * length

    return br_ascii, br_u2r, br_u3r, br_astral


def _utf8_general_parts(w: torch.Tensor, length: int, big_endian: bool):
    """The plain mixed-width engine, scan -> scatter, in the butterfly's
    accounting (every in-range unit emits 1-3 bytes, each surrogate 2,
    paired or not), and the compose kernel's plain version. Returns
    (err_pos, err_code, out uint8[3n] zeroed at/after out_len, total,
    err_len): err_pos == BIG when valid, total counts every byte, err_len
    the bytes before err_pos."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length, big_endian)
    err_pos = first_error(x, length)
    ok = err_pos == BIG
    err_code = torch.where(ok, 0, _SURROGATE).to(torch.int64)
    idx = positions(n, dev)
    in_r = idx < length
    hi = (x & 0xFC00) == 0xD800
    lo = (x & 0xFC00) == 0xDC00
    e1 = in_r & (x < 0x80)
    e2 = in_r & (x >= 0x80) & (x < 0x800)
    e3 = in_r & (x >= 0x800) & ~hi & ~lo
    width = in_r.to(torch.int64) + (in_r & ~e1).to(torch.int64) + e3.to(torch.int64)
    off, inc = excl_scan(width)
    total = inc[n - 1] if n else scalar(0, dev)

    hb = x - 0xD7C0  # cp >> 10 at a high surrogate
    hb_prev = shift_right(x, 1) - 0xD7C0
    z = torch.zeros_like(x)
    b0 = torch.where(e1, x, z)
    b0 = torch.where(e2, 0xC0 | (x >> 6), b0)
    b0 = torch.where(e3, 0xE0 | (x >> 12), b0)
    b0 = torch.where(hi, 0xF0 | (hb >> 8), b0)
    b0 = torch.where(lo, 0x80 | ((hb_prev & 0x3) << 4) | ((x >> 6) & 0xF), b0)
    b1 = torch.where(e2, 0x80 | (x & 0x3F), z)
    b1 = torch.where(e3, 0x80 | ((x >> 6) & 0x3F), b1)
    b1 = torch.where(hi, 0x80 | ((hb >> 2) & 0x3F), b1)
    b1 = torch.where(lo, 0x80 | (x & 0x3F), b1)
    b2 = 0x80 | (x & 0x3F)
    out = scatter_writes(3 * n, [(in_r, off, b0), (in_r & ~e1, off + 1, b1),
                                 (e3, off + 2, b2)], dev)
    err_len = count_before(off, err_pos)
    out_len = torch.where(ok, total, err_len)
    out = torch.where(positions(3 * n, dev) < out_len, out & 0xFF,
                      torch.zeros_like(out))
    return err_pos, err_code, out.to(torch.uint8), total, err_len


def _utf8_valid_parts(w: torch.Tensor, length: int, big_endian: bool):
    """The plain valid-only engine (the JAX package's ``_codepoints``,
    ``_utf8_widths`` and ``_emit_utf8`` of ``to_utf8_valid``), and the
    compose kernel's valid-mode plain version: every in-range unit that is
    not a low surrogate starts a code point, a high surrogate's made with
    the next unit whatever it is (0 at/after the length), and writes its
    1-4 bytes; bytes past the 3n-byte buffer are dropped. Returns (out
    uint8[3n], total)."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length, big_endian)
    in_r = positions(n, dev) < length
    hi = ((x & 0xFC00) == 0xD800) & in_r
    start = ((x & 0xFC00) != 0xDC00) & in_r
    cp = torch.where(hi, ((x - 0xD800) << 10) + (shift_left(x, 1) - 0xDC00) + 0x10000, x)
    width = start.to(torch.int64) * (1 + (cp > 0x7F).to(torch.int64)
                                     + (cp > 0x7FF) + (cp > 0xFFFF))
    off, inc = excl_scan(width)
    total = inc[n - 1] if n else scalar(0, dev)
    z = torch.zeros_like(cp)
    w1, w2, w3, w4 = width == 1, width == 2, width == 3, width == 4
    b0 = torch.where(w1, cp, z)
    b0 = torch.where(w2, (cp >> 6) | 0xC0, b0)
    b0 = torch.where(w3, (cp >> 12) | 0xE0, b0)
    b0 = torch.where(w4, (cp >> 18) | 0xF0, b0)
    b1 = torch.where(w2, (cp & 0x3F) | 0x80, z)
    b1 = torch.where(w3, ((cp >> 6) & 0x3F) | 0x80, b1)
    b1 = torch.where(w4, ((cp >> 12) & 0x3F) | 0x80, b1)
    b2 = torch.where(w3, (cp & 0x3F) | 0x80, z)
    b2 = torch.where(w4, ((cp >> 6) & 0x3F) | 0x80, b2)
    b3 = (cp & 0x3F) | 0x80
    cap = 3 * n
    out = scatter_writes(cap, [(start & (width > k) & (off + k < cap), off + k, v)
                               for k, v in enumerate((b0, b1, b2, b3))], dev)
    return (out & 0xFF).to(torch.uint8), total


@trace.route
def to_utf8(w: torch.Tensor, length: int, big_endian: bool):
    """Validating transcode, routed on a one-pass census: whole-buffer
    ASCII, uniform 0x80..0x7FF, uniform 0x800..0xFFFF (no surrogate) or
    astral-pair input takes a fixed-rate branch (the census predicate is
    its validity proof); all other input takes the compose kernel.

    Returns (err_code, err_pos, out uint8[3N], out_len); on error out_len
    counts the bytes of the valid prefix, and bytes at/after out_len are
    zero."""
    return routed(census(w, length, big_endian), _u8_fast_branches(w, length, big_endian),
                  lambda: kc8.to_utf8_compose(w, length, big_endian), length)


@trace.route
def to_utf8_valid(w: torch.Tensor, length: int, big_endian: bool):
    """convert_valid_utf16*_to_utf8: assumes valid input. Returns
    (out uint8[3N], out_len), census-routed like :func:`to_utf8`; all other
    input takes the compose kernel's valid-only mode, which gives the JAX
    package's output on invalid input too."""
    return routed_valid(census(w, length, big_endian),
                        _u8_fast_branches(w, length, big_endian),
                        lambda: kc8.to_utf8_compose(w, length, big_endian, mode="valid"))


@trace.route
def change_endianness(w: torch.Tensor) -> torch.Tensor:
    """Every unit of the buffer byte-swapped (uint16[N]). A torch byte swap
    on the buffer's device: the JAX package has no kernel here either."""
    return to_u16(bswap16(units_i32(w)))


@trace.route
def to_well_formed(w: torch.Tensor, length: int, big_endian: bool) -> torch.Tensor:
    """Every lone surrogate of ``w[:length]`` replaced by U+FFFD in the
    buffer's byte order; units at/after ``length`` keep their stored value
    (uint16[N]). One launch of kernels/utf16_kernels.utf16_to_well_formed."""
    return k16.utf16_to_well_formed(w, length, big_endian)


def census32(w: torch.Tensor, length: int, big_endian: bool):
    """(bmp, astral) as Python bools, the routing facts of
    simdutf_tpu/ops/utf16.to_utf32: no surrogate in range (a plain torch
    reduction over the stored units, as the JAX package takes it with a
    separate XLA reduce), and census16's alternating-pair class. Both come
    back to the host in one read."""
    bits = kcen.census16_bits(w, length, big_endian)
    # on the stored units as int16: a native unit in D800-DFFF is -10240 to
    # -8193 (>> 11 gives -5), and a BE unit's native high byte is its low
    x = w.view(torch.int16)[:length]
    sur = (((x & 0xF8) == 0xD8) if big_endian else ((x >> 11) == -5)).any()
    bits, sur = trace.sync("utf16.census32", torch.Tensor.tolist,
                           torch.stack([bits.to(torch.int64), sur.to(torch.int64)]))
    astral = (bits & kcen.BIT16_VASTRAL) == 0 and length % 2 == 0 and length > 0
    return not sur, astral


def _u32_fast_branches(w: torch.Tensor, length: int, big_endian: bool):
    """The fixed-rate utf16->utf32 branches (bmp: a widen; astral: one
    word per pair); each returns (out int32[n], out_len) bit-identical to
    the general engine on its class. Each is a fixed-rate kernel of
    kernels/transcode32 (the JAX ``pallas`` tier's ``bmp_widen_utf32`` and
    ``astral_wordmap``'s ``u16pair_to_u32`` variant); the census has proved
    the class, so their flag is not read."""

    def br_bmp():
        return ktr32.bmp_widen_utf32(w, length, big_endian)[0], length

    def br_astral():
        return ktr32.astral_utf16_to_utf32(w, length, big_endian)[0], length // 2

    return br_bmp, br_astral


def _utf32_general_parts(w: torch.Tensor, length: int, big_endian: bool):
    """The plain engine, scan -> scatter (the JAX package's
    ``scatter_general`` of ``to_utf32``), and the compose kernel's plain
    version. Every start (an in-range unit that is not a low surrogate)
    writes one word, valid or not: a high surrogate the code point it makes
    with the next unit (0 at/after the length), so a lone one gives a
    mechanical value; a lone low writes nothing. Nothing is zeroed past the
    valid prefix. Returns (err_pos, err_code, out int32[n], total,
    err_len)."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length, big_endian)
    err_pos = first_error(x, length)
    err_code = torch.where(err_pos == BIG, 0, _SURROGATE).to(torch.int64)
    in_r = positions(n, dev) < length
    start = ((x & 0xFC00) != 0xDC00) & in_r
    hi = ((x & 0xFC00) == 0xD800) & in_r
    cp = torch.where(hi, ((x - 0xD800) << 10) + (shift_left(x, 1) - 0xDC00) + 0x10000, x)
    off, inc = excl_scan(start.to(torch.int64))
    total = inc[n - 1] if n else scalar(0, dev)
    out = scatter_writes(n, [(start, off, cp)], dev)
    return err_pos, err_code, out, total, count_before(off, err_pos)


@trace.route
def to_utf32(w: torch.Tensor, length: int, big_endian: bool):
    """Validating UTF-16 -> UTF-32, routed on :func:`census32`: a buffer
    with no surrogate widens, an all-pairs one maps each pair to a word,
    and all other input takes the compose kernel
    (kernels/composex.u16_to_utf32_compose).

    Returns (err_code, err_pos, out int32[N] of uint32 words, out_len); on
    error out_len counts the words of the valid prefix, and the words of
    every later start stay in ``out`` past it, as in the JAX package."""
    return routed(census32(w, length, big_endian),
                  _u32_fast_branches(w, length, big_endian),
                  lambda: kcx.u16_to_utf32_compose(w, length, big_endian), length)


@trace.route
def to_utf32_valid(w: torch.Tensor, length: int, big_endian: bool):
    """convert_valid_utf16*_to_utf32: assumes valid input. Returns
    (out int32[N], out_len), routed like :func:`to_utf32`."""
    return routed_valid(census32(w, length, big_endian),
                        _u32_fast_branches(w, length, big_endian),
                        lambda: kcx.u16_to_utf32_compose(w, length, big_endian))


@trace.route
def to_latin1(w: torch.Tensor, length: int, big_endian: bool):
    """Returns (err_code, err_pos, out uint8[N], out_len): the first unit
    above 0xFF is TOO_LARGE (surrogates are irrelevant), and ``out`` holds
    the low byte of every in-range unit, past the error too. Plain torch,
    as in the JAX package."""
    n = w.shape[0]
    dev = w.device
    x = native(w, length, big_endian)
    idx = positions(n, dev)
    bad = (x > 0xFF) & (idx < length)
    err_pos = torch.where(bad, idx, torch.full_like(idx, BIG)).min() if n else scalar(BIG, dev)
    ok = err_pos == BIG
    return (torch.where(ok, 0, _TOO_LARGE).to(torch.int64),
            torch.where(ok, length, err_pos),
            (x & 0xFF).to(torch.uint8),
            torch.where(ok, length, err_pos))


@trace.route
def to_latin1_valid(w: torch.Tensor, length: int, big_endian: bool):
    """convert_valid_utf16*_to_latin1: a narrowing store. (out uint8[N],
    out_len)."""
    x = native(w, length, big_endian)
    return (x & 0xFF).to(torch.uint8), scalar(length, w.device)
