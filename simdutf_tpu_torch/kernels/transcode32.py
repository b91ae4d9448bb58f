"""Fixed-rate transcodes into and out of UTF-32, one census class each.

Port of the UTF-32 class kernels of simdutf_tpu/kernels/transcode.py:
``latin1_widen_utf32`` (Pallas ``_l1_32_kernel``, which also serves the
ASCII UTF-8 class), ``uniform2_utf8_to_utf32`` (``_u2_32_kernel``),
``uniform3_utf8_to_utf32`` (``_u3_32_kernel``), ``uniform2_utf32_to_utf8``
(``_rev2_32_kernel``), ``uniform3_utf32_to_utf8`` (``_rev3_32_kernel``),
``bmp_widen_utf32`` (``_bmp_widen_kernel`` and its butterfly form
``_bmp_widen_bf_kernel``), ``bmp_narrow_utf16`` (``_bmp_narrow_kernel`` and
``_bmp_narrow_bf_kernel``), and the four UTF-32 variants of
``astral_wordmap`` (``_wordmap_kernel``): ``astral_utf8_to_utf32``
(``u8_to_u32``), ``astral_utf32_to_utf8`` (``u32_to_u8``),
``astral_utf16_to_utf32`` (``u16pair_to_u32``) and ``astral_utf32_to_utf16``
(``u32_to_u16pair``). On a CUDA tensor each wrapper launches its entry
point of csrc/transcode32.cu; on a CPU tensor it runs its plain version
``<name>_ref`` beside it.

Each returns ``(out, flag)`` with the contract of kernels/transcode:
``out`` the whole output buffer (int32[n] words from n bytes or units,
uint8[4n] bytes or uint16[2n] units from n words), the class's output for
``[0, length)`` then zeros; ``flag`` a 0-d int32 device tensor, nonzero
when some in-range element lies outside the class (a character whose first
element is in range is checked with zeros past the length). UTF-32 words
are int32 holding the uint32 bits, and every range test is unsigned: a
word >= 2^31 is outside every class. On flagged input the output is the
plain version's. The UTF-8 <-> UTF-32 functions take no byte order; the
UTF-16 ones take ``be``. The port's routes call these only on a class the
census has proved and never read the flag.

All eleven kernels stream their bytes (floor: HBM bytes, the in-range
input read once and the whole output written once). ``latin1_widen_utf32``
and ``bmp_widen_utf32`` launch one kernel, ``widen32``, which moves whole
tiles through shared memory with bulk copies on a persistent grid
(:func:`widen32_plan`); the other nine are grid-stride kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .transcode import _flag, _native, _units_out, _wrapper, class_chars
from ..ops.common import bytes_out, positions, zero_tail


def _words_out(cp: torch.Tensor, cnt: int, n: int) -> torch.Tensor:
    """int32[n]: the first ``cnt`` of ``cp``, zeros after them."""
    cp = zero_tail(cp, cnt)[:n]
    return torch.cat([cp, cp.new_zeros(n - cp.shape[0])])


def _in_range(x: torch.Tensor, length: int) -> torch.Tensor:
    return positions(x.shape[0], x.device) < length


# --- UTF-8 (and Latin-1) -> UTF-32 ----------------------------------------------

def _from_utf8_ref(b: torch.Tensor, length: int, width: int):
    cp, ok, first = class_chars(b, length, width)
    return _words_out(cp, length // width, b.shape[0]), _flag(~ok & first)


def latin1_widen_utf32_ref(b: torch.Tensor, length: int):
    """Plain version: every in-range byte as a word, zero after; the flag
    is any in-range byte >= 0x80 (the ASCII class check)."""
    return _from_utf8_ref(b, length, 1)


def uniform2_utf8_to_utf32_ref(b: torch.Tensor, length: int):
    """Plain version: each 2-byte character decoded, the first
    ``length // 2`` kept; the flag is any character with its first byte in
    range that is not ``C2..DF, 80..BF``."""
    return _from_utf8_ref(b, length, 2)


def uniform3_utf8_to_utf32_ref(b: torch.Tensor, length: int):
    """Plain version: each 3-byte character decoded, the first
    ``length // 3`` kept; the flag is ``_uniform3_chars``' structure,
    overlong or surrogate test on a character with its first byte in
    range."""
    return _from_utf8_ref(b, length, 3)


def astral_utf8_to_utf32_ref(b: torch.Tensor, length: int):
    """Plain version: each 4-byte character decoded, the first
    ``length // 4`` kept; the flag is ``_u8_4byte_cp``'s structure or range
    test (0x10000-0x10FFFF) on a character with its first byte in range."""
    return _from_utf8_ref(b, length, 4)


# --- UTF-32 -> UTF-8 -------------------------------------------------------------

def _to_utf8_ref(w: torch.Tensor, length: int, width: int, lo: int, hi: int):
    """The plain branch: ``width`` bytes a word from arithmetic shifts, low
    8 bits kept; the flag is any in-range word outside [lo, hi] as uint32
    (or a surrogate, for width 3)."""
    x = zero_tail(w, length)
    if width == 2:
        by = [(x >> 6) | 0xC0, (x & 0x3F) | 0x80]
    elif width == 3:
        by = [(x >> 12) | 0xE0, ((x >> 6) & 0x3F) | 0x80, (x & 0x3F) | 0x80]
    else:
        by = [(x >> 18) | 0xF0, ((x >> 12) & 0x3F) | 0x80, ((x >> 6) & 0x3F) | 0x80,
              (x & 0x3F) | 0x80]
    bad = (x < lo) | (x > hi)  # a negative word is >= 2^31 as uint32
    if width == 3:
        bad |= (x >= 0xD800) & (x <= 0xDFFF)
    out = bytes_out(torch.stack(by, 1).reshape(-1), width * length, 4 * w.shape[0])
    return out, _flag(bad & _in_range(x, length))


def uniform2_utf32_to_utf8_ref(w: torch.Tensor, length: int):
    """Plain version: 2 bytes per in-range word, zeros to 4n; the flag is
    any in-range word outside 0x80-0x7FF."""
    return _to_utf8_ref(w, length, 2, 0x80, 0x7FF)


def uniform3_utf32_to_utf8_ref(w: torch.Tensor, length: int):
    """Plain version: 3 bytes per in-range word, zeros to 4n; the flag is
    any in-range word outside 0x800-0xFFFF or a surrogate."""
    return _to_utf8_ref(w, length, 3, 0x800, 0xFFFF)


def astral_utf32_to_utf8_ref(w: torch.Tensor, length: int):
    """Plain version: 4 bytes per in-range word, zeros to 4n; the flag is
    any in-range word outside 0x10000-0x10FFFF."""
    return _to_utf8_ref(w, length, 4, 0x10000, 0x10FFFF)


# --- UTF-16 -> UTF-32 ------------------------------------------------------------

def bmp_widen_utf32_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: the in-range units in native order as words, zero
    after; the flag is any in-range unit that is a surrogate."""
    x = _native(w, length, be)
    return x, _flag((x & 0xF800) == 0xD800)


def astral_utf16_to_utf32_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: each unit pair (zeros at/after the length) as
    ``((u0 - 0xD7C0) << 10) | (u1 & 0x3FF)``, the code point of a valid
    pair, the first ``length // 2`` kept; the flag is any pair whose first
    unit is in range that is not a high then a low surrogate."""
    n = w.shape[0]
    x = _native(w, length, be)
    if n % 2:
        x = torch.cat([x, x.new_zeros(1)])
    pr = x.view(-1, 2)
    u0, u1 = pr[:, 0], pr[:, 1]
    cp = ((u0 - 0xD7C0) << 10) | (u1 & 0x3FF)
    ok = ((u0 & 0xFC00) == 0xD800) & ((u1 & 0xFC00) == 0xDC00)
    first = positions(pr.shape[0], w.device) * 2 < length
    return _words_out(cp, length // 2, n), _flag(~ok & first)


# --- UTF-32 -> UTF-16 ------------------------------------------------------------

def bmp_narrow_utf16_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: each in-range word's low 16 bits as a unit, zeros to
    2n; the flag is any in-range word above 0xFFFF (as uint32) or a
    surrogate."""
    x = zero_tail(w, length)
    bad = ((x < 0) | (x > 0xFFFF) | ((x & 0xF800) == 0xD800)) & _in_range(x, length)
    return _units_out(x, length, 2 * w.shape[0], be), _flag(bad)


def astral_utf32_to_utf16_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: each in-range word as the surrogate pair
    ``0xD7C0 + (cp >> 10), 0xDC00 + (cp & 0x3FF)`` (16 bits of each kept),
    zeros to 2n; the flag is any in-range word outside 0x10000-0x10FFFF."""
    x = zero_tail(w, length)
    u = torch.stack([0xD7C0 + (x >> 10), 0xDC00 + (x & 0x3FF)], 1).reshape(-1)
    bad = ((x < 0x10000) | (x > 0x10FFFF)) & _in_range(x, length)
    return _units_out(u, 2 * length, 2 * w.shape[0], be), _flag(bad)


def widen32_plan(src: int) -> dict:
    """The launch plan of ``widen32`` on the current CUDA device for a
    buffer of many tiles: ``src`` 1 for :func:`latin1_widen_utf32`, 2 for
    :func:`bmp_widen_utf32`. Keys: grid, threads, blocks_per_sm,
    tile_words, stages, smem_bytes."""
    plan = (ctypes.c_int * 6)()
    rc = _build.lib().widen32_plan(int(src), plan)
    if rc != 0:
        raise RuntimeError(f"widen32_plan: CUDA error {rc}")
    return dict(zip(("grid", "threads", "blocks_per_sm", "tile_words", "stages",
                     "smem_bytes"), plan))


def _from8(name, ref, doc):
    return _wrapper(name, ref, _build.check_bytes, torch.int32, 1, doc, endian=False)


def _to8(name, ref, doc):
    return _wrapper(name, ref, _build.check_words, torch.uint8, 4, doc, endian=False)


latin1_widen_utf32 = _from8("latin1_widen_utf32", latin1_widen_utf32_ref, """
    uint8[n] -> (int32[n], flag): ``b[:length]`` widened, one word a byte,
    then zeros; the flag fires on a byte >= 0x80 (Latin-1 bytes widen as
    their code points all the same).""")

uniform2_utf8_to_utf32 = _from8("uniform2_utf8_to_utf32", uniform2_utf8_to_utf32_ref, """
    uint8[n] -> (int32[n], flag): ``b[:length]`` as pure 2-byte UTF-8 in
    UTF-32, ``length // 2`` words then zeros.""")

uniform3_utf8_to_utf32 = _from8("uniform3_utf8_to_utf32", uniform3_utf8_to_utf32_ref, """
    uint8[n] -> (int32[n], flag): ``b[:length]`` as pure 3-byte UTF-8 in
    UTF-32, ``length // 3`` words then zeros.""")

astral_utf8_to_utf32 = _from8("astral_utf8_to_utf32", astral_utf8_to_utf32_ref, """
    uint8[n] -> (int32[n], flag): ``b[:length]`` as pure 4-byte UTF-8 in
    UTF-32, ``length // 4`` words then zeros.""")

uniform2_utf32_to_utf8 = _to8("uniform2_utf32_to_utf8", uniform2_utf32_to_utf8_ref, """
    int32[n] -> (uint8[4n], flag): ``w[:length]`` (all in 0x80-0x7FF) as
    UTF-8, ``2 * length`` bytes then zeros.""")

uniform3_utf32_to_utf8 = _to8("uniform3_utf32_to_utf8", uniform3_utf32_to_utf8_ref, """
    int32[n] -> (uint8[4n], flag): ``w[:length]`` (all in 0x800-0xFFFF, no
    surrogate) as UTF-8, ``3 * length`` bytes then zeros.""")

astral_utf32_to_utf8 = _to8("astral_utf32_to_utf8", astral_utf32_to_utf8_ref, """
    int32[n] -> (uint8[4n], flag): ``w[:length]`` (all in 0x10000-0x10FFFF)
    as UTF-8, ``4 * length`` bytes then zeros.""")

bmp_widen_utf32 = _wrapper("bmp_widen_utf32", bmp_widen_utf32_ref, _build.check_units,
                           torch.int32, 1, """
    uint16[n] (byte-swapped units when ``be``) -> (int32[n], flag):
    ``w[:length]`` (no surrogate) as UTF-32, ``length`` words then zeros.""")

astral_utf16_to_utf32 = _wrapper("astral_utf16_to_utf32", astral_utf16_to_utf32_ref,
                                 _build.check_units, torch.int32, 1, """
    uint16[n] -> (int32[n], flag): ``w[:length]`` (all surrogate pairs) as
    UTF-32, ``length // 2`` words then zeros.""")

bmp_narrow_utf16 = _wrapper("bmp_narrow_utf16", bmp_narrow_utf16_ref, _build.check_words,
                            torch.uint16, 2, """
    int32[n] -> (uint16[2n], flag): ``w[:length]`` (all at most 0xFFFF, no
    surrogate) as UTF-16 (LE, or BE when ``be``), ``length`` units then
    zeros.""")

astral_utf32_to_utf16 = _wrapper("astral_utf32_to_utf16", astral_utf32_to_utf16_ref,
                                 _build.check_words, torch.uint16, 2, """
    int32[n] -> (uint16[2n], flag): ``w[:length]`` (all in
    0x10000-0x10FFFF) as UTF-16 surrogate pairs, ``2 * length`` units then
    zeros.""")
