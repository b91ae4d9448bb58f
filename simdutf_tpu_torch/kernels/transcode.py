"""Fixed-rate UTF-8 <-> UTF-16 transcodes of one census class each.

Port of the class kernels of simdutf_tpu/kernels/transcode.py:
``ascii_widen_utf16`` (Pallas ``_widen_kernel``), ``uniform2_utf8_to_utf16``
(``_uniform2_kernel``), ``uniform3_utf8_to_utf16`` (``_uniform3_kernel``
behind ``_uniform3_pallas``), ``astral_utf8_to_utf16`` (``_wordmap_kernel``
behind ``astral_wordmap(..., "u8_to_u16")``), ``ascii_narrow_utf8``
(``_narrow_kernel``), ``uniform2_utf16_to_utf8`` (``_rev2_kernel``) and
``uniform3_utf16_to_utf8`` (``_rev3_kernel`` behind ``_rev3_pallas``). On a
CUDA tensor each wrapper launches its entry point of csrc/transcode.cu; on
a CPU tensor it runs its plain version ``<name>_ref`` beside it.

Each returns ``(out, flag)`` like the Pallas function: ``out`` the whole
output buffer (uint16[n] units from n bytes, uint8[3n] bytes from n
units): the class's output for ``[0, length)``, then zeros; ``flag`` a
0-d int32 tensor, nonzero when some in-range element lies outside the
class, left on the device. Where the Pallas kernels rely on zero padding
and a host trim, these take the length: elements at/after it read as zero
and never flag (a character whose first byte is in range is checked with
them), and nothing is written past the class output but zeros. On
flagged input the output is the plain version's (``ascii_narrow_utf8``
keeps each unit's low byte where the Pallas kernel keeps 7 bits). The
port's routes call these only on a class the census has proved, so they
never read the flag; the tests hold it at 0 there.

All seven kernels stream their bytes (floor: HBM bytes, the in-range input
read once and the whole output written once). ``uniform3_utf16_to_utf8``
runs the tiled bulk-copy kernel ``narrow3`` (:func:`narrow3_plan`); the
other six are grid-stride kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .. import trace
from ..ops.common import bswap16, bytes_out, positions, to_u16, zero_tail


def _flag(bad: torch.Tensor) -> torch.Tensor:
    return bad.any().to(torch.int32)


def class_chars(b: torch.Tensor, length: int, width: int):
    """The bytes of ``b`` (zero at/after ``length``) cut into ``width``-byte
    characters, a zero-filled last one when the buffer size is no
    multiple, each decoded as the class of its width: (cp, ok, first)
    int32/bool per character, its code point, whether it passes the
    class's check (the Pallas kernels' flag function: ``_u8_3byte_char``
    for width 3, ``_u8_4byte_cp`` for width 4) and whether its first byte
    is in range."""
    n = b.shape[0]
    x = zero_tail(b.to(torch.int32), length)
    m = -(-n // width) * width
    c = (torch.cat([x, x.new_zeros(m - n)]) if m > n else x).view(-1, width)
    first = positions(c.shape[0], b.device) * width < length
    c0 = c[:, 0]
    cont = ((c[:, 1:] & 0xC0) == 0x80).all(dim=1)
    if width == 1:
        return c0, c0 < 0x80, first
    if width == 2:
        cp = ((c0 & 0x1F) << 6) | (c[:, 1] & 0x3F)
        return cp, ((c0 & 0xE0) == 0xC0) & (c0 >= 0xC2) & cont, first
    if width == 3:
        cp = ((c0 & 0x0F) << 12) | ((c[:, 1] & 0x3F) << 6) | (c[:, 2] & 0x3F)
        ok = ((c0 & 0xF0) == 0xE0) & cont & (cp >= 0x800) & ((cp < 0xD800) | (cp > 0xDFFF))
        return cp, ok, first
    cp = (((c0 & 0x07) << 18) | ((c[:, 1] & 0x3F) << 12) | ((c[:, 2] & 0x3F) << 6)
          | (c[:, 3] & 0x3F))
    ok = ((c0 & 0xF8) == 0xF0) & cont & (cp >= 0x10000) & (cp <= 0x10FFFF)
    return cp, ok, first


def _units_out(u: torch.Tensor, cnt: int, n: int, be: bool) -> torch.Tensor:
    """uint16[n]: the low 16 bits of the first ``cnt`` of the int32 values
    ``u`` (byte-swapped when ``be``), zeros after them."""
    u = u & 0xFFFF
    u = zero_tail(bswap16(u) if be else u, cnt)[:n]
    return to_u16(torch.cat([u, u.new_zeros(n - u.shape[0])]))


def _native(w: torch.Tensor, length: int, be: bool) -> torch.Tensor:
    """ops/utf16.native: the units in native order as int32, zero at/after
    ``length``."""
    from ..ops import utf16 as o16

    return o16.native(w, length, be)


def _wrapper(name: str, ref, check, out_dtype: torch.dtype, per: int, doc: str,
             endian: bool = True):
    """The public function ``name`` of ``ref``'s module, in its kernel span:
    ``ref`` on a CPU tensor (``check`` validates the input), else one
    launch of entry point ``name`` into a fresh output buffer of
    ``per * n`` elements of ``out_dtype`` and a zeroed device flag.
    Without ``endian`` (UTF-8 <-> UTF-32, which have no byte order) the
    function takes no ``be`` and the launch passes 0."""

    def launch(x: torch.Tensor, length: int, be: bool):
        length = int(length)
        if check(x, length) == "cpu":
            return ref(x, length, be) if endian else ref(x, length)
        n = x.shape[0]
        if out_dtype == torch.uint16:  # allocated as int16, as every backend can
            out = torch.empty(per * n, dtype=torch.int16, device=x.device).view(torch.uint16)
        else:
            out = torch.empty(per * n, dtype=out_dtype, device=x.device)
        flag = torch.zeros(1, dtype=torch.int32, device=x.device)
        _build.call(name, x.data_ptr(), n, length, int(be), out.data_ptr(), flag.data_ptr())
        return out, flag[0]

    if endian:
        def wrapper(x: torch.Tensor, length: int, be: bool):
            return launch(x, length, be)
    else:
        def wrapper(x: torch.Tensor, length: int):
            return launch(x, length, False)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.__module__ = ref.__module__
    return trace.kernel(wrapper)


# --- UTF-8 -> UTF-16 -----------------------------------------------------------

def _widen_ref(b: torch.Tensor, length: int, be: bool, width: int):
    cp, ok, first = class_chars(b, length, width)
    return _units_out(cp, length // width, b.shape[0], be), _flag(~ok & first)


def ascii_widen_utf16_ref(b: torch.Tensor, length: int, be: bool):
    """Plain version: every in-range byte widened to a unit, zero after;
    the flag is any in-range byte >= 0x80."""
    return _widen_ref(b, length, be, 1)


def uniform2_utf8_to_utf16_ref(b: torch.Tensor, length: int, be: bool):
    """Plain version: each 2-byte character decoded to a unit, the first
    ``length // 2`` kept; the flag is any character with its first byte in
    range that is not ``C2..DF, 80..BF``."""
    return _widen_ref(b, length, be, 2)


def uniform3_utf8_to_utf16_ref(b: torch.Tensor, length: int, be: bool):
    """Plain version: each 3-byte character decoded to a unit, the first
    ``length // 3`` kept; the flag is any character with its first byte in
    range that fails ``_u8_3byte_char``'s structure, overlong or surrogate
    test."""
    return _widen_ref(b, length, be, 3)


def astral_utf8_to_utf16_ref(b: torch.Tensor, length: int, be: bool):
    """Plain version: each 4-byte character decoded to its surrogate pair,
    the first ``length // 4`` pairs kept; the flag is any character with
    its first byte in range that fails ``_u8_4byte_cp``'s structure or
    range test (0x10000-0x10FFFF)."""
    cp, ok, first = class_chars(b, length, 4)
    # 0xD800 + ((cp - 0x10000) >> 10) folded: 16 bits on any 21-bit cp
    u = torch.stack([0xD7C0 + (cp >> 10), 0xDC00 + (cp & 0x3FF)], dim=1).reshape(-1)
    return _units_out(u, length // 4 * 2, b.shape[0], be), _flag(~ok & first)


ascii_widen_utf16 = _wrapper("ascii_widen_utf16", ascii_widen_utf16_ref,
    _build.check_bytes, torch.uint16, 1, """
    uint8[n] -> (uint16[n], flag): ``b[:length]`` as ASCII in UTF-16 (LE,
    or BE when ``be``); the flag fires on a byte >= 0x80. Latin-1 bytes
    widen as their code points all the same.""")

uniform2_utf8_to_utf16 = _wrapper("uniform2_utf8_to_utf16", uniform2_utf8_to_utf16_ref,
    _build.check_bytes, torch.uint16, 1, """
    uint8[n] -> (uint16[n], flag): ``b[:length]`` as pure 2-byte UTF-8 in
    UTF-16, ``length // 2`` units then zeros.""")

uniform3_utf8_to_utf16 = _wrapper("uniform3_utf8_to_utf16", uniform3_utf8_to_utf16_ref,
    _build.check_bytes, torch.uint16, 1, """
    uint8[n] -> (uint16[n], flag): ``b[:length]`` as pure 3-byte UTF-8 in
    UTF-16, ``length // 3`` units then zeros.""")

astral_utf8_to_utf16 = _wrapper("astral_utf8_to_utf16", astral_utf8_to_utf16_ref,
    _build.check_bytes, torch.uint16, 1, """
    uint8[n] -> (uint16[n], flag): ``b[:length]`` as pure 4-byte UTF-8 in
    UTF-16, ``length // 4`` surrogate pairs then zeros.""")


# --- UTF-16 -> UTF-8 -----------------------------------------------------------

def ascii_narrow_utf8_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: each in-range unit's low byte, zeros to 3n; the flag
    is any in-range unit >= 0x80."""
    x = _native(w, length, be)
    return bytes_out(x, length, 3 * w.shape[0]), _flag(x >= 0x80)


def uniform2_utf16_to_utf8_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: 2 bytes per in-range unit, zeros to 3n; the flag is
    any in-range unit outside 0x80-0x7FF."""
    x = _native(w, length, be)
    by = torch.stack([(x >> 6) | 0xC0, (x & 0x3F) | 0x80], dim=1).reshape(-1)
    bad = ((x < 0x80) | (x > 0x7FF)) & (positions(x.shape[0], x.device) < length)
    return bytes_out(by, 2 * length, 3 * w.shape[0]), _flag(bad)


def uniform3_utf16_to_utf8_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version: 3 bytes per in-range unit, zeros after; the flag is
    any in-range unit below 0x800 or a surrogate."""
    x = _native(w, length, be)
    by = torch.stack([0xE0 | (x >> 12), 0x80 | ((x >> 6) & 0x3F), 0x80 | (x & 0x3F)],
                     dim=1).reshape(-1)
    bad = (((x < 0x800) | ((x >= 0xD800) & (x <= 0xDFFF)))
           & (positions(x.shape[0], x.device) < length))
    return bytes_out(by, 3 * length, 3 * w.shape[0]), _flag(bad)


#: units a tile of narrow3 (= N3_TILE in csrc/transcode.cu)
N3_TILE = 4096


def narrow3_split(w_addr: int, n: int, out_addr: int) -> tuple[int, int]:
    """Twin of csrc/transcode.cu's ``narrow3_split``: (head, ntiles) of
    ``n`` units at address ``w_addr`` with their output at ``out_addr``.
    Units [head, head + ntiles * N3_TILE) go by tiles, the rest (the head
    and the tail after the last whole tile) by element steps. ``head`` is
    the first unit whose input (2 bytes a unit) and output (3 bytes a
    unit) both lie on the 16-byte grid, when a whole tile follows it; else
    head = ntiles = 0 and every unit goes by steps."""
    for h in range(16):
        if (w_addr + 2 * h) % 16 == 0 and (out_addr + 3 * h) % 16 == 0:
            return (h, (n - h) // N3_TILE) if n - h >= N3_TILE else (0, 0)
    return 0, 0


def narrow3_parts(w_addr: int, n: int, out_addr: int):
    """(steps, tiles): the unit ranges [lo, hi) of narrow3's element steps
    and of its tiles, in the order the kernel numbers them (the head as
    one step, then the tail after the last whole tile in steps of 16)."""
    head, ntiles = narrow3_split(w_addr, n, out_addr)
    tail = head + ntiles * N3_TILE
    steps = ([(0, head)] if head else []) + [(q, min(q + 16, n)) for q in range(tail, n, 16)]
    return steps, [(head + g * N3_TILE, head + (g + 1) * N3_TILE) for g in range(ntiles)]


def narrow3_plan(w_addr: int, n: int, out_addr: int = 0) -> dict:
    """The launch plan of :func:`uniform3_utf16_to_utf8` on the current
    CUDA device for ``n`` units at ``w_addr`` into ``out_addr`` (0: an
    address on the 16-byte grid, as a fresh buffer's). Keys: grid,
    threads, blocks_per_sm, tile_units, stages, smem_bytes, head,
    ntiles."""
    plan = (ctypes.c_longlong * 8)()
    rc = _build.lib().narrow3_plan(int(w_addr), int(n), int(out_addr), plan)
    if rc != 0:
        raise RuntimeError(f"narrow3_plan: CUDA error {rc}")
    return dict(zip(("grid", "threads", "blocks_per_sm", "tile_units", "stages",
                     "smem_bytes", "head", "ntiles"), plan))


ascii_narrow_utf8 = _wrapper("ascii_narrow_utf8", ascii_narrow_utf8_ref,
    _build.check_units, torch.uint8, 3, """
    uint16[n] (byte-swapped units when ``be``) -> (uint8[3n], flag):
    ``w[:length]`` as ASCII UTF-8, ``length`` bytes then zeros.""")

uniform2_utf16_to_utf8 = _wrapper("uniform2_utf16_to_utf8", uniform2_utf16_to_utf8_ref,
    _build.check_units, torch.uint8, 3, """
    uint16[n] -> (uint8[3n], flag): ``w[:length]`` (all in 0x80-0x7FF) as
    UTF-8, ``2 * length`` bytes then zeros.""")

uniform3_utf16_to_utf8 = _wrapper("uniform3_utf16_to_utf8", uniform3_utf16_to_utf8_ref,
    _build.check_units, torch.uint8, 3, """
    uint16[n] -> (uint8[3n], flag): ``w[:length]`` (all in 0x800-0xFFFF,
    no surrogate) as UTF-8, ``3 * length`` bytes then zeros.""")
