"""General-path transcodes of the butterflyx directions: UTF-32 -> UTF-8,
UTF-16 -> UTF-32, UTF-32 -> UTF-16 and Latin-1 -> UTF-8.

Port of simdutf_tpu/kernels/butterflyx (the Pallas phase B launcher
``_run_phase_b`` with its four bodies ``_kernel_u32_to_u8``,
``_kernel_u16_to_u32``, ``_kernel_u32_to_u16`` and ``_kernel_l1_to_u8``,
and the placements they reuse: butterfly16's phase C for bytes,
butterfly32's for words and ``_phase_c_u16`` for UTF-16 units) with the
contract of the JAX package's final result. On a CUDA tensor each wrapper
launches a count pass and an emit pass (csrc/composex.cu for the three
directions whose elements stand alone, on the emitter template of
csrc/emitx.cuh; csrc/composex16.cu for UTF-16 -> UTF-32, whose surrogate
pairs need a neighbour), with ops/common.tile_glue (or, for Latin-1, a
plain cumsum) between them;
on a CPU tensor it runs its ``_ref`` version, the scan -> scatter engine of
the ops module.

The butterflies return ``err_any`` and their callers rerun the scatter
engine on any error; that engine writes every in-range element's output
and does not zero the buffer past ``out_len``. Each kernel gives that
final buffer in one pass: its emit pass writes every element's output
through ``total``. So on invalid input ``total`` is not a length helper's
count: a UTF-32 word above 0x10FFFF emits the one byte or unit 0x0000, a
surrogate word its own encoding, a lone low surrogate nothing, and a high
surrogate the code point it makes with whatever unit follows it. The
traffic floor is HBM bytes (two reads of the input, one write of the
output). Tiles are 2048 elements (256 threads x 8), with no alignment
demand on the buffer size: the ragged last tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import BIG, tile_glue

TILE = 2048  # elements per block; = EMITX_TILE (emitx.cuh), TILE (composex16.cu)


def _count_and_glue(name: str, nt: int, dev, *args):
    """Launch count pass ``name`` (its C arguments ``args`` before the
    per-tile outputs) and glue its per-tile vectors without a host read:
    (off, total, err_any, err_pos, err_code, err_len)."""
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call(name, *args, nt, counts.data_ptr(), keys.data_ptr(),
                prefix.data_ptr())
    return tile_glue(counts, keys, prefix)[:6]


def u32_to_utf8_compose_ref(w: torch.Tensor, length: int):
    """Plain version (ops/utf32's scan -> scatter engine), in the compose
    contract. See :func:`u32_to_utf8_compose`."""
    from ..ops import utf32 as o32

    err_pos, err_code, out, total, err_len = o32._utf8_general_parts(w, length)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


@trace.kernel
def u32_to_utf8_compose(w: torch.Tensor, length: int):
    """Transcode the words ``w[:length]`` (int32 holding uint32 bits) to
    UTF-8. Returns (out uint8[4N], total, err_any, err_pos, err_code,
    err_len), the scalars as 0-d int64 tensors (err_any bool) on ``w``'s
    device:

    * ``out``: the bytes of every in-range word, zero past ``total``;
    * ``total``: bytes of the whole buffer (the output length if valid);
    * ``err_pos``/``err_code``: the first word above 0x10FFFF (TOO_LARGE)
      or in D800-DFFF (SURROGATE); BIG and 0 if none;
    * ``err_len``: the bytes before the error (0 if none)."""
    length = int(length)
    if _build.check_words(w, length) == "cpu":
        return u32_to_utf8_compose_ref(w, length)
    n = w.shape[0]
    out = torch.zeros(4 * n, dtype=torch.uint8, device=w.device)
    trace.count("compose.fill_bytes", out.nbytes)
    nt = -(-length // TILE)
    if nt == 0:
        return _build.nothing_in_range(out)
    off, total, err_any, err_pos, err_code, err_len = _count_and_glue(
        "composex_count", nt, w.device, w.data_ptr(), length)
    _build.call("composex_emit", w.data_ptr(), length, nt, off.data_ptr(),
                out.data_ptr())
    return out, total, err_any, err_pos, err_code, err_len


def u16_to_utf32_compose_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version (ops/utf16's scan -> scatter engine), in the compose
    contract. See :func:`u16_to_utf32_compose`."""
    from ..ops import utf16 as o16

    err_pos, err_code, out, total, err_len = o16._utf32_general_parts(
        w, length, be)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


@trace.kernel
def u16_to_utf32_compose(w: torch.Tensor, length: int, be: bool):
    """Transcode the units ``w[:length]`` (byte-swapped when ``be``) to
    UTF-32. Returns (out int32[N] of uint32 words, total, err_any, err_pos,
    err_code, err_len), the scalars as 0-d int64 tensors (err_any bool):

    * ``out``: one word per start (an in-range unit that is not a low
      surrogate), zero past ``total``;
    * ``total``: the starts of the whole buffer;
    * ``err_pos``/``err_code``: the first lone surrogate and SURROGATE
      (BIG and 0 if none);
    * ``err_len``: the starts before the error (0 if none)."""
    length = int(length)
    if _build.check_units(w, length) == "cpu":
        return u16_to_utf32_compose_ref(w, length, be)
    n = w.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=w.device)
    trace.count("compose.fill_bytes", out.nbytes)
    nt = -(-length // TILE)
    if nt == 0:
        return _build.nothing_in_range(out)
    off, total, err_any, err_pos, err_code, err_len = _count_and_glue(
        "u16_to_u32_count", nt, w.device, w.data_ptr(), length, int(be))
    _build.call("u16_to_u32_emit", w.data_ptr(), length, int(be), nt,
                off.data_ptr(), out.data_ptr())
    return out, total, err_any, err_pos, err_code, err_len


def u32_to_utf16_compose_ref(w: torch.Tensor, length: int, be: bool):
    """Plain version (ops/utf32's scan -> scatter engine), in the compose
    contract. See :func:`u32_to_utf16_compose`."""
    from ..ops import utf32 as o32

    err_pos, err_code, out, total, err_len = o32._utf16_general_parts(
        w, length, be)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


@trace.kernel
def u32_to_utf16_compose(w: torch.Tensor, length: int, be: bool):
    """Transcode the words ``w[:length]`` (int32 holding uint32 bits) to
    UTF-16 (units byte-swapped when ``be``). Returns (out uint16[2N],
    total, err_any, err_pos, err_code, err_len), the scalars as 0-d int64
    tensors (err_any bool):

    * ``out``: the 1 or 2 units of every in-range word, zero past ``total``;
    * ``total``: units of the whole buffer;
    * ``err_pos``/``err_code``: the first word above 0x10FFFF (TOO_LARGE)
      or in D800-DFFF (SURROGATE); BIG and 0 if none;
    * ``err_len``: the units before the error (0 if none)."""
    length = int(length)
    if _build.check_words(w, length) == "cpu":
        return u32_to_utf16_compose_ref(w, length, be)
    n = w.shape[0]
    out = torch.zeros(2 * n, dtype=torch.int16, device=w.device)
    out = out.view(torch.uint16)
    trace.count("compose.fill_bytes", out.nbytes)
    nt = -(-length // TILE)
    if nt == 0:
        return _build.nothing_in_range(out)
    off, total, err_any, err_pos, err_code, err_len = _count_and_glue(
        "u32_to_u16_count", nt, w.device, w.data_ptr(), length)
    _build.call("u32_to_u16_emit", w.data_ptr(), length, int(be), nt,
                off.data_ptr(), out.data_ptr())
    return out, total, err_any, err_pos, err_code, err_len


def latin1_to_utf8_compose_ref(b: torch.Tensor, length: int):
    """Plain version (ops/latin1's scan -> scatter engine). See
    :func:`latin1_to_utf8_compose`."""
    from ..ops import latin1 as ol1

    return ol1._utf8_general(b, length)


@trace.kernel
def latin1_to_utf8_compose(b: torch.Tensor, length: int):
    """Transcode the Latin-1 bytes ``b[:length]`` to UTF-8. Returns (out
    uint8[2N], total): the 1 or 2 bytes of every in-range byte, zero past
    ``total``, the output length as a 0-d int64 tensor. Latin-1 has no
    invalid input, so the glue is a cumsum of the tile counts."""
    length = int(length)
    if _build.check_bytes(b, length) == "cpu":
        return latin1_to_utf8_compose_ref(b, length)
    n = b.shape[0]
    out = torch.zeros(2 * n, dtype=torch.uint8, device=b.device)
    trace.count("compose.fill_bytes", out.nbytes)
    nt = -(-length // TILE)
    if nt == 0:
        return out, torch.zeros((), dtype=torch.int64, device=b.device)
    counts = torch.empty(nt, dtype=torch.int32, device=b.device)
    _build.call("latin1_utf8_count", b.data_ptr(), length, nt, counts.data_ptr())
    inc = torch.cumsum(counts, 0, dtype=torch.int64)
    off = inc - counts
    _build.call("latin1_utf8_emit", b.data_ptr(), length, nt, off.data_ptr(),
                out.data_ptr())
    return out, inc[-1]
