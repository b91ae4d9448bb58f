"""General-path validating UTF-32 -> UTF-8 transcode.

Port of the UTF-32 -> UTF-8 direction of simdutf_tpu/kernels/butterflyx
(``u32_to_utf8_compose``: the Pallas phase B driver ``_run_phase_b`` with
its ``_kernel_u32_to_u8`` body, and butterfly16's phase C for the byte
placement) with the contract of the JAX package's final result: on a CUDA
tensor :func:`u32_to_utf8_compose` launches the count pass and the emit
pass of csrc/composex.cu, with ops/common.tile_glue between them; on a CPU
tensor it runs :func:`u32_to_utf8_compose_ref`.

The butterfly returns ``err_any`` and its caller reruns the scatter engine
(ops/utf32.to_utf8) on any error; that engine writes every in-range word's
bytes (a word above 0x10FFFF as the one byte 0x00, a surrogate as its 3
bytes) and does not zero the buffer past ``out_len``. This kernel gives
that final buffer in one pass: its emit pass writes every word's bytes
through ``total``. So on invalid input ``total`` differs from
``utf8_length``, which counts a too-large word as 4 bytes. The traffic
floor is HBM bytes (two reads of the words, one write of the bytes).
Tiles are 2048 words (256 threads x 8), with no alignment demand on the
buffer size: the ragged last tile is masked.
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.common import BIG, tile_glue

TILE = 2048  # words per block; = TILE in csrc/composex.cu


def u32_to_utf8_compose_ref(w: torch.Tensor, length: int):
    """Plain version (ops/utf32's scan -> scatter engine), in the compose
    contract. See :func:`u32_to_utf8_compose`."""
    from ..ops import utf32 as o32

    err_pos, err_code, out, total, err_len = o32._utf8_general_parts(w, length)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


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
    dev = w.device
    out = torch.zeros(4 * n, dtype=torch.uint8, device=dev)
    nt = -(-length // TILE)
    if nt == 0:  # nothing in range: nothing to launch
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return out, z, z != 0, z + BIG, z, z
    counts = torch.empty(nt, dtype=torch.int32, device=dev)
    keys = torch.empty(nt, dtype=torch.int64, device=dev)
    prefix = torch.empty(nt, dtype=torch.int32, device=dev)
    _build.call("composex_count", w.data_ptr(), length, nt,
                counts.data_ptr(), keys.data_ptr(), prefix.data_ptr())

    off, total, err_any, err_pos, err_code, err_len, _ = tile_glue(
        counts, keys, prefix)

    _build.call("composex_emit", w.data_ptr(), length, nt, off.data_ptr(),
                out.data_ptr())
    _build.count_launch("utf32_to_utf8_compose")
    return out, total, err_any, err_pos, err_code, err_len
