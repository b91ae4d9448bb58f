"""General-path UTF-16LE/BE -> UTF-8 transcode, validating or valid-only.

Port of simdutf_tpu/kernels/butterfly16.to_utf8_compose (Pallas
``_phase_b16_kernel`` + ``_phase_c16_kernel``) with the same contract, but
not the same algorithm: on a CUDA tensor :func:`to_utf8_compose` makes one
launch of csrc/compose8.cu, a single pass with a decoupled look-back scan
across tiles (csrc/lookback.cuh, on its wide slots) that also writes the
zeros past out_len and the five scalars; on a CPU tensor it runs
:func:`to_utf8_compose_ref`.

The traffic floor is HBM bytes (one read of the units, one write of the
output bytes). The TPU engine compacts four candidate byte planes per
tile with roll/select butterflies because scatters were slow on that
chip; here a block-wide scan gives every unit its output slot, the bytes
are staged in shared memory, and each tile stores them as aligned 16-byte
chunks at the offset its look-back finds. Tiles are 8192 units (four rows
of 256 threads x 8 units), with no alignment demand on the buffer size:
the ragged last tile is masked.

In the validating mode ``total`` follows the butterfly's accounting:
every in-range surrogate emits 2 bytes, paired or not, so ``total`` equals
the "utf8len" count of kernels/utf16_kernels on every input, valid or not.
The valid-only mode follows the JAX package's ``convert_valid`` engine
(simdutf_tpu/ops/utf16.to_utf8_valid) on every input: a high surrogate
makes a code point with whatever unit follows it (0 past the length), a
low surrogate writes nothing, and nothing is clamped but the buffer's end.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..errors import error_code as ec
from .compose16 import tile_triples
from ..ops.common import BIG, positions, shift_left

TILE = 8192  # units per tile; = TILE in csrc/compose8.cu
_MODES = {"validate": 0, "valid": 1}


def _mode(mode: str) -> int:
    if mode not in _MODES:
        raise ValueError(f"unknown compose mode {mode!r}")
    return _MODES[mode]


def to_utf8_compose_ref(w: torch.Tensor, length: int, be: bool,
                        mode: str = "validate"):
    """Plain version (ops/utf16's scan -> scatter engines: the butterfly's
    accounting, or the valid-only one), in the compose contract. See
    :func:`to_utf8_compose`."""
    from ..ops import utf16 as o16

    if _mode(mode):
        out, total = o16._utf8_valid_parts(w, length, be)
        z = torch.zeros((), dtype=torch.int64, device=w.device)
        return out, total, z != 0, z + BIG, z, z
    err_pos, err_code, out, total, err_len = o16._utf8_general_parts(
        w, length, be)
    return out, total, err_pos != BIG, err_pos, err_code, err_len


@trace.kernel
def to_utf8_compose(w: torch.Tensor, length: int, be: bool,
                    mode: str = "validate"):
    """Transcode ``w[:length]`` (units byte-swapped when ``be``) to UTF-8.
    Returns (out uint8[3N], total, err_any, err_pos, err_code, err_len),
    the scalars as 0-d int64 tensors (err_any bool) on ``w``'s device.

    ``mode="validate"``:

    * ``total``: bytes of the whole buffer, 2 per surrogate (the output
      length if valid);
    * ``err_pos``/``err_code``: the first lone surrogate and SURROGATE
      (BIG and 0 if none);
    * ``err_len``: bytes of the valid prefix before the error (0 if none);
    * ``out`` is zero at/after ``err_len`` on error and ``total`` if valid.

    ``mode="valid"``: ``total`` and ``out`` are those of the JAX
    package's valid-only engine on any input (``total`` may exceed 3N,
    and ``out`` then holds its first 3N bytes); no error is reported
    (err_any False, err_pos BIG, err_code and err_len 0)."""
    length = int(length)
    valid = _mode(mode)
    if _build.check_units(w, length) == "cpu":
        return to_utf8_compose_ref(w, length, be, mode)
    n = w.shape[0]
    if length == 0:  # nothing in range: nothing to launch
        out = torch.zeros(3 * n, dtype=torch.uint8, device=w.device)
        trace.count("compose.fill_bytes", out.nbytes)
        return _build.nothing_in_range(out)
    nt = _tiles(length)
    out = torch.empty(3 * n, dtype=torch.uint8, device=w.device)
    return _build.lookback_compose("compose8", nt, out, w.data_ptr(), n, length,
                                   int(be), valid, nt)[0]


def _tiles(length: int) -> int:
    """Tiles of a call: only in-range units emit bytes."""
    return -(-length // TILE)


def tile_aggregates_ref(w: torch.Tensor, length: int, be: bool,
                        mode: str = "validate"):
    """Plain per-tile (bytes, least event key pos << 8 | SURROGATE, bytes
    before that key; BIG << 8 and the tile's bytes when it has no event)
    of the tiles of a call, each an int64 tensor, in either mode's
    accounting (the valid-only mode has no events)."""
    from ..ops import utf16 as o16

    n = w.shape[0]
    x = o16.native(w, length, be)
    idx = positions(n, w.device)
    in_r = idx < length
    if _mode(mode):
        hi = (x & 0xFC00) == 0xD800
        cp = torch.where(hi, ((x - 0xD800) << 10) + (shift_left(x, 1) - 0xDC00) + 0x10000, x)
        width = (in_r & ((x & 0xFC00) != 0xDC00)) * (
            1 + (cp > 0x7F).to(torch.int64) + (cp > 0x7FF) + (cp > 0xFFFF))
        key = torch.full((n,), BIG << 8, dtype=torch.int64, device=w.device)
    else:
        sur = (x & 0xF800) == 0xD800
        width = in_r * (1 + (x >= 0x80).to(torch.int64) + ((x >= 0x800) & ~sur))
        key = torch.where(o16.lone_surrogates(x, length), (idx << 8) | int(ec.SURROGATE),
                          BIG << 8)
    return tile_triples(width, key, _tiles(length), TILE)


def _tile_aggregates(w: torch.Tensor, length: int, be: bool, mode: str = "validate"):
    """The per-tile aggregates the kernel publishes for its look-back, as
    (count, key, before) int64 tensors, for tests: on a CUDA tensor read
    from the launch's wide slots (csrc/lookback.cuh: count, before and key,
    each | 2^63), on a CPU tensor the plain version's."""
    length = int(length)
    if _build.check_units(w, length) == "cpu" or length == 0:
        return tile_aggregates_ref(w, length, be, mode)
    n = w.shape[0]
    nt = _tiles(length)
    out = torch.empty(3 * n, dtype=torch.uint8, device=w.device)
    _, scratch = _build.lookback_compose("compose8", nt, out, w.data_ptr(), n, length,
                                         int(be), _mode(mode), nt)
    slots = scratch[16: 16 + 24 * nt].view(torch.int64).view(nt, 3) & (2**63 - 1)
    return slots[:, 0], slots[:, 2], slots[:, 1]
