"""Latin-1 ops on torch tensors (port of simdutf_tpu/ops/latin1.py): pure
widen and expand, no error paths.

Every function takes a padded 1-D ``torch.uint8`` buffer and the logical
``length`` (an int). On a CUDA tensor the kernel wrappers in
``simdutf_tpu_torch.kernels`` launch their Hopper kernels; on a CPU tensor
they run their plain versions.
"""

from __future__ import annotations

import torch

from .. import trace
from ..kernels import census as kcen
from ..kernels import composex as kcx
from ..kernels import transcode as ktr
from ..kernels import transcode32 as ktr32
from ..kernels import validate as kv
from .common import bytes_out, excl_scan, positions, routed_valid, scalar, scatter_writes


def utf8_length(b: torch.Tensor, length: int) -> torch.Tensor:
    return kv.latin1_utf8_length(b, length)


def _utf8_general(b: torch.Tensor, length: int):
    """The plain scan -> scatter engine (the JAX package's
    ``scatter_general`` of ``to_utf8``) and the compose kernel's plain
    version: 1 byte per byte below 0x80, 2 above. Returns (out uint8[2n],
    total)."""
    n = b.shape[0]
    dev = b.device
    x = b.to(torch.int32)
    in_r = positions(n, dev) < length
    hi = (x >= 0x80) & in_r
    off, inc = excl_scan(in_r.to(torch.int64) + hi)
    total = inc[n - 1] if n else scalar(0, dev)
    out = scatter_writes(2 * n, [(in_r, off, torch.where(hi, (x >> 6) | 0xC0, x)),
                                 (hi, off + 1, (x & 0x3F) | 0x80)], dev)
    return out.to(torch.uint8), total


def census(b: torch.Tensor, length: int):
    """(ascii, allhi) as Python bools from one census pass and one device
    sync: every in-range byte below 0x80; every one at or above 0x80, and
    at least one."""
    bits = kcen.read_bits("latin1.census", b, length)
    return ((bits & kcen.BIT_NONASCII) == 0,
            (bits & kcen.BIT_HASLO) == 0 and length > 0)


@trace.route
def to_utf8(b: torch.Tensor, length: int):
    """Returns (out uint8[2N], out_len), routed on the census: an all-ASCII
    buffer is a copy, an all-high one a fixed-rate 1:2 expand (plain torch,
    as in the JAX package), and mixed input takes the compose kernel
    (kernels/composex.latin1_to_utf8_compose). Bytes past out_len are
    zero."""
    n = b.shape[0]

    def br_ascii():
        return bytes_out(b.to(torch.int32), length, 2 * n), length

    def br_hi():
        x = b.to(torch.int32)
        by = torch.stack([(x >> 6) | 0xC0, (x & 0x3F) | 0x80], 1).reshape(-1)
        return bytes_out(by, 2 * length, 2 * n), 2 * length

    return routed_valid(census(b, length), (br_ascii, br_hi),
                        lambda: kcx.latin1_to_utf8_compose(b, length))


@trace.route
def to_utf16(b: torch.Tensor, length: int, big_endian: bool) -> torch.Tensor:
    """uint16[N]: every byte of the buffer widened, past ``length`` too (a
    whole-buffer widen, as in the JAX package): the ASCII widen kernel
    (kernels/transcode.ascii_widen_utf16) with the buffer's size as its
    length and its flag unread, the JAX ``pallas`` tier's own use of it."""
    return ktr.ascii_widen_utf16(b, b.shape[0], big_endian)[0]


@trace.route
def to_utf32(b: torch.Tensor, length: int) -> torch.Tensor:
    """int32[N] of uint32 words: every byte of the buffer widened, past
    ``length`` too (a whole-buffer widen, as in the JAX package): the
    Latin-1 widen kernel (kernels/transcode32.latin1_widen_utf32) with the
    buffer's size as its length and its flag unread, the JAX ``pallas``
    tier's own use of it."""
    return ktr32.latin1_widen_utf32(b, b.shape[0])[0]
