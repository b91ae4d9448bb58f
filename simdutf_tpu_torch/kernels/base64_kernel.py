"""Fixed-rate base64 repacks: 4 codes -> 3 bytes and 3 bytes -> 4 chars.

Port of simdutf_tpu/kernels/base64_kernel.py's ``pack_sextets`` (Pallas
``_pack_kernel``), ``pack_words`` (``_pack_words_kernel``) and
``block_encode`` (``_encode_kernel``). The TPU kernels work on (R, 512),
(R, 128) and (R, 384) int32 word planes, with phase-plane subsamples and
roll/select butterflies so that no minor-dim array is padded to 128
lanes. All three are one function of a flat byte stream, so here one
CUDA kernel, ``b64_pack`` in csrc/base64.cu, serves both packs on the
flat code bytes, and ``b64_encode`` serves the encode; the word-plane
wrappers keep the JAX signatures. On a CUDA tensor :func:`pack` and
:func:`encode` launch their kernels; on a CPU tensor they run
:func:`pack_ref` and :func:`encode_ref`.

``clean_decode`` ports ``_clean_decode_pallas`` (``_decode_kernel``): the
4 -> 3 decode of whitespace-free char words with a flag for any char
outside the alphabet, on ``clean_decode`` in csrc/base64.cu (plain
version :func:`clean_decode_ref`). Only ``kernels.impl
.TorchPallasImplementation`` reaches it, as only the JAX package's
``PallasImplementation`` reaches the Pallas kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .. import trace
from ..ops.common import positions


def pack_ref(codes: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pack`: base64_kernel._pack_core on each
    group of 4 bytes, any byte values."""
    q = codes.to(torch.int32).reshape(-1, 4)
    t = (q[:, 0] << 18) | (q[:, 1] << 12) | (q[:, 2] << 6) | q[:, 3]
    out = torch.stack([(t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF], dim=1)
    return out.reshape(-1).to(torch.uint8)


@trace.kernel
def pack(codes: torch.Tensor) -> torch.Tensor:
    """uint8[n] code stream (n % 4 == 0) -> uint8[3n/4]: each group of 4
    codes c0..c3 becomes the 3 bytes of c0<<18 | c1<<12 | c2<<6 | c3."""
    n = codes.shape[0]
    if n % 4:
        raise ValueError(f"pack needs a multiple of 4 codes, got {n}")
    if _build.check_bytes(codes, n) == "cpu":
        return pack_ref(codes)
    out = torch.empty(n // 4 * 3, dtype=torch.uint8, device=codes.device)
    if n:
        _build.call("b64_pack", codes.data_ptr(), n // 4, out.data_ptr())
    return out


def _flat(w: torch.Tensor) -> torch.Tensor:
    """An int32 word array as its little-endian byte stream."""
    if w.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {w.dtype}")
    return w.contiguous().view(torch.uint8).reshape(-1)


def pack_sextets(w32: torch.Tensor) -> torch.Tensor:
    """(R, 512) int32 sextet-value words (4 codes per word, little-endian)
    -> (R, 384) int32 packed byte words, as base64_kernel.pack_sextets."""
    return pack(_flat(w32)).view(torch.int32).reshape(w32.shape[0], 384)


def pack_words(w128: torch.Tensor) -> torch.Tensor:
    """(R, 128) int32 sextet-value words (R % 4 == 0) -> (3R/4, 128) int32
    packed byte words, as base64_kernel.pack_words."""
    return pack(_flat(w128)).view(torch.int32).reshape(-1, 128)


def unclassify(v: torch.Tensor, url: bool) -> torch.Tensor:
    """6-bit value -> char byte (base64_kernel._unclassify)."""
    c = v + 65
    c = torch.where(v >= 26, v + 71, c)
    c = torch.where(v >= 52, v - 4, c)
    c = torch.where(v == 62, 45 if url else 43, c)
    return torch.where(v == 63, 95 if url else 47, c)


def encode_ref(data: torch.Tensor, url: bool) -> torch.Tensor:
    """Plain version of :func:`encode`."""
    d = data.to(torch.int32).reshape(-1, 3)
    t = (d[:, 0] << 16) | (d[:, 1] << 8) | d[:, 2]
    quads = torch.stack([t >> 18, (t >> 12) & 63, (t >> 6) & 63, t & 63], dim=1)
    return unclassify(quads.reshape(-1), url).to(torch.uint8)


@trace.kernel
def encode(data: torch.Tensor, url: bool) -> torch.Tensor:
    """uint8[n] bytes (n % 3 == 0) -> uint8[4n/3] chars of the default or,
    with ``url``, the URL alphabet."""
    n = data.shape[0]
    if n % 3:
        raise ValueError(f"encode needs a multiple of 3 bytes, got {n}")
    if _build.check_bytes(data, n) == "cpu":
        return encode_ref(data, url)
    out = torch.empty(n // 3 * 4, dtype=torch.uint8, device=data.device)
    if n:
        _build.call("b64_encode", data.data_ptr(), n // 3, int(url), out.data_ptr())
    return out


def block_encode(x32: torch.Tensor, url: bool = False) -> torch.Tensor:
    """(R, 384) int32 view of the payload -> (R, 512) int32 char stream
    (4 chars per word), as base64_kernel.block_encode."""
    return encode(_flat(x32), url).view(torch.int32).reshape(x32.shape[0], 512)


def clean_decode_ref(chars: torch.Tensor, nwords: int, url: bool = False,
                     both: bool = False):
    """Plain version of :func:`clean_decode` (base64_kernel._decode_core):
    the forgiving decode's classifier with whitespace (64 there) as 255,
    the Pallas ``_classify``."""
    from ..ops.base64_ops import classify_chars

    c = chars.to(torch.int32).view(-1, 4)
    live = (positions(c.shape[0], c.device) < nwords)[:, None]
    v = classify_chars(torch.where(live, c, 65), url, both)
    v = torch.where(v == 64, 255, v)
    flag = (v > 63).any().to(torch.int32)
    t = (v[:, 0] << 18) | (v[:, 1] << 12) | (v[:, 2] << 6) | v[:, 3]
    out = torch.stack([(t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF], dim=1)
    return out.reshape(-1).to(torch.uint8), flag


@trace.kernel
def clean_decode(chars: torch.Tensor, nwords: int, url: bool = False,
                 both: bool = False):
    """uint8[n] chars (n % 4 == 0) -> (uint8[3n/4], flag): each 4-char word
    below ``nwords`` decoded to its 3 bytes under the default, url or
    (``both``) either alphabet, the words from ``nwords`` on decoded as
    "AAAA" (zeros); ``flag`` a 0-d int32 tensor, 1 when a char of a word
    below ``nwords`` is outside the alphabet (whitespace and '=' too: the
    caller then takes the forgiving decode), left on the device. The
    Pallas function's (R, 384) int32 output is this byte stream."""
    n = chars.shape[0]
    nwords = int(nwords)
    if n % 4 or not 0 <= nwords <= n // 4:
        raise ValueError(f"clean_decode needs n % 4 == 0 and 0 <= nwords <= n / 4, "
                         f"got n={n}, nwords={nwords}")
    if _build.check_bytes(chars, n) == "cpu":
        return clean_decode_ref(chars, nwords, url, both)
    out = torch.empty(n // 4 * 3, dtype=torch.uint8, device=chars.device)
    flag = torch.zeros(1, dtype=torch.int32, device=chars.device)
    _build.call("clean_decode", chars.data_ptr(), n // 4, nwords, int(url), int(both),
                out.data_ptr(), flag.data_ptr())
    return out, flag[0]
