"""TorchImplementation: host glue around the torch ops (port of
simdutf_tpu/ops/impl.py for the UTF-8 -> UTF-16, UTF-16 -> UTF-8 and
forgiving base64 slices).

Inputs are padded to the JAX package's buckets (power of two >= 1 Ki
elements with 8 slack elements, 16 Mi steps above 64 Mi; elements are
bytes for UTF-8 and units for UTF-16), so both packages see the same
padded buffer and their full outputs compare bit for bit. The logical
length travels beside the buffer. Methods take and return numpy arrays,
as the public api expects; methods not overridden here fall back to the
golden tier of :class:`simdutf_tpu.implementation.Implementation`.
"""

from __future__ import annotations

import numpy as np
import torch

from simdutf_tpu.errors import FullResult, Result, error_code as ec
from simdutf_tpu.golden import base64_impl as gb
from simdutf_tpu.implementation import Implementation
from simdutf_tpu.runtime import staging_buffer

from . import runtime
from .kernels import validate as kv
from .ops import base64_ops as ob
from .ops import utf8 as o8
from .ops import utf16 as o16

_MIN_BUCKET = 1024
_POW2_CAP = 64 << 20
_BIG_STEP = 16 << 20


def _bucket(n: int, multiple: int = 4) -> int:
    """simdutf_tpu/ops/impl._bucket, value for value."""
    need = max(n + 8, _MIN_BUCKET)
    if need > _POW2_CAP:
        cap = -(-need // _BIG_STEP) * _BIG_STEP
    else:
        cap = 1 << (need - 1).bit_length()
    if cap % multiple:
        cap += multiple - cap % multiple
    return cap


def _pad(arr: np.ndarray, multiple: int = 4):
    """(zero-padded np buffer of _bucket(len) elements, np.int32 length),
    as simdutf_tpu/ops/impl._pad builds it."""
    n = int(arr.shape[0])
    out = staging_buffer((_bucket(n, multiple),), arr.dtype, fill_len=n,
                         tag="torch_pad1d")
    out[:n] = arr
    return out, np.int32(n)


def to_device(buf: np.ndarray, length, device) -> tuple[torch.Tensor, int]:
    """The staging state both packages share, ``(np.uint8[cap] or
    np.uint16[cap], length)`` from :func:`_pad`, as ``(tensor of the same
    dtype on device, int length)``."""
    return runtime.to_device(buf, torch.device(device)), int(length)


def _res(code, pos) -> Result:
    return Result(ec(int(code)), int(pos))


def _cut(out: torch.Tensor, out_len: int) -> np.ndarray:
    """The first ``out_len`` uint16 units as a numpy array."""
    return out[:out_len].view(torch.int16).cpu().numpy().view(np.uint16)


def _cut8(out: torch.Tensor, out_len: int) -> np.ndarray:
    """The first ``out_len`` bytes as a numpy array."""
    return out[:out_len].cpu().numpy()


def _converted(code, pos, out, out_len, cut):
    """(Result, output) of a validating conversion, after one sync."""
    code, pos, out_len = torch.stack([code, pos, out_len]).tolist()
    if code == 0:
        # success count = code units written (error.h:36-38)
        return Result(ec.SUCCESS, out_len), cut(out, out_len)
    return Result(ec(code), pos), cut(out, out_len)


# -- base64 host helpers: simdutf_tpu/ops/impl.py:123-265, copied because
# that module imports jax ---------------------------------------------------

def b64_strip(src, tab_np, garbage: bool):
    """Prologue strip (generic/base64.h:50-73): trailing whitespace and up
    to two '=' signs. Returns (srclen, pad_count, pad_pos).
    Vectorized backward scan in growing chunks — O(trailing)."""
    eq = ord("=")

    def strip_ws(end: int) -> int:
        step = 64
        while end > 0:
            lo = max(0, end - step)
            chunk = np.asarray(src[lo:end])
            vals = np.where(
                chunk > 0xFF, 255, tab_np[np.minimum(chunk, 0xFF)]
            )
            nonws = np.flatnonzero(vals != 64)
            if len(nonws):
                return lo + int(nonws[-1]) + 1
            end = lo
            step *= 4
        return 0

    srclen = int(src.shape[0])
    pad_pos, pad_count = srclen, 0
    if not garbage:
        srclen = strip_ws(srclen)
        if srclen > 0 and int(src[srclen - 1]) == eq:
            pad_pos, srclen, pad_count = srclen - 1, srclen - 1, 1
            srclen = strip_ws(srclen)
            if srclen > 0 and int(src[srclen - 1]) == eq:
                pad_pos, srclen, pad_count = srclen - 1, srclen - 1, 2
    return srclen, pad_count, pad_pos


def b64_tail_epilogue(
    outlen: int,
    idx: int,
    tail: list,
    tail_start: int,
    srclen: int,
    pad_count: int,
    pad_pos: int,
    garbage: bool,
    last_chunk: int,
):
    """Last-chunk + padding-consistency semantics shared by the single-chip
    and sharded base64 decoders (scalar/base64.h:135-216 tail modes and the
    generic/base64.h:228-244 padding checks).

    ``outlen``: bytes decoded from full quads; ``idx``/``tail``: leftover
    (<4) char count and their 6-bit values; positions are global input
    indices. Returns (FullResult, extra uint8 bytes to append).
    """
    none = np.zeros(0, dtype=np.uint8)
    w = outlen
    extra = none
    if idx != 0 or (not garbage and pad_count > 0):
        if (
            not garbage
            and last_chunk == gb.STRICT
            and idx != 1
            and ((idx + pad_count) & 3) != 0
        ):
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, w), none
        if (
            not garbage
            and last_chunk == gb.STOP_BEFORE_PARTIAL
            and ((idx + pad_count) & 3) != 0
        ):
            start = tail_start if idx > 0 else srclen
            return FullResult(ec.SUCCESS, start, w), none
        if idx == 2:
            t = tail[0] << 18 | tail[1] << 12
            if not garbage and last_chunk == gb.STRICT and (t & 0xFFFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, w), none
            extra = np.array([(t >> 16) & 0xFF], dtype=np.uint8)
            w += 1
        elif idx == 3:
            t = tail[0] << 18 | tail[1] << 12 | tail[2] << 6
            if not garbage and last_chunk == gb.STRICT and (t & 0xFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, w), none
            extra = np.array(
                [(t >> 16) & 0xFF, (t >> 8) & 0xFF], dtype=np.uint8
            )
            w += 2
        elif not garbage and idx == 1 and last_chunk != gb.STOP_BEFORE_PARTIAL:
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, w), none

    if not garbage and last_chunk != gb.STOP_BEFORE_PARTIAL and pad_count > 0:
        if (w % 3 == 0) or ((w % 3) + 1 + pad_count != 4):
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, w),
                extra,
            )
    return FullResult(ec.SUCCESS, srclen, w), extra


def b64_finish(
    srclen: int,
    pad_count: int,
    pad_pos: int,
    garbage: bool,
    last_chunk: int,
    first_bad: int,
    nvalid: int,
    nvalid_at_bad: int,
    packed: np.ndarray,
    tail_vals: np.ndarray,
    tail_start: int,
):
    """Host epilogue shared by the one-shot and batch decoders: turns one
    device decode's raw outputs into the (FullResult, bytes) contract."""
    empty = np.zeros(0, dtype=np.uint8)
    if srclen == 0:
        if not garbage and pad_count > 0:
            if last_chunk == gb.STRICT:
                return FullResult(ec.BASE64_INPUT_REMAINDER, 0, 0), empty
            if last_chunk == gb.STOP_BEFORE_PARTIAL:
                return FullResult(ec.SUCCESS, 0, 0), empty
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, 0),
                empty,
            )
        return FullResult(ec.SUCCESS, 0, 0), empty

    if not garbage and first_bad < srclen:
        nb = int(nvalid_at_bad)
        outlen = nb // 4 * 3
        return (
            FullResult(ec.INVALID_BASE64_CHARACTER, first_bad, outlen),
            np.asarray(packed)[:outlen],
        )

    nfull = nvalid // 4 * 4
    out = np.asarray(packed)[: nfull // 4 * 3]
    idx = nvalid - nfull
    tail = [int(t) for t in np.asarray(tail_vals)[:idx]]
    full, extra = b64_tail_epilogue(
        len(out), idx, tail, int(tail_start), srclen,
        pad_count, pad_pos, garbage, last_chunk,
    )
    if len(extra):
        out = np.concatenate([out, extra])
    return full, out


class TorchImplementation(Implementation):
    """The UTF-8 -> UTF-16 and UTF-16 -> UTF-8 slices, with validation and
    counts on either side, and forgiving base64 decode (uint8 and char16
    input, every option and last-chunk mode; ``base64_to_binary_safe``
    runs through :meth:`base64_to_binary_details`) and encode, on torch
    tensors on one explicit device: Hopper kernels on a CUDA device of
    compute capability 9.0, their plain torch versions on the CPU."""

    name = "torch"
    description = "PyTorch ops + hand-written Hopper kernels (CUDA sm_90a)"

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchImplementation('cuda'): CUDA is not available")
            cap = torch.cuda.get_device_capability(self.device)
            if cap != (9, 0):
                raise RuntimeError(
                    f"TorchImplementation('cuda'): needs compute capability "
                    f"(9, 0) (Hopper), found {cap}")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.description = f"{self.description} on {self.device}"

    def _stage(self, arr: np.ndarray):
        """np.uint8 bytes or np.uint16 units -> (padded tensor, length)."""
        return to_device(*_pad(arr), self.device)

    # -- validation ----------------------------------------------------------
    def validate_utf8(self, b):
        return self.validate_utf8_with_errors(b).is_ok

    def validate_utf8_with_errors(self, b):
        code, pos = o8.validate_with_errors(*self._stage(b))
        return _res(*torch.stack([code, pos]).tolist())

    # -- counts / lengths ----------------------------------------------------
    def count_utf8(self, b):
        return int(o8.count_code_points(*self._stage(b)))

    def utf16_length_from_utf8(self, b):
        return int(o8.utf16_length(*self._stage(b)))

    def utf32_length_from_utf8(self, b):
        return self.count_utf8(b)

    def latin1_length_from_utf8(self, b):
        return self.count_utf8(b)

    def utf8_length_from_latin1(self, b):
        return int(kv.latin1_utf8_length(*self._stage(b)))

    # -- conversions ---------------------------------------------------------
    def convert_utf8_to_utf16le_with_errors(self, b):
        return _converted(*o8.to_utf16(*self._stage(b), False), _cut)

    def convert_utf8_to_utf16be_with_errors(self, b):
        return _converted(*o8.to_utf16(*self._stage(b), True), _cut)

    def convert_valid_utf8_to_utf16le(self, b):
        out, total = o8.to_utf16_valid(*self._stage(b), False)
        return _cut(out, int(total))

    def convert_valid_utf8_to_utf16be(self, b):
        out, total = o8.to_utf16_valid(*self._stage(b), True)
        return _cut(out, int(total))

    # -- UTF-16 validation ---------------------------------------------------
    def validate_utf16le(self, w):
        return self.validate_utf16le_with_errors(w).is_ok

    def validate_utf16be(self, w):
        return self.validate_utf16be_with_errors(w).is_ok

    def _validate16(self, w, big_endian: bool):
        code, pos = o16.validate_with_errors(*self._stage(w), big_endian)
        return _res(*torch.stack([code, pos]).tolist())

    def validate_utf16le_with_errors(self, w):
        return self._validate16(w, False)

    def validate_utf16be_with_errors(self, w):
        return self._validate16(w, True)

    # -- UTF-16 counts / lengths ---------------------------------------------
    def count_utf16le(self, w):
        return int(o16.count_code_points(*self._stage(w), False))

    def count_utf16be(self, w):
        return int(o16.count_code_points(*self._stage(w), True))

    def utf8_length_from_utf16le(self, w):
        return int(o16.utf8_length(*self._stage(w), False))

    def utf8_length_from_utf16be(self, w):
        return int(o16.utf8_length(*self._stage(w), True))

    def utf32_length_from_utf16le(self, w):
        return self.count_utf16le(w)

    def utf32_length_from_utf16be(self, w):
        return self.count_utf16be(w)

    # -- UTF-16 -> UTF-8 -----------------------------------------------------
    def convert_utf16le_to_utf8_with_errors(self, w):
        return _converted(*o16.to_utf8(*self._stage(w), False), _cut8)

    def convert_utf16be_to_utf8_with_errors(self, w):
        return _converted(*o16.to_utf8(*self._stage(w), True), _cut8)

    def convert_valid_utf16le_to_utf8(self, w):
        out, total = o16.to_utf8_valid(*self._stage(w), False)
        return _cut8(out, int(total))

    def convert_valid_utf16be_to_utf8(self, w):
        out, total = o16.to_utf8_valid(*self._stage(w), True)
        return _cut8(out, int(total))

    # -- base64 --------------------------------------------------------------
    def base64_to_binary_details(self, src, options=0, last_chunk=gb.LOOSE):
        garbage = gb.ignore_garbage(options)
        tab_np = gb.value_table(options)

        srclen, pad_count, pad_pos = b64_strip(src, tab_np, garbage)
        if srclen == 0:
            return b64_finish(0, pad_count, pad_pos, garbage,
                              last_chunk, 0, 0, 0, None, None, 0)

        first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start = (
            ob.decode_bulk_routed(
                *self._stage(src[:srclen]),
                url=bool(options & gb.BASE64_URL),
                both=bool(options & gb.BASE64_DEFAULT_OR_URL),
            )
        )
        # one sync for the scalars and the tail; then only the bytes of
        # whole quads come back (b64_finish cuts them further on error)
        first_bad, nvalid, nvalid_at_bad, tail_start, *tail = torch.cat([
            torch.stack([first_bad, nvalid, nvalid_at_bad, tail_start]),
            tail_vals.to(torch.int64)]).tolist()
        return b64_finish(
            srclen, pad_count, pad_pos, garbage, last_chunk,
            first_bad, nvalid, nvalid_at_bad,
            _cut8(packed, nvalid // 4 * 3), np.array(tail, np.uint8), tail_start,
        )

    def binary_to_base64(self, src, options=0):
        n = int(src.shape[0])
        nfull = n // 3 * 3
        # 1536-multiple buckets, as the JAX package pads them (encode_bulk
        # runs the encode kernel on them)
        x, _ = to_device(*_pad(src[:nfull], multiple=1536), self.device)
        body = _cut8(ob.encode_bulk(x, bool(options & gb.BASE64_URL)),
                     nfull // 3 * 4)
        tail = gb.encode(src[nfull:], options)
        return np.concatenate([body, tail])
