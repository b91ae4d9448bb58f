"""TorchImplementation: host glue around the torch ops (port of
simdutf_tpu/ops/impl.py, with the host methods that its XLAImplementation
inherits from simdutf_tpu/implementation.py: validation and counts, the
transcode matrix over ASCII, UTF-8, UTF-16LE/BE, UTF-32 and Latin-1, the
UTF-16 utilities, trim_partial, encoding detection, and forgiving base64
with its capacity-limited decode).

Inputs are padded to the JAX package's buckets (power of two >= 1 Ki
elements with 8 slack elements, 16 Mi steps above 64 Mi; elements are
bytes for UTF-8, units for UTF-16 and words for UTF-32), so both packages
see the same padded buffer and their full outputs compare bit for bit.
The logical length travels beside the buffer. Methods take and return
numpy arrays. The class holds only what the port computes: a method that
is not ported does not exist.
"""

from __future__ import annotations

import numpy as np
import torch

from . import base64_host as bh
from . import runtime
from . import trace
from . import trim_host as th
from .encodings import check_bom, encoding_type
from .errors import Result, error_code as ec
from .kernels import validate as kv
from .ops import base64_ops as ob
from .ops import detect as odet
from .ops import latin1 as ol1
from .ops import utf8 as o8
from .ops import utf16 as o16
from .ops import utf32 as o32

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
    as simdutf_tpu/ops/impl._pad builds it. The buffer is pooled
    (runtime.staging_buffer): borrowed until the next call of the same
    size on this thread."""
    n = int(arr.shape[0])
    out = runtime.staging_buffer(_bucket(n, multiple), arr.dtype, n)
    out[:n] = arr
    return out, np.int32(n)


def to_device(buf: np.ndarray, length, device) -> tuple[torch.Tensor, int]:
    """The staging state both packages share, ``(np.uint8[cap],
    np.uint16[cap] or np.uint32[cap], length)`` from :func:`_pad`, as
    ``(tensor on device, int length)``: uint8, uint16, or int32 holding
    the uint32 words' bits."""
    return runtime.to_device(buf, torch.device(device)), int(length)


def _res(code, pos) -> Result:
    return Result(ec(int(code)), int(pos))


def _scalars(*ts: torch.Tensor) -> list:
    """The 0-d tensors ``ts`` as Python numbers, in one read."""
    return trace.sync("impl.scalars", torch.Tensor.tolist, torch.stack(ts))


def _int(t: torch.Tensor) -> int:
    """The 0-d tensor ``t`` as a Python int."""
    return trace.sync("impl.scalar", int, t)


def _cpu(t: torch.Tensor) -> np.ndarray:
    """The tensor ``t`` as a numpy array on the host."""
    return trace.sync("impl.cut", torch.Tensor.cpu, t).numpy()


@trace.spanned("simdutf.glue.result")
def _cut(out: torch.Tensor, out_len: int) -> np.ndarray:
    """The first ``out_len`` uint16 units as a numpy array."""
    return _cpu(out[:out_len].view(torch.int16)).view(np.uint16)


@trace.spanned("simdutf.glue.result")
def _cut8(out: torch.Tensor, out_len: int) -> np.ndarray:
    """The first ``out_len`` bytes as a numpy array."""
    return _cpu(out[:out_len])


@trace.spanned("simdutf.glue.result")
def _cut32(out: torch.Tensor, out_len: int) -> np.ndarray:
    """The first ``out_len`` int32 words as a numpy uint32 array."""
    return _cpu(out[:out_len]).view(np.uint32)


def _converted(code, pos, out, out_len, cut):
    """(Result, output) of a validating conversion: one read of the
    scalars, then the output's."""
    with trace.span("simdutf.glue.result"):
        code, pos, out_len = _scalars(code, pos, out_len)
        # success count = code units written (error.h:36-38)
        res = Result(ec.SUCCESS, out_len) if code == 0 else Result(ec(code), pos)
    return res, cut(out, out_len)


def _valid(out_total, cut) -> np.ndarray:
    """The output of a conversion that reports no error: ``(out, total)``
    cut to ``total``."""
    out, total = out_total
    return cut(out, _int(total))


class TorchImplementation:
    """Every method of the JAX package's normal tier: the validating and
    valid transcodes between UTF-8, UTF-16LE/BE, UTF-32 and Latin-1, with
    ASCII, UTF-8, UTF-16 and UTF-32 validation and counts, the UTF-16
    utilities, trim_partial, encoding detection, and forgiving base64
    decode (uint8 and char16 input, every option and last-chunk mode,
    capacity-limited too) and encode, on torch tensors on one explicit
    device: Hopper kernels on a CUDA device of compute capability 9.0,
    their plain torch versions on the CPU. Nothing falls back to another
    implementation."""

    name = "torch"
    description = "PyTorch ops + hand-written Hopper kernels (CUDA sm_90a)"

    def __init__(self, device="cuda"):
        runtime.tune_host_allocator()
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

    @trace.spanned("simdutf.glue.stage")
    def _stage(self, arr: np.ndarray, multiple: int = 4):
        """np.uint8 bytes, np.uint16 units or np.uint32 words -> (padded
        tensor, length)."""
        return to_device(*_pad(arr, multiple), self.device)

    # -- validation ----------------------------------------------------------
    def validate_ascii(self, b):
        return self.validate_ascii_with_errors(b).is_ok

    def validate_ascii_with_errors(self, b):
        code, pos = o8.validate_ascii_with_errors(*self._stage(b))
        return _res(*_scalars(code, pos))

    def validate_utf8(self, b):
        return self.validate_utf8_with_errors(b).is_ok

    def validate_utf8_with_errors(self, b):
        code, pos = o8.validate_with_errors(*self._stage(b))
        return _res(*_scalars(code, pos))

    # -- counts / lengths ----------------------------------------------------
    def count_utf8(self, b):
        return _int(o8.count_code_points(*self._stage(b)))

    def utf16_length_from_utf8(self, b):
        return _int(o8.utf16_length(*self._stage(b)))

    def utf32_length_from_utf8(self, b):
        return self.count_utf8(b)

    def latin1_length_from_utf8(self, b):
        return self.count_utf8(b)

    def utf8_length_from_latin1(self, b):
        return _int(kv.latin1_utf8_length(*self._stage(b)))

    # -- conversions ---------------------------------------------------------
    def convert_utf8_to_utf16le_with_errors(self, b):
        return _converted(*o8.to_utf16(*self._stage(b), False), _cut)

    def convert_utf8_to_utf16be_with_errors(self, b):
        return _converted(*o8.to_utf16(*self._stage(b), True), _cut)

    def convert_valid_utf8_to_utf16le(self, b):
        out, total = o8.to_utf16_valid(*self._stage(b), False)
        return _cut(out, _int(total))

    def convert_valid_utf8_to_utf16be(self, b):
        out, total = o8.to_utf16_valid(*self._stage(b), True)
        return _cut(out, _int(total))

    # -- UTF-16 validation ---------------------------------------------------
    def validate_utf16le(self, w):
        return self.validate_utf16le_with_errors(w).is_ok

    def validate_utf16be(self, w):
        return self.validate_utf16be_with_errors(w).is_ok

    def _validate16(self, w, big_endian: bool):
        code, pos = o16.validate_with_errors(*self._stage(w), big_endian)
        return _res(*_scalars(code, pos))

    def validate_utf16le_with_errors(self, w):
        return self._validate16(w, False)

    def validate_utf16be_with_errors(self, w):
        return self._validate16(w, True)

    # -- UTF-16 counts / lengths ---------------------------------------------
    def count_utf16le(self, w):
        return _int(o16.count_code_points(*self._stage(w), False))

    def count_utf16be(self, w):
        return _int(o16.count_code_points(*self._stage(w), True))

    def utf8_length_from_utf16le(self, w):
        return _int(o16.utf8_length(*self._stage(w), False))

    def utf8_length_from_utf16be(self, w):
        return _int(o16.utf8_length(*self._stage(w), True))

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
        return _cut8(out, _int(total))

    def convert_valid_utf16be_to_utf8(self, w):
        out, total = o16.to_utf8_valid(*self._stage(w), True)
        return _cut8(out, _int(total))

    # -- UTF-32 validation and lengths --------------------------------------
    def validate_utf32(self, w):
        return self.validate_utf32_with_errors(w).is_ok

    def validate_utf32_with_errors(self, w):
        code, pos = o32.validate_with_errors(*self._stage(w))
        return _res(*_scalars(code, pos))

    def utf8_length_from_utf32(self, w):
        return _int(o32.utf8_length(*self._stage(w)))

    def utf16_length_from_utf32(self, w):
        return _int(o32.utf16_length(*self._stage(w)))

    # -- UTF-8 <-> UTF-32 ----------------------------------------------------
    def convert_utf8_to_utf32_with_errors(self, b):
        return _converted(*o8.to_utf32(*self._stage(b)), _cut32)

    def convert_valid_utf8_to_utf32(self, b):
        out, total = o8.to_utf32_valid(*self._stage(b))
        return _cut32(out, _int(total))

    def convert_utf32_to_utf8_with_errors(self, w):
        return _converted(*o32.to_utf8(*self._stage(w)), _cut8)

    def convert_valid_utf32_to_utf8(self, w):
        out, total = o32.to_utf8_valid(*self._stage(w))
        return _cut8(out, _int(total))

    # -- UTF-16 <-> UTF-32 ---------------------------------------------------
    def convert_utf16le_to_utf32_with_errors(self, w):
        return _converted(*o16.to_utf32(*self._stage(w), False), _cut32)

    def convert_utf16be_to_utf32_with_errors(self, w):
        return _converted(*o16.to_utf32(*self._stage(w), True), _cut32)

    def convert_valid_utf16le_to_utf32(self, w):
        return _valid(o16.to_utf32_valid(*self._stage(w), False), _cut32)

    def convert_valid_utf16be_to_utf32(self, w):
        return _valid(o16.to_utf32_valid(*self._stage(w), True), _cut32)

    def convert_utf32_to_utf16le_with_errors(self, w):
        return _converted(*o32.to_utf16(*self._stage(w), False), _cut)

    def convert_utf32_to_utf16be_with_errors(self, w):
        return _converted(*o32.to_utf16(*self._stage(w), True), _cut)

    def convert_valid_utf32_to_utf16le(self, w):
        return _valid(o32.to_utf16_valid(*self._stage(w), False), _cut)

    def convert_valid_utf32_to_utf16be(self, w):
        return _valid(o32.to_utf16_valid(*self._stage(w), True), _cut)

    # -- x -> Latin-1 --------------------------------------------------------
    def convert_utf8_to_latin1_with_errors(self, b):
        return _converted(*o8.to_latin1(*self._stage(b)), _cut8)

    def convert_valid_utf8_to_latin1(self, b):
        return _valid(o8.to_latin1_valid(*self._stage(b)), _cut8)

    def convert_utf16le_to_latin1_with_errors(self, w):
        return _converted(*o16.to_latin1(*self._stage(w), False), _cut8)

    def convert_utf16be_to_latin1_with_errors(self, w):
        return _converted(*o16.to_latin1(*self._stage(w), True), _cut8)

    def convert_valid_utf16le_to_latin1(self, w):
        return _valid(o16.to_latin1_valid(*self._stage(w), False), _cut8)

    def convert_valid_utf16be_to_latin1(self, w):
        return _valid(o16.to_latin1_valid(*self._stage(w), True), _cut8)

    def convert_utf32_to_latin1_with_errors(self, w):
        return _converted(*o32.to_latin1(*self._stage(w)), _cut8)

    def convert_valid_utf32_to_latin1(self, w):
        return _valid(o32.to_latin1_valid(*self._stage(w)), _cut8)

    # -- Latin-1 -> x --------------------------------------------------------
    def convert_latin1_to_utf8(self, b):
        return _valid(ol1.to_utf8(*self._stage(b)), _cut8)

    def convert_latin1_to_utf16le(self, b):
        x, n = self._stage(b)
        return _cut(ol1.to_utf16(x, n, False), n)

    def convert_latin1_to_utf16be(self, b):
        x, n = self._stage(b)
        return _cut(ol1.to_utf16(x, n, True), n)

    def convert_latin1_to_utf32(self, b):
        x, n = self._stage(b)
        return _cut32(ol1.to_utf32(x, n), n)

    # -- Latin-1 lengths: arithmetic, one unit per character -----------------
    def latin1_length_from_utf16(self, length: int) -> int:
        return length

    def latin1_length_from_utf32(self, length: int) -> int:
        return length

    def utf16_length_from_latin1(self, length: int) -> int:
        return length

    def utf32_length_from_latin1(self, length: int) -> int:
        return length

    # -- UTF-16 utilities ----------------------------------------------------
    def change_endianness_utf16(self, w):
        x, n = self._stage(w)
        return _cut(o16.change_endianness(x), n)

    def to_well_formed_utf16le(self, w):
        x, n = self._stage(w)
        return _cut(o16.to_well_formed(x, n, False), n)

    def to_well_formed_utf16be(self, w):
        x, n = self._stage(w)
        return _cut(o16.to_well_formed(x, n, True), n)

    def trim_partial_utf8(self, b) -> int:
        return th.trim_partial_utf8(b)

    def trim_partial_utf16le(self, w) -> int:
        return th.trim_partial_utf16(w, big_endian=False)

    def trim_partial_utf16be(self, w) -> int:
        return th.trim_partial_utf16(w, big_endian=True)

    # -- encoding detection --------------------------------------------------
    def autodetect_encoding(self, b) -> encoding_type:
        """The BOM, else the first of UTF-8, UTF-16LE and UTF-32LE that
        validates (src/implementation.cpp:44-76)."""
        bom = check_bom(b[:4].tobytes())
        if bom != encoding_type.unspecified:
            return bom
        n = int(b.shape[0])
        if self.validate_utf8(b):
            return encoding_type.UTF8
        if n % 2 == 0 and self.validate_utf16le(b.view(np.uint16)):
            return encoding_type.UTF16_LE
        if n % 4 == 0 and self.validate_utf32(b.view(np.uint32)):
            return encoding_type.UTF32_LE
        return encoding_type.unspecified

    def detect_encodings(self, b) -> int:
        """The BOM's encoding, else the bit set of the encodings that
        validate, from one launch of the detect kernel."""
        bom = check_bom(b[:4].tobytes())
        if bom != encoding_type.unspecified:
            return int(bom)
        n = int(b.shape[0])
        ok8, ok16, ok32 = _scalars(*odet.detect_encodings(*self._stage(b)))
        out = int(encoding_type.UTF8) if ok8 else 0
        if n % 2 == 0 and ok16:
            out |= int(encoding_type.UTF16_LE)
        if n % 4 == 0 and ok32:
            out |= int(encoding_type.UTF32_LE)
        return out

    # -- base64 --------------------------------------------------------------
    def maximal_binary_length_from_base64(self, src) -> int:
        return bh.maximal_binary_length(src)

    def base64_length_from_binary(self, length: int, options: int = 0) -> int:
        return bh.base64_length_from_binary(length, options)

    def base64_to_binary_details(self, src, options=0, last_chunk=bh.LOOSE):
        garbage = bh.ignore_garbage(options)
        tab_np = bh.value_table(options)

        srclen, pad_count, pad_pos = bh.b64_strip(src, tab_np, garbage)
        if srclen == 0:
            return bh.b64_finish(0, pad_count, pad_pos, garbage,
                                 last_chunk, 0, 0, 0, None, None, 0)

        first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start = (
            ob.decode_bulk_routed(
                *self._stage(src[:srclen]),
                url=bool(options & bh.BASE64_URL),
                both=bool(options & bh.BASE64_DEFAULT_OR_URL),
            )
        )
        # one sync for the scalars and the tail; then only the bytes of
        # whole quads come back (b64_finish cuts them further on error)
        first_bad, nvalid, nvalid_at_bad, tail_start, *tail = trace.sync(
            "impl.base64", torch.Tensor.tolist, torch.cat([
                torch.stack([first_bad, nvalid, nvalid_at_bad, tail_start]),
                tail_vals.to(torch.int64)]))
        return bh.b64_finish(
            srclen, pad_count, pad_pos, garbage, last_chunk,
            first_bad, nvalid, nvalid_at_bad,
            _cut8(packed, nvalid // 4 * 3), np.array(tail, np.uint8), tail_start,
        )

    def binary_to_base64(self, src, options=0):
        n = int(src.shape[0])
        nfull = n // 3 * 3
        # 1536-multiple buckets, as the JAX package pads them (encode_bulk
        # runs the encode kernel on them)
        x, _ = self._stage(src[:nfull], multiple=1536)
        body = _cut8(ob.encode_bulk(x, bool(options & bh.BASE64_URL)),
                     nfull // 3 * 4)
        tail = bh.encode_tail(src[nfull:], options)
        return np.concatenate([body, tail])

    def base64_to_binary_safe(self, src, capacity: int, options: int = 0,
                              last_chunk: int = bh.LOOSE,
                              decode_up_to_bad_char: bool = False):
        """Capacity-limited decode (implementation.h:3090-3208): returns
        (Result, out) with len(out) <= capacity. With enough capacity it
        is one :meth:`base64_to_binary_details` call; below the maximal
        length it is the host loop of base64_host, as in the JAX package."""
        return bh.decode_safe(src, capacity, options, last_chunk,
                              decode_up_to_bad_char,
                              details_fn=self.base64_to_binary_details)
