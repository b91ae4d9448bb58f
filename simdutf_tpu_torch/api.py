"""The port's public entry points: free functions with the names, arguments
and return contracts of simdutf_tpu/api.py, every one of them but the JAX
package's tier registry (whose job :func:`use_device` and
:func:`get_implementation` do here).

Conventions (those of the JAX package's api):
  * inputs are bytes-like or numpy arrays (uint8/uint16/uint32);
  * UTF-16/32 inputs given as bytes are raw storage (LE/BE per entry point;
    UTF-32 is little-endian);
  * ``validate_*`` -> bool;  ``*_with_errors`` -> Result;
  * ``convert_X_to_Y(data)`` -> output ``bytes`` (empty on error);
  * ``convert_X_to_Y_with_errors(data)`` -> (Result, bytes) where bytes is
    the output written up to the error;
  * counts/lengths -> int (positions in code units).
Un-suffixed UTF-16 entry points use the host's byte order.

Every call runs on one module-level :class:`TorchImplementation`, made at
the first call on ``"cuda"`` (which raises where there is no Hopper card).
``use_device("cpu")`` switches to the CPU, where each kernel runs its
plain torch version.
"""

from __future__ import annotations

import sys
import threading

import numpy as np

from . import base64_host as _bh
from .buffers import as_u8, as_u16, as_u32
from .encodings import bom_byte_size, check_bom, encoding_type, endianness, match_system  # noqa: F401
from .errors import FullResult, Result, error_code  # noqa: F401
from .impl import TorchImplementation

base64_default = _bh.BASE64_DEFAULT
base64_url = _bh.BASE64_URL
base64_reverse_padding = _bh.BASE64_REVERSE_PADDING
base64_default_no_padding = _bh.BASE64_DEFAULT_NO_PADDING
base64_url_with_padding = _bh.BASE64_URL_WITH_PADDING
base64_default_accept_garbage = _bh.BASE64_DEFAULT_ACCEPT_GARBAGE
base64_url_accept_garbage = _bh.BASE64_URL_ACCEPT_GARBAGE
base64_default_or_url = _bh.BASE64_DEFAULT_OR_URL
base64_default_or_url_accept_garbage = _bh.BASE64_DEFAULT_OR_URL_ACCEPT_GARBAGE
loose = _bh.LOOSE
strict = _bh.STRICT
stop_before_partial = _bh.STOP_BEFORE_PARTIAL

_lock = threading.Lock()
_active: TorchImplementation | None = None


def use_device(device) -> TorchImplementation:
    """Run every later call on ``device`` ("cuda", "cpu", a torch.device,
    or a TorchImplementation to use as it is); returns the implementation."""
    global _active
    impl = device if isinstance(device, TorchImplementation) else TorchImplementation(device)
    with _lock:
        _active = impl
    return impl


def get_implementation() -> TorchImplementation:
    """The implementation the calls run on, made on "cuda" at first use."""
    global _active
    with _lock:
        if _active is None:
            _active = TorchImplementation("cuda")
        return _active


_impl = get_implementation

#: host byte order decides what the un-suffixed UTF-16 entry points mean
_NATIVE_LE = sys.byteorder == "little"


def _out_bytes(arr: np.ndarray) -> bytes:
    return arr.tobytes()


def _cvt(with_errors_fn, data):
    res, out = with_errors_fn(data)
    return res, _out_bytes(out)


def _plain(with_errors_fn, data) -> bytes:
    res, out = with_errors_fn(data)
    return _out_bytes(out) if res.is_ok else b""


def _into(out_arr: np.ndarray, produced: np.ndarray) -> int:
    n = int(produced.shape[0])
    if n > int(out_arr.shape[0]):
        raise ValueError(
            f"output buffer too small: need {n} units, have {out_arr.shape[0]}")
    out_arr[:n] = produced
    return n


# ---------------------------------------------------------------------------
# validation


def validate_ascii(data) -> bool:
    return _impl().validate_ascii(as_u8(data))


def validate_ascii_with_errors(data) -> Result:
    return _impl().validate_ascii_with_errors(as_u8(data))


def validate_utf8(data) -> bool:
    return _impl().validate_utf8(as_u8(data))


def validate_utf8_with_errors(data) -> Result:
    return _impl().validate_utf8_with_errors(as_u8(data))


def validate_utf16le(data) -> bool:
    return _impl().validate_utf16le(as_u16(data))


def validate_utf16be(data) -> bool:
    return _impl().validate_utf16be(as_u16(data))


def validate_utf16(data) -> bool:
    return validate_utf16le(data) if _NATIVE_LE else validate_utf16be(data)


def validate_utf16le_with_errors(data) -> Result:
    return _impl().validate_utf16le_with_errors(as_u16(data))


def validate_utf16be_with_errors(data) -> Result:
    return _impl().validate_utf16be_with_errors(as_u16(data))


def validate_utf16_with_errors(data) -> Result:
    return (validate_utf16le_with_errors(data) if _NATIVE_LE
            else validate_utf16be_with_errors(data))


def validate_utf32(data) -> bool:
    return _impl().validate_utf32(as_u32(data))


def validate_utf32_with_errors(data) -> Result:
    return _impl().validate_utf32_with_errors(as_u32(data))


# ---------------------------------------------------------------------------
# counting / lengths


def count_utf8(data) -> int:
    return _impl().count_utf8(as_u8(data))


def count_utf16le(data) -> int:
    return _impl().count_utf16le(as_u16(data))


def count_utf16be(data) -> int:
    return _impl().count_utf16be(as_u16(data))


def count_utf16(data) -> int:
    return count_utf16le(data) if _NATIVE_LE else count_utf16be(data)


def utf16_length_from_utf8(data) -> int:
    return _impl().utf16_length_from_utf8(as_u8(data))


def utf32_length_from_utf8(data) -> int:
    return _impl().utf32_length_from_utf8(as_u8(data))


def latin1_length_from_utf8(data) -> int:
    return _impl().latin1_length_from_utf8(as_u8(data))


def utf8_length_from_utf16le(data) -> int:
    return _impl().utf8_length_from_utf16le(as_u16(data))


def utf8_length_from_utf16be(data) -> int:
    return _impl().utf8_length_from_utf16be(as_u16(data))


def utf8_length_from_utf16(data) -> int:
    return utf8_length_from_utf16le(data) if _NATIVE_LE else utf8_length_from_utf16be(data)


def utf32_length_from_utf16le(data) -> int:
    return _impl().utf32_length_from_utf16le(as_u16(data))


def utf32_length_from_utf16be(data) -> int:
    return _impl().utf32_length_from_utf16be(as_u16(data))


def utf32_length_from_utf16(data) -> int:
    return utf32_length_from_utf16le(data) if _NATIVE_LE else utf32_length_from_utf16be(data)


def utf8_length_from_utf32(data) -> int:
    return _impl().utf8_length_from_utf32(as_u32(data))


def utf16_length_from_utf32(data) -> int:
    return _impl().utf16_length_from_utf32(as_u32(data))


def utf8_length_from_latin1(data) -> int:
    return _impl().utf8_length_from_latin1(as_u8(data))


def latin1_length_from_utf16(length: int) -> int:
    return _impl().latin1_length_from_utf16(length)


def latin1_length_from_utf32(length: int) -> int:
    return _impl().latin1_length_from_utf32(length)


def utf16_length_from_latin1(length: int) -> int:
    return _impl().utf16_length_from_latin1(length)


def utf32_length_from_latin1(length: int) -> int:
    return _impl().utf32_length_from_latin1(length)


# ---------------------------------------------------------------------------
# conversions: UTF-8 -> x


def convert_utf8_to_utf16le_with_errors(data):
    return _cvt(_impl().convert_utf8_to_utf16le_with_errors, as_u8(data))


def convert_utf8_to_utf16be_with_errors(data):
    return _cvt(_impl().convert_utf8_to_utf16be_with_errors, as_u8(data))


def convert_utf8_to_utf16_with_errors(data):
    return (convert_utf8_to_utf16le_with_errors(data) if _NATIVE_LE
            else convert_utf8_to_utf16be_with_errors(data))


def convert_utf8_to_utf32_with_errors(data):
    return _cvt(_impl().convert_utf8_to_utf32_with_errors, as_u8(data))


def convert_utf8_to_utf16le(data) -> bytes:
    return _plain(_impl().convert_utf8_to_utf16le_with_errors, as_u8(data))


def convert_utf8_to_utf16be(data) -> bytes:
    return _plain(_impl().convert_utf8_to_utf16be_with_errors, as_u8(data))


def convert_utf8_to_utf16(data) -> bytes:
    return convert_utf8_to_utf16le(data) if _NATIVE_LE else convert_utf8_to_utf16be(data)


def convert_utf8_to_utf32(data) -> bytes:
    return _plain(_impl().convert_utf8_to_utf32_with_errors, as_u8(data))


def convert_valid_utf8_to_utf16le(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf8_to_utf16le(as_u8(data)))


def convert_valid_utf8_to_utf16be(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf8_to_utf16be(as_u8(data)))


def convert_valid_utf8_to_utf16(data) -> bytes:
    return (convert_valid_utf8_to_utf16le(data) if _NATIVE_LE
            else convert_valid_utf8_to_utf16be(data))


def convert_valid_utf8_to_utf32(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf8_to_utf32(as_u8(data)))


def convert_utf8_to_latin1_with_errors(data):
    return _cvt(_impl().convert_utf8_to_latin1_with_errors, as_u8(data))


def convert_utf8_to_latin1(data) -> bytes:
    return _plain(_impl().convert_utf8_to_latin1_with_errors, as_u8(data))


def convert_valid_utf8_to_latin1(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf8_to_latin1(as_u8(data)))


# ---------------------------------------------------------------------------
# conversions: UTF-16 -> UTF-8


def convert_utf16le_to_utf8_with_errors(data):
    return _cvt(_impl().convert_utf16le_to_utf8_with_errors, as_u16(data))


def convert_utf16be_to_utf8_with_errors(data):
    return _cvt(_impl().convert_utf16be_to_utf8_with_errors, as_u16(data))


def convert_utf16_to_utf8_with_errors(data):
    return (convert_utf16le_to_utf8_with_errors(data) if _NATIVE_LE
            else convert_utf16be_to_utf8_with_errors(data))


def convert_utf16le_to_utf8(data) -> bytes:
    return _plain(_impl().convert_utf16le_to_utf8_with_errors, as_u16(data))


def convert_utf16be_to_utf8(data) -> bytes:
    return _plain(_impl().convert_utf16be_to_utf8_with_errors, as_u16(data))


def convert_utf16_to_utf8(data) -> bytes:
    return convert_utf16le_to_utf8(data) if _NATIVE_LE else convert_utf16be_to_utf8(data)


def convert_valid_utf16le_to_utf8(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf16le_to_utf8(as_u16(data)))


def convert_valid_utf16be_to_utf8(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf16be_to_utf8(as_u16(data)))


def convert_valid_utf16_to_utf8(data) -> bytes:
    return (convert_valid_utf16le_to_utf8(data) if _NATIVE_LE
            else convert_valid_utf16be_to_utf8(data))


# ---------------------------------------------------------------------------
# conversions: UTF-32 -> UTF-8


def convert_utf32_to_utf8_with_errors(data):
    return _cvt(_impl().convert_utf32_to_utf8_with_errors, as_u32(data))


def convert_utf32_to_utf8(data) -> bytes:
    return _plain(_impl().convert_utf32_to_utf8_with_errors, as_u32(data))


def convert_valid_utf32_to_utf8(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf32_to_utf8(as_u32(data)))


# ---------------------------------------------------------------------------
# conversions: UTF-16 <-> UTF-32


def convert_utf16le_to_utf32_with_errors(data):
    return _cvt(_impl().convert_utf16le_to_utf32_with_errors, as_u16(data))


def convert_utf16be_to_utf32_with_errors(data):
    return _cvt(_impl().convert_utf16be_to_utf32_with_errors, as_u16(data))


def convert_utf16_to_utf32_with_errors(data):
    return (convert_utf16le_to_utf32_with_errors(data) if _NATIVE_LE
            else convert_utf16be_to_utf32_with_errors(data))


def convert_utf16le_to_utf32(data) -> bytes:
    return _plain(_impl().convert_utf16le_to_utf32_with_errors, as_u16(data))


def convert_utf16be_to_utf32(data) -> bytes:
    return _plain(_impl().convert_utf16be_to_utf32_with_errors, as_u16(data))


def convert_utf16_to_utf32(data) -> bytes:
    return convert_utf16le_to_utf32(data) if _NATIVE_LE else convert_utf16be_to_utf32(data)


def convert_valid_utf16le_to_utf32(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf16le_to_utf32(as_u16(data)))


def convert_valid_utf16be_to_utf32(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf16be_to_utf32(as_u16(data)))


def convert_valid_utf16_to_utf32(data) -> bytes:
    return (convert_valid_utf16le_to_utf32(data) if _NATIVE_LE
            else convert_valid_utf16be_to_utf32(data))


def convert_utf32_to_utf16le_with_errors(data):
    return _cvt(_impl().convert_utf32_to_utf16le_with_errors, as_u32(data))


def convert_utf32_to_utf16be_with_errors(data):
    return _cvt(_impl().convert_utf32_to_utf16be_with_errors, as_u32(data))


def convert_utf32_to_utf16_with_errors(data):
    return (convert_utf32_to_utf16le_with_errors(data) if _NATIVE_LE
            else convert_utf32_to_utf16be_with_errors(data))


def convert_utf32_to_utf16le(data) -> bytes:
    return _plain(_impl().convert_utf32_to_utf16le_with_errors, as_u32(data))


def convert_utf32_to_utf16be(data) -> bytes:
    return _plain(_impl().convert_utf32_to_utf16be_with_errors, as_u32(data))


def convert_utf32_to_utf16(data) -> bytes:
    return convert_utf32_to_utf16le(data) if _NATIVE_LE else convert_utf32_to_utf16be(data)


def convert_valid_utf32_to_utf16le(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf32_to_utf16le(as_u32(data)))


def convert_valid_utf32_to_utf16be(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf32_to_utf16be(as_u32(data)))


def convert_valid_utf32_to_utf16(data) -> bytes:
    return (convert_valid_utf32_to_utf16le(data) if _NATIVE_LE
            else convert_valid_utf32_to_utf16be(data))


# ---------------------------------------------------------------------------
# conversions: UTF-16 / UTF-32 -> Latin-1


def convert_utf16le_to_latin1_with_errors(data):
    return _cvt(_impl().convert_utf16le_to_latin1_with_errors, as_u16(data))


def convert_utf16be_to_latin1_with_errors(data):
    return _cvt(_impl().convert_utf16be_to_latin1_with_errors, as_u16(data))


def convert_utf16_to_latin1_with_errors(data):
    return (convert_utf16le_to_latin1_with_errors(data) if _NATIVE_LE
            else convert_utf16be_to_latin1_with_errors(data))


def convert_utf16le_to_latin1(data) -> bytes:
    return _plain(_impl().convert_utf16le_to_latin1_with_errors, as_u16(data))


def convert_utf16be_to_latin1(data) -> bytes:
    return _plain(_impl().convert_utf16be_to_latin1_with_errors, as_u16(data))


def convert_utf16_to_latin1(data) -> bytes:
    return convert_utf16le_to_latin1(data) if _NATIVE_LE else convert_utf16be_to_latin1(data)


def convert_valid_utf16le_to_latin1(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf16le_to_latin1(as_u16(data)))


def convert_valid_utf16be_to_latin1(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf16be_to_latin1(as_u16(data)))


def convert_valid_utf16_to_latin1(data) -> bytes:
    return (convert_valid_utf16le_to_latin1(data) if _NATIVE_LE
            else convert_valid_utf16be_to_latin1(data))


def convert_utf32_to_latin1_with_errors(data):
    return _cvt(_impl().convert_utf32_to_latin1_with_errors, as_u32(data))


def convert_utf32_to_latin1(data) -> bytes:
    return _plain(_impl().convert_utf32_to_latin1_with_errors, as_u32(data))


def convert_valid_utf32_to_latin1(data) -> bytes:
    return _out_bytes(_impl().convert_valid_utf32_to_latin1(as_u32(data)))


# ---------------------------------------------------------------------------
# conversions: Latin-1 -> x (always valid input)


def convert_latin1_to_utf8(data) -> bytes:
    return _out_bytes(_impl().convert_latin1_to_utf8(as_u8(data)))


def convert_latin1_to_utf8_safe(data, capacity: int) -> bytes:
    """Capacity-limited variant: as many whole characters as fit into
    ``capacity`` bytes."""
    arr = as_u8(data)
    # every character emits at least one byte, so the first ``capacity``
    # characters already cover the output budget
    if arr.shape[0] > capacity:
        arr = arr[:capacity]
    out = _impl().convert_latin1_to_utf8(arr)
    if out.shape[0] <= capacity:
        return _out_bytes(out)
    out = out[:capacity]
    # do not split a 2-byte character at the boundary
    if capacity > 0 and (int(out[capacity - 1]) & 0xE0) == 0xC0:
        out = out[: capacity - 1]
    return _out_bytes(out)


def convert_latin1_to_utf16le(data) -> bytes:
    return _out_bytes(_impl().convert_latin1_to_utf16le(as_u8(data)))


def convert_latin1_to_utf16be(data) -> bytes:
    return _out_bytes(_impl().convert_latin1_to_utf16be(as_u8(data)))


def convert_latin1_to_utf16(data) -> bytes:
    return convert_latin1_to_utf16le(data) if _NATIVE_LE else convert_latin1_to_utf16be(data)


def convert_latin1_to_utf32(data) -> bytes:
    return _out_bytes(_impl().convert_latin1_to_utf32(as_u8(data)))


# ---------------------------------------------------------------------------
# UTF-16 utilities


def change_endianness_utf16(data) -> bytes:
    return _out_bytes(_impl().change_endianness_utf16(as_u16(data)))


def to_well_formed_utf16le(data) -> bytes:
    return _out_bytes(_impl().to_well_formed_utf16le(as_u16(data)))


def to_well_formed_utf16be(data) -> bytes:
    return _out_bytes(_impl().to_well_formed_utf16be(as_u16(data)))


def to_well_formed_utf16(data) -> bytes:
    return to_well_formed_utf16le(data) if _NATIVE_LE else to_well_formed_utf16be(data)


def trim_partial_utf8(data) -> int:
    return _impl().trim_partial_utf8(as_u8(data))


def trim_partial_utf16le(data) -> int:
    return _impl().trim_partial_utf16le(as_u16(data))


def trim_partial_utf16be(data) -> int:
    return _impl().trim_partial_utf16be(as_u16(data))


def trim_partial_utf16(data) -> int:
    return trim_partial_utf16le(data) if _NATIVE_LE else trim_partial_utf16be(data)


# ---------------------------------------------------------------------------
# encoding detection


def autodetect_encoding(data) -> encoding_type:
    return _impl().autodetect_encoding(as_u8(data))


def detect_encodings(data) -> int:
    return _impl().detect_encodings(as_u8(data))


# ---------------------------------------------------------------------------
# C-style *_into variants: write into a caller-provided numpy buffer and
# return the unit count (0 on error)


def convert_utf8_to_utf16le_into(data, out: np.ndarray) -> int:
    res, produced = _impl().convert_utf8_to_utf16le_with_errors(as_u8(data))
    return _into(out, produced) if res.is_ok else 0


def convert_utf8_to_utf16be_into(data, out: np.ndarray) -> int:
    res, produced = _impl().convert_utf8_to_utf16be_with_errors(as_u8(data))
    return _into(out, produced) if res.is_ok else 0


def convert_utf8_to_utf32_into(data, out: np.ndarray) -> int:
    res, produced = _impl().convert_utf8_to_utf32_with_errors(as_u8(data))
    return _into(out, produced) if res.is_ok else 0


def convert_utf16le_to_utf8_into(data, out: np.ndarray) -> int:
    res, produced = _impl().convert_utf16le_to_utf8_with_errors(as_u16(data))
    return _into(out, produced) if res.is_ok else 0


def convert_utf16be_to_utf8_into(data, out: np.ndarray) -> int:
    res, produced = _impl().convert_utf16be_to_utf8_with_errors(as_u16(data))
    return _into(out, produced) if res.is_ok else 0


def convert_utf32_to_utf8_into(data, out: np.ndarray) -> int:
    res, produced = _impl().convert_utf32_to_utf8_with_errors(as_u32(data))
    return _into(out, produced) if res.is_ok else 0


def convert_latin1_to_utf8_into(data, out: np.ndarray) -> int:
    return _into(out, _impl().convert_latin1_to_utf8(as_u8(data)))


# ---------------------------------------------------------------------------
# base64


def _b64_src(data) -> np.ndarray:
    """bytes -> uint8 chars; uint16 arrays pass through (char16 input)."""
    if isinstance(data, np.ndarray) and data.dtype == np.uint16:
        return data
    if isinstance(data, str):
        data = data.encode("utf-8")
    return as_u8(data)


def maximal_binary_length_from_base64(data) -> int:
    return _impl().maximal_binary_length_from_base64(_b64_src(data))


def base64_length_from_binary(length: int, options: int = base64_default) -> int:
    return _impl().base64_length_from_binary(length, options)


def base64_to_binary(data, options: int = base64_default,
                     last_chunk_handling: int = loose):
    """Returns (Result, decoded bytes): count = bytes written on success,
    error position on failure."""
    full, out = _impl().base64_to_binary_details(
        _b64_src(data), options, last_chunk_handling)
    return full.to_result(), _out_bytes(out)


def base64_to_binary_details(data, options: int = base64_default,
                             last_chunk_handling: int = loose):
    """Returns (FullResult, decoded bytes)."""
    full, out = _impl().base64_to_binary_details(
        _b64_src(data), options, last_chunk_handling)
    return full, _out_bytes(out)


def binary_to_base64(data, options: int = base64_default) -> bytes:
    return _out_bytes(_impl().binary_to_base64(as_u8(data), options))


def base64_to_binary_safe(data, capacity: int, options: int = base64_default,
                          last_chunk_handling: int = loose,
                          decode_up_to_bad_char: bool = False):
    """Capacity-limited decode honoring ``capacity`` output bytes: returns
    (Result, bytes). On OUTPUT_BUFFER_TOO_SMALL, ``Result.count`` is the
    number of input characters processed, so callers can resume."""
    res, out = _impl().base64_to_binary_safe(
        _b64_src(data), capacity, options, last_chunk_handling,
        decode_up_to_bad_char)
    return res, _out_bytes(out)


def atomic_base64_to_binary_safe(data, capacity: int, options: int = base64_default,
                                 last_chunk_handling: int = loose,
                                 decode_up_to_bad_char: bool = False):
    """Alias of :func:`base64_to_binary_safe`: the reference's ``atomic_``
    variants guard against races on the caller's raw buffers, and the
    inputs here are copied into buffers the port owns."""
    return base64_to_binary_safe(data, capacity, options, last_chunk_handling,
                                 decode_up_to_bad_char)


def atomic_binary_to_base64(data, options: int = base64_default) -> bytes:
    """Alias of :func:`binary_to_base64` (see
    :func:`atomic_base64_to_binary_safe`)."""
    return binary_to_base64(data, options)
