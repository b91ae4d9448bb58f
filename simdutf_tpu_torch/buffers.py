"""Host-side buffer coercion (the port's own copy of simdutf_tpu/buffers.py):
bytes-like or numpy input -> contiguous uint8 / uint16 / uint32 arrays."""

from __future__ import annotations

import numpy as np

__all__ = ["as_u8", "as_u16", "as_u32"]

#: the kernels index with int32 offsets; a larger single call must be split
#: by the caller
MAX_SINGLE_CALL_BYTES = 2**31 - 512


def _check_size(n: int) -> None:
    if n > MAX_SINGLE_CALL_BYTES:
        raise ValueError(
            f"input of {n} bytes exceeds the {MAX_SINGLE_CALL_BYTES}-byte "
            "single-call limit (int32 offsets); split it"
        )


def as_u8(data) -> np.ndarray:
    """bytes-like / array -> contiguous uint8 array (zero-copy for bytes)."""
    if isinstance(data, np.ndarray):
        if data.dtype == np.uint8:
            out = np.ascontiguousarray(data)
        else:
            out = np.ascontiguousarray(data).view(np.uint8)
    else:
        out = np.frombuffer(memoryview(data), dtype=np.uint8)
    _check_size(out.shape[0])
    return out


def as_u16(data) -> np.ndarray:
    """bytes-like / array -> uint16 code-unit array (raw storage order).
    Byte-length inputs must be even, mirroring the reference's char16_t* +
    length-in-units contract."""
    if isinstance(data, np.ndarray) and data.dtype == np.uint16:
        _check_size(data.shape[0] * 2)
        return np.ascontiguousarray(data)
    b = as_u8(data)
    if b.shape[0] % 2 != 0:
        raise ValueError("UTF-16 input must contain an even number of bytes")
    return b.view(np.uint16)


def as_u32(data) -> np.ndarray:
    """bytes-like / array -> uint32 word array (little-endian storage)."""
    if isinstance(data, np.ndarray) and data.dtype == np.uint32:
        _check_size(data.shape[0] * 4)
        return np.ascontiguousarray(data)
    b = as_u8(data)
    if b.shape[0] % 4 != 0:
        raise ValueError("UTF-32 input must contain a multiple of 4 bytes")
    return b.view(np.uint32)
