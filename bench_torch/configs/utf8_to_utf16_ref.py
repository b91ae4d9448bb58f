"""Plain reference of validating UTF-8 -> UTF-16 with the first error
(simdutf's ``convert_utf8_to_utf16le_with_errors``), independent of the
program: CPython's codecs find whether the bytes are valid, where the first
bad sequence starts, and the units of the valid prefix; simdutf's rules
(include/simdutf/error.h) name the error at that position.
"""

from __future__ import annotations

import numpy as np

SUCCESS, HEADER_BITS, TOO_SHORT, TOO_LONG, OVERLONG, TOO_LARGE, SURROGATE = range(7)


def _cont(data: bytes, i: int) -> bool:
    return i < len(data) and data[i] & 0xC0 == 0x80


def error_at(data: bytes, pos: int) -> int:
    """simdutf's error code of the bad sequence that starts at ``pos``:
    the count of continuation bytes is checked first, then the value."""
    c = data[pos]
    if c & 0xC0 == 0x80:
        return TOO_LONG
    if c >= 0xF8:
        return HEADER_BITS
    need = 1 if c < 0xE0 else 2 if c < 0xF0 else 3
    if not all(_cont(data, pos + k) for k in range(1, need + 1)):
        return TOO_SHORT
    cp = c & (0x1F, 0x0F, 0x07)[need - 1]
    for k in range(1, need + 1):
        cp = cp << 6 | data[pos + k] & 0x3F
    if cp < (0x80, 0x800, 0x10000)[need - 1]:
        return OVERLONG
    if 0xD800 <= cp <= 0xDFFF:
        return SURROGATE
    if cp > 0x10FFFF:
        return TOO_LARGE
    raise AssertionError(f"CPython rejected a valid sequence at {pos}")


def convert(data: bytes):
    """(code, pos, units): ``(0, len(data), all units)`` for valid input,
    else the first error's code and byte position and the units of the
    bytes before it, as uint16 values (UTF-16LE)."""
    try:
        text = data.decode("utf-8")
        code, pos = SUCCESS, len(data)
    except UnicodeDecodeError as e:
        code, pos = error_at(data, e.start), e.start
        text = data[:pos].decode("utf-8")
    return code, pos, np.frombuffer(text.encode("utf-16-le"), "<u2").copy()
