"""Encoding enumeration and BOM sniffing: the port's own copy of
simdutf_tpu/encodings.py, value for value.

Behavioral parity with the reference (include/simdutf/encoding_types.h:7-44,
src/encoding_types.cpp). BOM detection is a tiny host-side prefix test; it is
never worth a device round trip.
"""

from __future__ import annotations

import enum
import sys


class encoding_type(enum.IntFlag):
    unspecified = 0
    UTF8 = 1  # BOM ef bb bf
    UTF16_LE = 2  # BOM ff fe
    UTF16_BE = 4  # BOM fe ff
    UTF32_LE = 8  # BOM ff fe 00 00
    UTF32_BE = 16  # BOM 00 00 fe ff
    Latin1 = 32


class endianness(enum.IntEnum):
    LITTLE = 0
    BIG = 1


def match_system(e: endianness) -> bool:
    """True when ``e`` matches host byte order (encoding_types.cpp:3-9)."""
    if sys.byteorder == "big":
        return e == endianness.BIG
    return e == endianness.LITTLE


_NAMES = {
    encoding_type.UTF16_LE: "UTF16 little-endian",
    encoding_type.UTF16_BE: "UTF16 big-endian",
    encoding_type.UTF32_LE: "UTF32 little-endian",
    encoding_type.UTF32_BE: "UTF32 big-endian",
    encoding_type.UTF8: "UTF8",
    encoding_type.unspecified: "unknown",
}


def to_string(enc: encoding_type) -> str:
    return _NAMES.get(enc, "error")


def check_bom(data: bytes | bytearray | memoryview, length: int | None = None) -> encoding_type:
    """BOM sniffing with the reference's precedence (encoding_types.cpp:31-48):
    UTF32_LE wins over UTF16_LE when the ff fe is followed by 00 00."""
    b = bytes(data[: length if length is not None else len(data)][:4])
    n = len(b)
    if n >= 2 and b[0] == 0xFF and b[1] == 0xFE:
        if n >= 4 and b[2] == 0x00 and b[3] == 0x00:
            return encoding_type.UTF32_LE
        return encoding_type.UTF16_LE
    if n >= 2 and b[0] == 0xFE and b[1] == 0xFF:
        return encoding_type.UTF16_BE
    if n >= 4 and b[0] == 0x00 and b[1] == 0x00 and b[2] == 0xFE and b[3] == 0xFF:
        return encoding_type.UTF32_BE
    # Note: reference requires length >= 4 even though the UTF-8 BOM is 3 bytes
    # (encoding_types.cpp:42-44); we reproduce that quirk for parity.
    if n >= 4 and b[0] == 0xEF and b[1] == 0xBB and b[2] == 0xBF:
        return encoding_type.UTF8
    return encoding_type.unspecified


def bom_byte_size(enc: encoding_type) -> int:
    return {
        encoding_type.UTF16_LE: 2,
        encoding_type.UTF16_BE: 2,
        encoding_type.UTF32_LE: 4,
        encoding_type.UTF32_BE: 4,
        encoding_type.UTF8: 3,
    }.get(enc, 0)
