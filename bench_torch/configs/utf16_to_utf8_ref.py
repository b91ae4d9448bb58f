"""Plain reference of validating UTF-16LE -> UTF-8 with the first error
(simdutf's ``convert_utf16le_to_utf8_with_errors``), independent of the
program: CPython's UTF-16-LE codec finds whether the units are valid and
where the first lone surrogate is (``UnicodeDecodeError.start // 2``: a
low surrogate with no high before it, a high surrogate followed by a unit
that is not a low one, or a high surrogate as the last unit), and encodes
the valid prefix to UTF-8. simdutf reports every such unit as
``SURROGATE`` (include/simdutf/error.h), at its unit position. No
departure from simdutf's rules is known.
"""

from __future__ import annotations

import numpy as np

SUCCESS, SURROGATE = 0, 6


def convert(data: bytes):
    """(code, pos, out) of UTF-16LE ``data``: ``(SUCCESS, units, every
    byte)`` for valid input, else ``SURROGATE``, the first lone
    surrogate's unit position and the UTF-8 bytes of the units before it,
    as uint8 values."""
    if len(data) % 2:
        raise ValueError("UTF-16 input holds whole units")
    try:
        text = data.decode("utf-16-le")
        code, pos = SUCCESS, len(data) // 2
    except UnicodeDecodeError as e:
        code, pos = SURROGATE, e.start // 2
        text = data[: e.start].decode("utf-16-le")
    return code, pos, np.frombuffer(text.encode("utf-8"), np.uint8).copy()
