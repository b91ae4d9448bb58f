"""Plain reference of validating UTF-8 -> UTF-32 with the first error
(simdutf's ``convert_utf8_to_utf32_with_errors``), independent of the
program: CPython's UTF-8 codec finds whether the bytes are valid, where the
first bad sequence starts, and the code points of the valid prefix
(``str.encode("utf-32-le")``); simdutf's rules (include/simdutf/error.h)
name the error at that position, by the classification the UTF-16
reference already holds (``utf8_to_utf16_ref.error_at``). The two
directions share their error rules in simdutf, so they share them here.

No departure from simdutf's rules is known: CPython and simdutf agree on
which bytes are valid UTF-8 and on where the first bad sequence starts.
"""

from __future__ import annotations

import numpy as np

from bench_torch.configs.utf8_to_utf16_ref import SUCCESS, error_at


def convert(data: bytes):
    """(code, pos, words): ``(SUCCESS, len(data), every code point)`` for
    valid input, else the first error's code and byte position and the
    code points of the bytes before it, as uint32 values."""
    try:
        text = data.decode("utf-8")
        code, pos = SUCCESS, len(data)
    except UnicodeDecodeError as e:
        code, pos = error_at(data, e.start), e.start
        text = data[:pos].decode("utf-8")
    return code, pos, np.frombuffer(text.encode("utf-32-le"), "<u4").copy()
