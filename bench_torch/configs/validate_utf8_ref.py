"""Plain reference of UTF-8 validation with the first error (simdutf's
``validate_utf8_with_errors``), independent of the program: CPython's
UTF-8 codec finds whether the bytes are valid and where the first bad
sequence starts; simdutf's rules (include/simdutf/error.h) name the error
at that position, by the classification the UTF-16 reference already
holds (``utf8_to_utf16_ref.error_at``). Validation and the validating
transcodes share their error rules in simdutf, so they share them here.

No departure from simdutf's rules is known: CPython and simdutf agree on
which bytes are valid UTF-8 and on where the first bad sequence starts.
"""

from __future__ import annotations

from bench_torch.configs.utf8_to_utf16_ref import SUCCESS, error_at


def validate(data: bytes) -> tuple[int, int]:
    """(code, pos): ``(SUCCESS, len(data))`` for valid input, else the
    first error's code and the byte position where its sequence starts."""
    try:
        data.decode("utf-8")
    except UnicodeDecodeError as e:
        return error_at(data, e.start), e.start
    return SUCCESS, len(data)
