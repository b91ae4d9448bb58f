"""Error model of the port (its own copy of simdutf_tpu/errors.py).

Mirrors the reference error contract (simdutf: include/simdutf/error.h:5-74):
an ``error_code`` enum plus ``Result``/``FullResult`` records where ``count``
holds the error position (in input code units) on failure and the number of
code units validated/written on success. The values are the JAX package's,
value for value, and the records are NamedTuples, so a result of either
package compares equal to the other's.
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class error_code(enum.IntEnum):
    """Error codes, value-for-value compatible with the reference enum
    (include/simdutf/error.h:5-32)."""

    SUCCESS = 0
    #: Any byte must have fewer than 5 header bits.
    HEADER_BITS = 1
    #: The leading byte must be followed by N-1 continuation bytes; also the
    #: error for truncated input.
    TOO_SHORT = 2
    #: Too many consecutive continuation bytes, or the string starts with one.
    TOO_LONG = 3
    #: Decoded character must be above U+7F (2-byte), U+7FF (3-byte),
    #: U+FFFF (4-byte).
    OVERLONG = 4
    #: Decoded character must be <= U+10FFFF (or <= U+7F for ASCII,
    #: <= U+FF for Latin1).
    TOO_LARGE = 5
    #: Surrogate constraint violated (UTF-8/UTF-32: no surrogates at all;
    #: UTF-16: high must be followed by low, low preceded by high).
    SURROGATE = 6
    #: Character that cannot be part of a valid base64 string (possibly a
    #: misplaced padding character '=').
    INVALID_BASE64_CHARACTER = 7
    #: Base64 input terminates with a single character, excluding padding.
    BASE64_INPUT_REMAINDER = 8
    #: Base64 input terminates with non-zero padding bits.
    BASE64_EXTRA_BITS = 9
    #: The provided buffer is too small.
    OUTPUT_BUFFER_TOO_SMALL = 10
    #: Not related to validation/transcoding.
    OTHER = 11


class Result(NamedTuple):
    """``result`` analogue (error.h:34-52).

    ``count``: error position on failure; code units validated/written on
    success.
    """

    error: error_code
    count: int

    @property
    def is_ok(self) -> bool:
        return self.error == error_code.SUCCESS

    @property
    def is_err(self) -> bool:
        return self.error != error_code.SUCCESS

    def __bool__(self) -> bool:  # truthiness == success
        return self.is_ok


class FullResult(NamedTuple):
    """``full_result`` analogue (error.h:54-74): dual input/output counts,
    used by the base64 ``_details`` entry points."""

    error: error_code
    input_count: int
    output_count: int

    @property
    def is_ok(self) -> bool:
        return self.error == error_code.SUCCESS

    def to_result(self) -> Result:
        # Mirrors full_result::operator result() (error.h:66-73).
        if self.error in (error_code.SUCCESS, error_code.BASE64_INPUT_REMAINDER):
            return Result(self.error, self.output_count)
        return Result(self.error, self.input_count)
