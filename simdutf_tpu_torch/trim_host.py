"""Host-side ``trim_partial``: the length of a buffer without the
incomplete character at its end. The port's own copies of
simdutf_tpu/golden/utf8.trim_partial and golden/utf16.trim_partial, which
the JAX package's device tiers also run on the host.
"""

from __future__ import annotations

import numpy as np


def trim_partial_utf8(b: np.ndarray) -> int:
    """Bytes of ``b`` up to the start of an incomplete trailing sequence
    (scalar/utf8.h:257-288)."""
    length = int(b.shape[0])
    if length < 3:
        if length == 2:
            if b[1] >= 0xC0:
                return 1
            if b[0] >= 0xE0:
                return 0
            return 2
        if length == 1:
            return 0 if b[0] >= 0xC0 else 1
        return 0
    if b[length - 1] >= 0xC0:
        return length - 1
    if b[length - 2] >= 0xE0:
        return length - 2
    if b[length - 3] >= 0xF0:
        return length - 3
    return length


def trim_partial_utf16(words: np.ndarray, big_endian: bool) -> int:
    """Units of ``words`` without a high surrogate at the end
    (scalar/utf16.h:114-124)."""
    length = int(words.shape[0])
    if length <= 1:
        return length
    last = int(words[-1:].byteswap()[0] if big_endian else words[-1])
    if (last & 0xFC00) == 0xD800:
        return length - 1
    return length
