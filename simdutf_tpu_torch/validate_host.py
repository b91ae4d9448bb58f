"""Host-side exact validators for the rewind after a SWAR scan: the
(code, position) of the first error of a small window. The port's own
copies of simdutf_tpu/golden/utf8.validate_with_errors (over ``analyze``)
and golden/utf16.validate_with_errors (over ``first_error``), numpy only.

UTF-8 (the event-minimum formulation of golden/utf8.py): before its first
error the scalar machine (scalar/utf8.h:102-199) parses from lead to lead,
so its first error is the least of: a lead whose own sequence check
fails, at the lead; a continuation byte right after a valid sequence
(TOO_LONG at it); the input starting with a continuation (TOO_LONG at 0).
UTF-16: the least of a high surrogate not followed by a low one and a low
one not preceded by a high one (SURROGATE).
"""

from __future__ import annotations

import numpy as np

from .errors import Result, error_code as ec

_NO_ERROR = np.iinfo(np.int32).max


def _shift(b: np.ndarray, k: int) -> np.ndarray:
    """b[i+k], zero past the end (a zero byte ends a sequence as EOF does)."""
    out = np.zeros_like(b)
    if k < len(b):
        out[: len(b) - k] = b[k:]
    return out


def _utf8_first_error(b: np.ndarray) -> tuple[int, int]:
    """(position, code) of the first UTF-8 error of ``b``; (_NO_ERROR, 0)
    when it is valid."""
    n = int(b.shape[0])
    if n == 0:
        return _NO_ERROR, 0
    b = b.astype(np.int32)
    b1, b2, b3 = _shift(b, 1), _shift(b, 2), _shift(b, 3)
    is_cont = (b & 0xC0) == 0x80
    c1, c2, c3 = ((x & 0xC0) == 0x80 for x in (b1, b2, b3))
    lead2 = (b & 0xE0) == 0xC0
    lead3 = (b & 0xF0) == 0xE0
    lead4 = (b & 0xF8) == 0xF0
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)

    # per-lead code, the scalar machine's order: structure before range
    err = np.zeros(n, np.int32)
    err = np.where(lead2 & ~c1, int(ec.TOO_SHORT), err)
    err = np.where(lead2 & c1 & (cp2 < 0x80), int(ec.OVERLONG), err)
    ok3 = c1 & c2
    err = np.where(lead3 & ~ok3, int(ec.TOO_SHORT), err)
    err = np.where(lead3 & ok3 & (cp3 < 0x800), int(ec.OVERLONG), err)
    err = np.where(lead3 & ok3 & (cp3 >= 0xD800) & (cp3 <= 0xDFFF), int(ec.SURROGATE), err)
    ok4 = ok3 & c3
    err = np.where(lead4 & ~ok4, int(ec.TOO_SHORT), err)
    err = np.where(lead4 & ok4 & (cp4 <= 0xFFFF), int(ec.OVERLONG), err)
    err = np.where(lead4 & ok4 & (cp4 > 0x10FFFF), int(ec.TOO_LARGE), err)
    err = np.where(b >= 0xF8, int(ec.HEADER_BITS), err)

    lead = ~is_cont
    seqlen = np.select([b < 0x80, lead2, lead3, lead4], [1, 2, 3, 4], 0)
    pos = np.arange(n, dtype=np.int32)
    event_pos = np.where(lead & (err != 0), pos, _NO_ERROR)
    # a continuation right after a valid sequence: TOO_LONG at it (lead
    # events and these sit on disjoint bytes, so a min-merge is exact)
    nxt = pos + seqlen
    nxt_in = lead & (err == 0) & (nxt < n)
    nxt_cont = np.zeros(n, bool)
    nxt_cont[nxt_in] = is_cont[nxt[nxt_in]]
    tl_pos = np.where(nxt_in & nxt_cont, nxt, _NO_ERROR)
    event_pos = np.minimum(event_pos, tl_pos)
    event_code = np.where(event_pos == tl_pos, int(ec.TOO_LONG), err)

    err_pos, err_code = _NO_ERROR, 0
    if event_pos.min() != _NO_ERROR:
        k = int(np.argmin(event_pos))
        err_pos, err_code = int(event_pos[k]), int(event_code[k])
    if is_cont[0] and err_pos > 0:
        err_pos, err_code = 0, int(ec.TOO_LONG)
    return err_pos, err_code


def validate_utf8_with_errors(b: np.ndarray) -> Result:
    """The first error of the uint8 array ``b`` as a Result; (SUCCESS,
    len(b)) when it is valid UTF-8."""
    pos, code = _utf8_first_error(np.asarray(b))
    if pos == _NO_ERROR:
        return Result(ec.SUCCESS, int(b.shape[0]))
    return Result(ec(code), pos)


def validate_utf16_with_errors(words: np.ndarray, big_endian: bool) -> Result:
    """The first error of the uint16 units ``words`` (stored byte-swapped
    when ``big_endian``) as a Result; (SUCCESS, len) when well-formed."""
    w = np.asarray(words)
    w = (w.byteswap() if big_endian else w).astype(np.int32)
    n = int(w.shape[0])
    is_high = (w & 0xFC00) == 0xD800
    is_low = (w & 0xFC00) == 0xDC00
    next_low = np.zeros(n, bool)
    next_low[: n - 1] = is_low[1:]
    prev_high = np.zeros(n, bool)
    prev_high[1:] = is_high[: n - 1]
    bad = (is_high & ~next_low) | (is_low & ~prev_high)
    if not bad.any():
        return Result(ec.SUCCESS, n)
    return Result(ec.SURROGATE, int(np.argmax(bad)))
