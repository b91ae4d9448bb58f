"""Host side of forgiving base64: options, char tables, lengths, the
prologue strip and the epilogue after the device decode, and the
capacity-limited decode.

The port's own copies of what it needs from simdutf_tpu/golden/base64_impl.py
(options and last-chunk constants, ``value_table``, ``ignore_garbage``,
``use_padding``, the <= 2-byte tail of ``encode``, ``maximal_binary_length``,
``base64_length_from_binary``, and the safe decode: ``tail_decode_safe``,
``decode_safe``, ``_decode_safe_slow``) and from simdutf_tpu/ops/impl.py
(``b64_strip``, ``b64_tail_epilogue``, ``b64_finish``). Reference
behaviour: generic/base64.h:43-246, scalar/base64.h:33-533 and
src/implementation.cpp:2157-2394.
"""

from __future__ import annotations

import numpy as np

from .errors import FullResult, Result, error_code as ec

# base64_options (implementation.h:2782-2800)
BASE64_DEFAULT = 0
BASE64_URL = 1
BASE64_REVERSE_PADDING = 2
BASE64_DEFAULT_NO_PADDING = 2
BASE64_URL_WITH_PADDING = 3
BASE64_DEFAULT_ACCEPT_GARBAGE = 4
BASE64_URL_ACCEPT_GARBAGE = 5
BASE64_DEFAULT_OR_URL = 8
BASE64_DEFAULT_OR_URL_ACCEPT_GARBAGE = 12

# last_chunk_handling_options (implementation.h:2805-2811)
LOOSE = 0
STRICT = 1
STOP_BEFORE_PARTIAL = 2

_STD = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
_URL = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"
_SPACES = b" \t\n\r\x0c"


def _make_table(options: int) -> np.ndarray:
    tab = np.full(256, 255, dtype=np.uint8)
    if options & BASE64_DEFAULT_OR_URL:
        alphas = (_STD, _URL)
    elif options & BASE64_URL:
        alphas = (_URL,)
    else:
        alphas = (_STD,)
    for alpha in alphas:
        tab[np.frombuffer(alpha, dtype=np.uint8)] = np.arange(64, dtype=np.uint8)
    tab[np.frombuffer(_SPACES, dtype=np.uint8)] = 64
    return tab


_TABLES = {opt: _make_table(opt) for opt in (0, 1, 8)}
_ENC_STD = np.frombuffer(_STD, dtype=np.uint8)
_ENC_URL = np.frombuffer(_URL, dtype=np.uint8)


def value_table(options: int) -> np.ndarray:
    """char -> 0..63 value, 64 for whitespace, 255 otherwise. The
    default_or_url bit wins, then the url bit (scalar/base64.h:43-47);
    the modifier bits do not change the alphabet."""
    if options & BASE64_DEFAULT_OR_URL:
        return _TABLES[8]
    if options & BASE64_URL:
        return _TABLES[1]
    return _TABLES[0]


def ignore_garbage(options: int) -> bool:
    return options in (
        BASE64_DEFAULT_ACCEPT_GARBAGE,
        BASE64_URL_ACCEPT_GARBAGE,
        BASE64_DEFAULT_OR_URL_ACCEPT_GARBAGE,
    )


def use_padding(options: int) -> bool:
    return ((options & BASE64_URL) == 0) ^ (
        (options & BASE64_REVERSE_PADDING) == BASE64_REVERSE_PADDING
    )


def maximal_binary_length(src: np.ndarray) -> int:
    # scalar/base64.h:493-513
    length = int(src.shape[0])
    padding = 0
    eq = ord("=")
    if length > 0 and int(src[length - 1]) == eq:
        padding += 1
        if length > 1 and int(src[length - 2]) == eq:
            padding += 1
    actual = length - padding
    if actual % 4 <= 1:
        return actual // 4 * 3
    return actual // 4 * 3 + (actual % 4) - 1


def base64_length_from_binary(length: int, options: int = BASE64_DEFAULT) -> int:
    # scalar/base64.h:515-533
    if not use_padding(options):
        return length // 3 * 4 + ((length % 3) + 1 if length % 3 else 0)
    return (length + 2) // 3 * 4


def encode_tail(src: np.ndarray, options: int = BASE64_DEFAULT) -> np.ndarray:
    """The chars of the last 1 or 2 bytes of an encode (the whole 3-byte
    groups are encoded on the device), padded with '=' where the options
    ask for it (scalar/base64.h:435-491)."""
    alpha = _ENC_URL if (options & BASE64_URL) else _ENC_STD
    rem = int(src.shape[0])
    if rem == 0:
        return np.zeros(0, np.uint8)
    t = int(src[0]) << 16 | (int(src[1]) << 8 if rem == 2 else 0)
    tail = [alpha[t >> 18], alpha[(t >> 12) & 63]]
    if rem == 2:
        tail.append(alpha[(t >> 6) & 63])
    if use_padding(options):
        tail += [ord("=")] * (3 - rem)
    return np.array(tail, np.uint8)


def b64_strip(src, tab_np, garbage: bool):
    """Prologue strip (generic/base64.h:50-73): trailing whitespace and up
    to two '=' signs. Returns (srclen, pad_count, pad_pos).
    Vectorized backward scan in growing chunks — O(trailing)."""
    eq = ord("=")

    def strip_ws(end: int) -> int:
        step = 64
        while end > 0:
            lo = max(0, end - step)
            chunk = np.asarray(src[lo:end])
            vals = np.where(
                chunk > 0xFF, 255, tab_np[np.minimum(chunk, 0xFF)]
            )
            nonws = np.flatnonzero(vals != 64)
            if len(nonws):
                return lo + int(nonws[-1]) + 1
            end = lo
            step *= 4
        return 0

    srclen = int(src.shape[0])
    pad_pos, pad_count = srclen, 0
    if not garbage:
        srclen = strip_ws(srclen)
        if srclen > 0 and int(src[srclen - 1]) == eq:
            pad_pos, srclen, pad_count = srclen - 1, srclen - 1, 1
            srclen = strip_ws(srclen)
            if srclen > 0 and int(src[srclen - 1]) == eq:
                pad_pos, srclen, pad_count = srclen - 1, srclen - 1, 2
    return srclen, pad_count, pad_pos


def b64_tail_epilogue(
    outlen: int,
    idx: int,
    tail: list,
    tail_start: int,
    srclen: int,
    pad_count: int,
    pad_pos: int,
    garbage: bool,
    last_chunk: int,
):
    """Last-chunk + padding-consistency semantics (scalar/base64.h:135-216
    tail modes and the generic/base64.h:228-244 padding checks).

    ``outlen``: bytes decoded from full quads; ``idx``/``tail``: leftover
    (<4) char count and their 6-bit values; positions are input indices.
    Returns (FullResult, extra uint8 bytes to append).
    """
    none = np.zeros(0, dtype=np.uint8)
    w = outlen
    extra = none
    if idx != 0 or (not garbage and pad_count > 0):
        if (
            not garbage
            and last_chunk == STRICT
            and idx != 1
            and ((idx + pad_count) & 3) != 0
        ):
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, w), none
        if (
            not garbage
            and last_chunk == STOP_BEFORE_PARTIAL
            and ((idx + pad_count) & 3) != 0
        ):
            start = tail_start if idx > 0 else srclen
            return FullResult(ec.SUCCESS, start, w), none
        if idx == 2:
            t = tail[0] << 18 | tail[1] << 12
            if not garbage and last_chunk == STRICT and (t & 0xFFFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, w), none
            extra = np.array([(t >> 16) & 0xFF], dtype=np.uint8)
            w += 1
        elif idx == 3:
            t = tail[0] << 18 | tail[1] << 12 | tail[2] << 6
            if not garbage and last_chunk == STRICT and (t & 0xFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, w), none
            extra = np.array(
                [(t >> 16) & 0xFF, (t >> 8) & 0xFF], dtype=np.uint8
            )
            w += 2
        elif not garbage and idx == 1 and last_chunk != STOP_BEFORE_PARTIAL:
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, w), none

    if not garbage and last_chunk != STOP_BEFORE_PARTIAL and pad_count > 0:
        if (w % 3 == 0) or ((w % 3) + 1 + pad_count != 4):
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, w),
                extra,
            )
    return FullResult(ec.SUCCESS, srclen, w), extra


def b64_finish(
    srclen: int,
    pad_count: int,
    pad_pos: int,
    garbage: bool,
    last_chunk: int,
    first_bad: int,
    nvalid: int,
    nvalid_at_bad: int,
    packed: np.ndarray,
    tail_vals: np.ndarray,
    tail_start: int,
):
    """Host epilogue of one device decode: turns its raw outputs into the
    (FullResult, bytes) contract."""
    empty = np.zeros(0, dtype=np.uint8)
    if srclen == 0:
        if not garbage and pad_count > 0:
            if last_chunk == STRICT:
                return FullResult(ec.BASE64_INPUT_REMAINDER, 0, 0), empty
            if last_chunk == STOP_BEFORE_PARTIAL:
                return FullResult(ec.SUCCESS, 0, 0), empty
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, 0),
                empty,
            )
        return FullResult(ec.SUCCESS, 0, 0), empty

    if not garbage and first_bad < srclen:
        nb = int(nvalid_at_bad)
        outlen = nb // 4 * 3
        return (
            FullResult(ec.INVALID_BASE64_CHARACTER, first_bad, outlen),
            np.asarray(packed)[:outlen],
        )

    nfull = nvalid // 4 * 4
    out = np.asarray(packed)[: nfull // 4 * 3]
    idx = nvalid - nfull
    tail = [int(t) for t in np.asarray(tail_vals)[:idx]]
    full, extra = b64_tail_epilogue(
        len(out), idx, tail, int(tail_start), srclen,
        pad_count, pad_pos, garbage, last_chunk,
    )
    if len(extra):
        out = np.concatenate([out, extra])
    return full, out


# ---------------------------------------------------------------------------
# capacity-limited ("safe") decode — reference: base64_to_binary_safe_impl
# (src/implementation.cpp:2157-2330) + base64_tail_decode_safe
# (src/scalar/base64.h:223-431).


def tail_decode_safe(
    out: bytearray,
    capacity: int,
    src,
    start: int,
    length: int,
    padded: int,
    options: int,
    last_chunk: int,
):
    """Emulates scalar base64_tail_decode_safe over src[start:start+length].

    Returns (error_code, src_index); decoded bytes are appended to
    ``out`` in place. ``capacity`` limits how many bytes may be appended.
    """
    tab = value_table(options)
    garbage = ignore_garbage(options)

    def code(c):
        c = int(c)
        if c != (c & 0xFF):
            return 255
        return int(tab[c & 0xFF])

    written0 = len(out)
    buffer = []
    i = start
    end = start + length
    chunk_start = start
    while True:
        # refill a 4-value chunk
        chunk_start = i
        while len(buffer) < 4 and i < end:
            v = code(src[i])
            if v <= 63:
                buffer.append(v)
            elif not garbage and v > 64:
                return ec.INVALID_BASE64_CHARACTER, i
            i += 1
        if len(buffer) != 4:
            idx = len(buffer)
            if (
                not garbage
                and last_chunk == STRICT
                and idx != 1
                and ((idx + padded) & 3) != 0
            ):
                return ec.BASE64_INPUT_REMAINDER, i
            if (
                not garbage
                and last_chunk == STOP_BEFORE_PARTIAL
                and ((idx + padded) & 3) != 0
            ):
                # rewind to the partial chunk start, skipping ignorables
                j = chunk_start
                while j < end and code(src[j]) > 63:
                    j += 1
                return ec.SUCCESS, j
            if idx == 0:
                return ec.SUCCESS, i
            if not garbage and idx == 1 and last_chunk != STOP_BEFORE_PARTIAL:
                return ec.BASE64_INPUT_REMAINDER, i
            if idx in (2, 3):
                need = idx - 1
                if capacity - (len(out) - written0) < need:
                    return ec.OUTPUT_BUFFER_TOO_SMALL, chunk_start
                t = 0
                for k, v in enumerate(buffer):
                    t |= v << (18 - 6 * k)
                if idx == 2:
                    if not garbage and last_chunk == STRICT and (t & 0xFFFF):
                        return ec.BASE64_EXTRA_BITS, i
                    out.append((t >> 16) & 0xFF)
                else:
                    if not garbage and last_chunk == STRICT and (t & 0xFF):
                        return ec.BASE64_EXTRA_BITS, i
                    out.append((t >> 16) & 0xFF)
                    out.append((t >> 8) & 0xFF)
                return ec.SUCCESS, i
            return ec.SUCCESS, i
        if capacity - (len(out) - written0) < 3:
            return ec.OUTPUT_BUFFER_TOO_SMALL, chunk_start
        t = (
            (buffer[0] << 18)
            | (buffer[1] << 12)
            | (buffer[2] << 6)
            | buffer[3]
        )
        out += bytes([(t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF])
        buffer.clear()


def decode_safe(
    src,
    capacity: int,
    options: int = BASE64_DEFAULT,
    last_chunk: int = LOOSE,
    decode_up_to_bad_char: bool = False,
    *,
    details_fn,
):
    """Capacity-limited decode. Returns (Result-shaped (error, count), out).

    ``details_fn(src, options, last_chunk)`` is the bulk decoder of the
    enough-capacity fast path (the port's ``base64_to_binary_details``);
    below the maximal length the decode is this module's host loop, as in
    the JAX package.
    """
    length = int(src.shape[0]) if hasattr(src, "shape") else len(src)
    max_length = maximal_binary_length(
        src if isinstance(src, np.ndarray) else np.frombuffer(bytes(src), np.uint8)
    )
    if capacity >= max_length:
        full, out = details_fn(src, options, last_chunk)
        if decode_up_to_bad_char and full.error == ec.INVALID_BASE64_CHARACTER:
            return _decode_safe_slow(src, capacity, options, last_chunk)
        if full.error not in (
            ec.INVALID_BASE64_CHARACTER,
            ec.BASE64_EXTRA_BITS,
        ):
            if last_chunk == STOP_BEFORE_PARTIAL:
                input_count = full.input_count
                if full.output_count % 3 != 0:
                    trail = src[full.input_count :]
                    tab = value_table(options)
                    empty = True
                    for c in trail:
                        c = int(c)
                        v = 255 if c != (c & 0xFF) else int(tab[c & 0xFF])
                        if v <= 63 or v == 64 or c == ord("="):
                            if v <= 63:
                                empty = False
                                break
                        else:
                            empty = False
                            break
                    if empty:
                        input_count = length
                return Result(full.error, input_count), _np_out(out)
            return Result(full.error, length), _np_out(out)
        return full.to_result(), _np_out(out)
    return _decode_safe_slow(src, capacity, options, last_chunk)


def _np_out(out) -> np.ndarray:
    return out if isinstance(out, np.ndarray) else np.frombuffer(bytes(out), np.uint8)


def _decode_safe_slow(src, capacity, options, last_chunk):
    """Capacity-limited decode: emulates the observable behavior of the
    reference's split path (base64_to_binary_safe_impl,
    implementation.cpp:2200-2394): success count = full input length
    (non-stop modes) or the resume position incl. consumed trailing
    padding/whitespace (stop_before_partial, implementation.cpp:2355-2386).
    """
    garbage = ignore_garbage(options)
    tab = value_table(options)

    def code(c):
        c = int(c)
        if c != (c & 0xFF):
            return 255
        return int(tab[c & 0xFF])

    length = int(src.shape[0]) if hasattr(src, "shape") else len(src)
    eq = ord("=")
    # prologue strip (spaces only, then '=' twice)
    while length > 0 and code(src[length - 1]) == 64:
        length -= 1
    pad_pos = length
    pad_count = 0
    if length > 0 and int(src[length - 1]) == eq:
        pad_pos = length - 1
        length -= 1
        pad_count += 1
        while length > 0 and code(src[length - 1]) == 64:
            length -= 1
        if length > 0 and int(src[length - 1]) == eq:
            pad_pos = length - 1
            length -= 1
            pad_count += 1
    empty_np = np.zeros(0, np.uint8)
    if length == 0:
        if not garbage and pad_count > 0:
            if last_chunk == STRICT:
                return Result(ec.BASE64_INPUT_REMAINDER, 0), empty_np
            if last_chunk == STOP_BEFORE_PARTIAL:
                return Result(ec.SUCCESS, 0), empty_np
            return Result(ec.INVALID_BASE64_CHARACTER, pad_pos), empty_np
        return Result(ec.SUCCESS, 0), empty_np

    orig_length = int(src.shape[0]) if hasattr(src, "shape") else len(src)
    out = bytearray()
    err, src_idx = tail_decode_safe(
        out, capacity, src, 0, length, pad_count, options, last_chunk
    )
    outlen = len(out)
    if (
        last_chunk != STOP_BEFORE_PARTIAL
        and err == ec.SUCCESS
        and pad_count > 0
    ):
        if (outlen % 3 == 0) or ((outlen % 3) + 1 + pad_count != 4):
            # reference keeps a path-dependent count here; we report the
            # padding location like the non-safe path (documented deviation)
            return (
                Result(ec.INVALID_BASE64_CHARACTER, pad_pos),
                _np_out(out),
            )
    if err == ec.SUCCESS:
        if last_chunk == STOP_BEFORE_PARTIAL:
            # consume expected trailing '=' + whitespace after a chunk the
            # padding completes (implementation.cpp:2355-2386)
            count = src_idx
            remainder = outlen % 3
            expected_padding = 0 if remainder == 0 else 3 - remainder
            if expected_padding > 0:
                while count < orig_length:
                    c = int(src[count])
                    if c == ord("="):
                        if expected_padding == 0:
                            break
                        expected_padding -= 1
                        count += 1
                    elif code(c) == 64:
                        count += 1
                    else:
                        break
            return Result(ec.SUCCESS, count), _np_out(out)
        # full success consumes the entire input (implementation.cpp:2388)
        return Result(ec.SUCCESS, orig_length), _np_out(out)
    return Result(err, src_idx), _np_out(out)
