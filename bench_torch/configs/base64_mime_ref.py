"""Plain reference of the forgiving-base64 decode's device results
(``simdutf_tpu_torch.ops.base64_ops.decode_bulk_routed`` with the default
alphabet), independent of the program: numpy masks sort the chars into the
alphabet, ASCII whitespace (skipped, as WHATWG forgiving-base64 skips it)
and the rest (invalid; ``=`` too, since the host strips the padding before
the device sees the chars), and CPython's ``binascii`` decodes the alphabet
chars.
"""

from __future__ import annotations

import binascii

import numpy as np

BIG = 2**31 - 1  # the decode's "no invalid char" position

_ALPHABET = (b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             b"0123456789+/")
_CODE = np.full(256, 255, np.uint8)  # 255: invalid, 64: whitespace
_CODE[np.frombuffer(_ALPHABET, np.uint8)] = np.arange(64, dtype=np.uint8)
_CODE[np.frombuffer(b" \t\n\r\f", np.uint8)] = 64


def decode(chars: np.ndarray, buffer_size: int) -> dict:
    """The decode's results for the uint8 ``chars`` staged in a buffer of
    ``buffer_size`` elements:

    * ``first_bad``: index of the first invalid char, BIG when none;
    * ``nvalid``: alphabet chars in range;
    * ``nvalid_at_bad``: alphabet chars before ``first_bad``; with none
      invalid, those before the buffer's last element;
    * ``tail_start``: index of the alphabet char of rank ``nvalid & ~3``,
      or ``length`` when ``nvalid`` is a multiple of 4;
    * ``tail``: the codes of ranks ``nvalid & ~3`` to ``+3``, 0 past
      ``nvalid``;
    * ``packed``: the bytes of the first ``nvalid & ~3`` alphabet chars.
    """
    length = len(chars)
    codes = _CODE[chars]
    valid = codes < 64
    bad = np.flatnonzero(codes == 255)
    first_bad = int(bad[0]) if len(bad) else BIG
    at = np.flatnonzero(valid)
    nvalid = len(at)
    if first_bad < BIG:
        nvalid_at_bad = int(np.count_nonzero(valid[:first_bad]))
    else:
        nvalid_at_bad = int(np.count_nonzero(valid[: buffer_size - 1]))
    nfull = nvalid // 4 * 4
    tail = [int(codes[at[nfull + k]]) if nfull + k < nvalid else 0 for k in range(4)]
    tail_start = int(at[nfull]) if nvalid > nfull else length
    packed = binascii.a2b_base64(chars[at[:nfull]].tobytes())
    return dict(first_bad=first_bad, nvalid=nvalid, nvalid_at_bad=nvalid_at_bad,
                tail_start=tail_start, tail=tail,
                packed=np.frombuffer(packed, np.uint8))
