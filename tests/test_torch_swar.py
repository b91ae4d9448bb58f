"""simdutf_tpu_torch.kernels.swar against the Pallas SWAR kernels.

Each plain version (the wrapper on a CPU tensor) gets the bytes or units
and the length, once in a buffer of exactly that size and once with
non-zero garbage stored past the length; the Pallas function
(``simdutf_tpu.kernels.swar.*_swar_first_bad_word``) gets its own padded
layout (``simdutf_tpu.kernels.impl._pad_swar`` / ``_pad_swar16``: one zero
tile fore and aft, zeros past the length) and runs in interpret mode, as
tests/test_swar.py runs it. The word indices must be equal, BIG included:
tests/test_swar.py's cases, errors at word, thread-group and block edges
(4, 16 and 4096 bytes), at the last byte, a 4-byte sequence cut at the
length, and the UTF-16 counterparts (lone surrogates at 0, at the edges
and at length-1, a pair across a word edge), LE and BE. Integer results:
exact.
"""

import numpy as np
import pytest
import torch

import helpers
from simdutf_tpu.kernels import swar as jsw
from simdutf_tpu.kernels.impl import _pad_swar, _pad_swar16
from simdutf_tpu_torch.kernels import swar as tsw


def _utf8_cases():
    cases = []
    cases += [(f"rand{s}", helpers.random_utf8(s, 300, 2, 1, 1, 1)) for s in range(6)]
    cases += [(f"mut{s}", helpers.mutate(helpers.random_utf8(s, 300, 1, 1, 1, 1), s, 2))
              for s in range(12)]
    cases += [(f"bytes{s}", helpers.random_bytes(s, 200)) for s in range(6)]
    fixed = [
        b"", b"a", b"\x80", b"\xc3", b"\xc3\xa9", b"\xc0\xaf", b"\xe0\x80\x80",
        b"\xed\x9f\xbf", b"\xed\xa0\x80", b"\xf0\x8f\xbf\xbf", b"\xf0\x90\x80\x80",
        b"\xf4\x8f\xbf\xbf", b"\xf4\x90\x80\x80", b"\xf5\x80\x80\x80", b"\xf8\x88",
        b"A" * 511 + b"\xe4\xb8\xad", b"A" * 32767 + b"\xc3\xa9",
        b"A" * 32765 + b"\xf0\x9f\x98\x80",
        b"A" * 32767 + b"\xf0\x9f\x98",  # cut: flags word 8192, past length // 4
    ]
    cases += [(f"fixed{i}", d) for i, d in enumerate(fixed)]
    for b0 in range(0xC0, 0xE0, 3):
        for b1 in (0x7F, 0x80, 0xBF, 0xC0):
            cases.append((f"pair{b0:02x}{b1:02x}", bytes([b0, b1])))
    base = "a é 東 \U0001f642 ".encode() * 600
    for pos in (0, 3, 4, 15, 16, 17, 4095, 4096, 4097, 8191, len(base) - 1):
        for bad in (b"\xff", b"\x80", b"\xed\xa0\x80", b"\xc0\xaf"):
            d = bytearray(base)
            d[pos:pos + len(bad)] = bad
            cases.append((f"{bad.hex()}@{pos}", bytes(d[:len(base)])))
    cases.append(("cut4@len", base[:5000] + "\U0001f642".encode()[:3]))
    cases.append(("lead@len-1", base[:4095] + b"\xe6"))
    return cases


def _utf16_cases():
    rng = np.random.default_rng(16)
    text = "a é 東 \U0001f642 \U0010ffff " * 500
    base = np.frombuffer(text.encode("utf-16-le"), np.uint16).copy()
    cases = [("empty", base[:0]), ("valid", base),
             ("pair@word", np.frombuffer(("x" + "\U0001f642" * 40).encode("utf-16-le"),
                                         np.uint16).copy())]
    for pos in (0, 1, 2, 3, 7, 8, 9, 2047, 2048, 2049, len(base) - 1):
        for bad in (0xD800, 0xDBFF, 0xDC00, 0xDFFF):
            d = np.full(len(base), 0x61, np.uint16) if pos % 2 else base.copy()
            d[pos] = bad
            cases.append((f"{bad:04x}@{pos}", d))
    cases.append(("hi@len-1", base[:-1]))  # the pair's low half cut off
    for t in range(8):
        d = base[: int(rng.integers(1, len(base)))].copy()
        for _ in range(t % 3):
            d[int(rng.integers(0, len(d)))] = int(rng.integers(0xD800, 0xE000))
        cases.append((f"fuzz{t}", d))
    return cases


UTF8 = _utf8_cases()
UTF16 = _utf16_cases()


def _bytes_buffers(data: bytes):
    """The data as an exact tensor, and stored with garbage past it."""
    arr = np.frombuffer(data, np.uint8)
    junk = np.random.default_rng(len(data)).integers(1, 256, 37).astype(np.uint8)
    return [torch.from_numpy(arr.copy()), torch.from_numpy(np.concatenate([arr, junk]))]


def _units_buffers(units: np.ndarray):
    junk = np.random.default_rng(len(units)).integers(1, 1 << 16, 9).astype(np.uint16)
    return [torch.from_numpy(a.view(np.int16).copy()).view(torch.uint16)
            for a in (units, np.concatenate([units, junk]))]


@pytest.mark.parametrize("name,data", UTF8, ids=[c[0] for c in UTF8])
def test_utf8_swar_matches_pallas(name, data):
    x32, _ = _pad_swar(np.frombuffer(data, np.uint8))
    want = int(jsw.utf8_swar_first_bad_word(x32))
    for buf in _bytes_buffers(data):
        assert int(tsw.utf8_swar_first_bad_word(buf, len(data))) == want


@pytest.mark.parametrize("name,data", UTF8, ids=[c[0] for c in UTF8])
def test_ascii_swar_matches_pallas(name, data):
    x32, _ = _pad_swar(np.frombuffer(data, np.uint8))
    want = int(jsw.ascii_swar_first_bad_word(x32))
    for buf in _bytes_buffers(data):
        assert int(tsw.ascii_swar_first_bad_word(buf, len(data))) == want


@pytest.mark.parametrize("name,units", UTF16, ids=[c[0] for c in UTF16])
@pytest.mark.parametrize("be", [False, True])
def test_utf16_swar_matches_pallas(name, units, be):
    stored = units.byteswap() if be else units
    x32, _ = _pad_swar16(stored)
    want = int(jsw.utf16_swar_first_bad_word(x32, be=be))
    for buf in _units_buffers(stored):
        assert int(tsw.utf16_swar_first_bad_word(buf, len(units), be)) == want


def test_cut_sequence_flags_the_word_after_the_length():
    data = b"A" * 32767 + b"\xf0\x9f\x98"
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert int(tsw.utf8_swar_first_bad_word(buf, len(data))) == 8192  # length // 4


def test_stale_byte_past_the_length_is_ignored():
    buf = torch.tensor([0x61, 0x62, 0xC3, 0xA9, 0xFF, 0xFF, 0xFF, 0xFF], dtype=torch.uint8)
    assert int(tsw.utf8_swar_first_bad_word(buf, 4)) == tsw.BIG
    assert int(tsw.ascii_swar_first_bad_word(buf, 2)) == tsw.BIG
    assert int(tsw.ascii_swar_first_bad_word(buf, 3)) == 0
    units = torch.from_numpy(np.array([0x61, 0xD800, 0xDC00], np.uint16).view(np.int16))
    units = units.view(torch.uint16)
    assert int(tsw.utf16_swar_first_bad_word(units, 2, False)) == 0  # lone high at length-1
    assert int(tsw.utf16_swar_first_bad_word(units, 3, False)) == tsw.BIG


def test_valid_text_never_flags():
    """No false positive of the zero-byte trick on valid text: random code
    points of every length class, the class edges among them."""
    rng = np.random.default_rng(2026)
    edges = np.array([0x0, 0x1, 0x7F, 0x80, 0x100, 0x7FF, 0x800, 0xD7FF, 0xE000, 0xFFFF,
                      0x10000, 0x10FFFF])
    for _ in range(500):
        cps = np.concatenate([rng.integers(0, 0x110000, 40), rng.choice(edges, 20)])
        cps = rng.permutation(cps[(cps < 0xD800) | (cps > 0xDFFF)])
        text = "".join(map(chr, cps.tolist()))
        data = np.frombuffer(text.encode(), np.uint8).copy()
        assert int(tsw.utf8_swar_first_bad_word(torch.from_numpy(data), len(data))) == tsw.BIG
        units = np.frombuffer(text.encode("utf-16-le"), np.uint16)
        for be in (False, True):
            stored = units.byteswap() if be else units
            buf = torch.from_numpy(stored.view(np.int16).copy()).view(torch.uint16)
            assert int(tsw.utf16_swar_first_bad_word(buf, len(units), be)) == tsw.BIG
