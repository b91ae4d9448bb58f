"""The plain references against simdutf's rules and the port's CPU path."""

import random

import numpy as np
import pytest
import torch

from bench_torch.configs import base64_mime_ref as b64ref
from bench_torch.configs import utf8_to_utf16_ref as ref

CASES = [  # (bytes, code, pos) by simdutf's rules (include/simdutf/error.h)
    (b"abc", ref.SUCCESS, 3),
    (b"a\x80", ref.TOO_LONG, 1),
    (b"\xbfa", ref.TOO_LONG, 0),
    (b"ab\xf8", ref.HEADER_BITS, 2),
    (b"\xc2A", ref.TOO_SHORT, 0),
    (b"x\xe6\x9d", ref.TOO_SHORT, 1),
    (b"\xe0\x80A", ref.TOO_SHORT, 0),
    (b"\xc0\xaf", ref.OVERLONG, 0),
    (b"\xe0\x80\x80", ref.OVERLONG, 0),
    (b"\xf0\x8f\xbf\xbf", ref.OVERLONG, 0),
    (b"z\xed\xa0\x80", ref.SURROGATE, 1),
    (b"\xf4\x90\x80\x80", ref.TOO_LARGE, 0),
    (b"\xf5\x80\x80\x80", ref.TOO_LARGE, 0),
    ("é東🙂".encode() + b"\x80", ref.TOO_LONG, 9),
]


@pytest.mark.parametrize("data,code,pos", CASES)
def test_utf8_reference_rules(data, code, pos):
    c, p, units = ref.convert(data)
    assert (c, p) == (code, pos)
    assert units.tobytes() == data[:pos].decode("utf-8").encode("utf-16-le")


def _port_utf16(data: bytes):
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.ops import utf8 as o8

    buf, n = impl._pad(np.frombuffer(data, np.uint8))
    x, n = impl.to_device(buf, n, "cpu")
    code, pos, out, out_len = o8.to_utf16(x, n, False)
    m = int(out_len)
    return int(code), int(pos), out[:m].view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("seed", range(6))
def test_utf8_reference_matches_port_on_errors(seed):
    rng = random.Random(seed)
    pieces = ["a", " ", "é", "Ж", "東", "🙂"]
    bad = [b"\x80", b"\xff", b"\xc0\xaf", b"\xe0\x80\x80", b"\xed\xa0\x80",
           b"\xe6\x9d", b"\xf4\x90\x80\x80", b"\xf0\x9f", b"\xc3"]
    for _ in range(20):
        text = "".join(rng.choice(pieces) for _ in range(rng.randint(0, 300))).encode()
        k = rng.randint(0, len(text))
        while k < len(text) and text[k] & 0xC0 == 0x80:
            k += 1
        data = text[:k] + rng.choice(bad) + text[k:]
        code, pos, units = ref.convert(data)
        pcode, ppos, punits = _port_utf16(data)
        assert (code, pos) == (pcode, ppos), data
        assert np.array_equal(units, punits)


@pytest.mark.parametrize("seed", range(6))
def test_base64_reference_matches_port(seed):
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.ops import base64_ops as ob

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
                             np.uint8)
    n = int(rng.integers(1, 3000))
    chars = alphabet[rng.integers(0, 64, n)]
    ws = rng.random(n) < 0.1
    chars[ws] = np.frombuffer(b" \r\n\t\f", np.uint8)[rng.integers(0, 5, int(ws.sum()))]
    if seed % 2:
        chars[int(rng.integers(0, n))] = ord("=") if seed % 3 else ord("*")
    buf, length = impl._pad(chars)
    x, length = impl.to_device(buf, length, "cpu")
    first_bad, nvalid, nab, packed, tail_vals, tail_start = ob.decode_bulk_routed(
        x, length, url=False, both=False)
    r = b64ref.decode(chars, len(buf))
    assert [int(first_bad), int(nvalid), int(nab), int(tail_start)] == [
        r["first_bad"], r["nvalid"], r["nvalid_at_bad"], r["tail_start"]]
    assert tail_vals.tolist() == r["tail"]
    assert np.array_equal(packed[: len(r["packed"])].numpy(), r["packed"])
