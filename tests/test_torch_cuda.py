"""The Hopper kernels against their plain torch versions, on the card.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip. On a
machine with the card:

    python -m pytest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(``chip_smoke.py`` runs the same comparisons at the full 64 MiB size.)
"""

import base64 as pyb64

import numpy as np
import pytest
import torch

from simdutf_tpu_torch.kernels import base64_kernel as kb
from simdutf_tpu_torch.kernels import census as kcen
from simdutf_tpu_torch.kernels import compact64 as kc64
from simdutf_tpu_torch.kernels import compaction as kcmp
from simdutf_tpu_torch.kernels import compose8 as kc8
from simdutf_tpu_torch.kernels import compose16 as kc
from simdutf_tpu_torch.kernels import compose32 as kc32
from simdutf_tpu_torch.kernels import composex as kcx
from simdutf_tpu_torch.kernels import detect_kernel as kdet
from simdutf_tpu_torch.kernels import swar as ksw
from simdutf_tpu_torch.kernels import transcode as ktr
from simdutf_tpu_torch.kernels import transcode32 as k32
from simdutf_tpu_torch.kernels import utf16_kernels as k16
from simdutf_tpu_torch.kernels import validate as kv
from simdutf_tpu_torch.ops import base64_ops as ob
from simdutf_tpu_torch.ops import latin1 as ol1
from simdutf_tpu_torch.ops import utf8 as o8
from simdutf_tpu_torch.ops import utf16 as o16
from simdutf_tpu_torch.ops import utf32 as o32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0")
    return torch.device("cuda")


def _inputs():
    rng = np.random.default_rng(0)
    alphabet = ["a", "é", "東", "\U0001f642", " "]
    bad = [b"\x80", b"\xff", b"\xe6\x9d", b"\xf0\x9f", b"\xed\xa0\x80"]
    out = [("u3", "東".encode() * 5000), ("empty", b"")]
    for t in range(12):
        size = int(rng.integers(1, 50_000))
        d = bytearray("".join(alphabet[i] for i in rng.integers(0, 5, size)).encode()[:size])
        for _ in range(t % 3):
            p = int(rng.integers(0, len(d) + 1))
            d[p:p] = bad[int(rng.integers(len(bad)))]
        out.append((f"fuzz{t}", bytes(d)))
    return out


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        if x.dtype == torch.uint16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x.to(torch.int64).cpu(), y.to(torch.int64).cpu()):
            return False
    return True


@pytest.mark.parametrize("name,data", _inputs())
def test_kernels_match_plain_versions(cuda, name, data):
    n = len(data) + 13  # bytes past the length are garbage
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    x, L = torch.from_numpy(buf).to(cuda), len(data)
    assert _same(kcen.census_bits(x, L), kcen.census_bits_ref(x, L))
    assert _same(kv.utf8_first_event_len(x, L), kv.utf8_first_event_len_ref(x, L))
    for what in ("count", "utf16", "latin1"):
        assert _same(kv._count_call(x, L, what), kv.count_ref(x, L, what))
    for be in (False, True):
        assert _same(kc.to_utf16_compose(x, L, be), kc.to_utf16_compose_ref(x, L, be))
    torch.cuda.synchronize()


def _inputs16():
    """(name, units in storage order for LE) for the UTF-16 kernels."""
    rng = np.random.default_rng(1)
    alphabet = ["a", "é", "東", "\U0001f642", " "]
    out = [("astral", "\U0001f642".encode("utf-16-le") * 3000),
           ("u2", "é".encode("utf-16-le") * 3000), ("empty", b"")]
    for t in range(12):
        size = int(rng.integers(1, 30_000))
        d = np.frombuffer("".join(alphabet[i] for i in rng.integers(0, 5, size))
                          .encode("utf-16-le"), np.uint16)[:size].copy()
        for _ in range(t % 3):  # lone surrogates
            d[int(rng.integers(0, len(d)))] = (0xD800, 0xDC00)[t % 2] + t
        out.append((f"fuzz{t}", d.tobytes()))
    # a high surrogate at length-1 whose low is stored at length
    pair = np.frombuffer("ab\U0001f642".encode("utf-16-le"), np.uint16)
    out.append(("hi@len-1", pair[:3].tobytes()))
    return out


@pytest.mark.parametrize("name,data", _inputs16())
@pytest.mark.parametrize("be", [False, True])
def test_utf16_kernels_match_plain_versions(cuda, name, data, be):
    units = np.frombuffer(data, np.uint16)
    L = len(units)
    n = L + 13  # units past the length are garbage
    buf = np.random.default_rng(n).integers(0, 1 << 16, n).astype(np.uint16)
    buf[:L] = units.byteswap() if be else units
    if name == "hi@len-1":
        buf[L] = 0xDE42 if not be else 0x42DE
    w = torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)
    assert _same(kcen.census16_bits(w, L, be), kcen.census16_bits_ref(w, L, be))
    assert _same(k16.utf16_first_bad(w, L, be), k16.utf16_first_bad_ref(w, L, be))
    for what in ("count", "utf8len"):
        assert _same(k16.utf16_reduce(w, L, be, what),
                     k16.utf16_reduce_ref(w, L, be, what))
    got = kc8.to_utf8_compose(w, L, be)
    assert _same(got, kc8.to_utf8_compose_ref(w, L, be))
    assert _same(got[1], k16.utf16_reduce(w, L, be, "utf8len"))
    torch.cuda.synchronize()


@pytest.mark.parametrize("be", [False, True])
def test_utf16_kernels_on_unaligned_views(cuda, be):
    """A view one unit into its storage: the 16-byte loads give way to
    unit loads, with the same results."""
    text = "ab é 東 \U0001f642 " * 3000
    units = np.frombuffer(text.encode("utf-16-be" if be else "utf-16-le"), np.uint16)
    buf = np.zeros(len(units) + 17, np.uint16)
    buf[1: len(units) + 1] = units
    buf[5000] = 0xDC if be else 0xDC00  # a lone low surrogate at unit 4999
    w = torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)[1:]
    assert w.data_ptr() % 16 != 0
    L = len(units)
    assert _same(kcen.census16_bits(w, L, be), kcen.census16_bits_ref(w, L, be))
    assert int(k16.utf16_first_bad(w, L, be)) == 4999
    for what in ("count", "utf8len"):
        assert _same(k16.utf16_reduce(w, L, be, what),
                     k16.utf16_reduce_ref(w, L, be, what))
    assert _same(kc8.to_utf8_compose(w, L, be), kc8.to_utf8_compose_ref(w, L, be))
    torch.cuda.synchronize()


def _inputs64():
    """(name, chars) for the base64 kernels: MIME text, dense whitespace,
    invalid chars at 0, at 4095-4096 and 8191 and at the end (the
    compaction's own tile edges are in ``_b64_cases``)."""
    rng = np.random.default_rng(2)
    raw = pyb64.b64encode(rng.bytes(30_000))
    mime = b"\r\n".join(raw[i: i + 76] for i in range(0, len(raw), 76))
    out = [("mime", mime), ("ws_tiles", b" " * 9000 + b"TWFu" + b"\n" * 5000 + b"QQ"),
           ("one", b"Q")]
    for pos in (0, 4095, 4096, 8191, len(mime) - 1):
        d = bytearray(mime)
        d[pos] = ord("*")
        out.append((f"bad@{pos}", bytes(d)))
    alphabet = np.frombuffer(b"AZaz09+/-_= \t\r\n\x0c*", np.uint8)
    for t in range(6):
        out.append((f"fuzz{t}", bytes(rng.choice(alphabet, int(rng.integers(1, 30_000))))))
    return out


@pytest.mark.parametrize("name,data", _inputs64())
@pytest.mark.parametrize("url,both", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("wide", [False, True])
def test_base64_kernels_match_plain_versions(cuda, name, data, url, both, wide):
    L = len(data)
    n = -(-(L + 13) // 4) * 4  # chars past the length are garbage
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    buf[:L] = np.frombuffer(data, np.uint8)
    if wide:
        buf = buf.astype(np.uint16)
        if name == "mime":  # a unit above 0xFF whose low byte is 'A'
            buf[L // 3] = 0x141
        x = torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)
    else:
        x = torch.from_numpy(buf).to(cuda)
    assert _same(kc64.compact_codes(x, L, url, both), kc64.compact_codes_ref(x, L, url, both))
    assert _same(kc64.compact_codes(x, n, url, both), kc64.compact_codes_ref(x, n, url, both))
    assert _same(ob.decode_bulk_routed(x, L, url, both), ob.decode_bulk(x, L, url, both))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [0, 4, 12, 16, 20, 1028, 3 * 1536 * 7])
@pytest.mark.parametrize("url", [False, True])
def test_base64_pack_and_encode_match_plain_versions(cuda, n, url):
    b = torch.from_numpy(np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)).to(cuda)
    assert _same(kb.pack(b), kb.pack_ref(b))
    m = n // 3 * 3
    assert _same(kb.encode(b[:m], url), kb.encode_ref(b[:m], url))
    # views off the 16-byte grid take the byte path
    if n > 16:
        assert _same(kb.pack(b[4:]), kb.pack_ref(b[4:]))
        assert _same(kb.encode(b[1:m - 2], url), kb.encode_ref(b[1:m - 2], url))
    torch.cuda.synchronize()


def test_base64_compact_on_unaligned_u16_view(cuda):
    """A view one unit into its storage: the 16-byte loads give way to
    unit loads, with the same results."""
    raw = pyb64.b64encode(np.random.default_rng(3).bytes(20_000))
    mime = np.frombuffer(b"\n".join(raw[i: i + 64] for i in range(0, len(raw), 64)), np.uint8)
    buf = np.zeros(len(mime) + 17, np.uint16)
    buf[1: len(mime) + 1] = mime
    buf[5000] = ord("*")  # an invalid char at 4999
    x = torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)[1:-4]
    assert x.data_ptr() % 16 != 0
    L = len(mime)
    got = kc64.compact_codes(x, L, False, False)
    assert _same(got, kc64.compact_codes_ref(x, L, False, False))
    assert int(got[2]) == 4999
    torch.cuda.synchronize()


def _inputs32():
    """(name, words) for the UTF-32 kernels: each class, words above
    0x10FFFF and surrogates at 0, at the 2048-word tile edges and at the
    end, words with the top bit set."""
    rng = np.random.default_rng(4)
    alphabet = ["a", "é", "東", "\U0001f642", " ", "\U0010ffff"]
    text = "".join(alphabet[i] for i in rng.integers(0, 6, 20_000))
    mixed = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    out = [("mixed", mixed), ("astral", np.full(5000, 0x1F642, np.uint32)),
           ("empty", np.zeros(0, np.uint32))]
    for pos, word in ((0, 0x110000), (2047, 0xD800), (2048, 0xDFFF),
                      (4097, 0x80000000), (len(mixed) - 1, 0xFFFFFFFF)):
        d = mixed.copy()
        d[pos] = word
        out.append((f"{word:x}@{pos}", d))
    return out


@pytest.mark.parametrize("name,words", _inputs32())
def test_utf32_kernels_match_plain_versions(cuda, name, words):
    L = len(words)
    n = L + 13  # words past the length are garbage
    buf = np.random.default_rng(n).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    buf[:L] = words
    w = torch.from_numpy(buf.view(np.int32)).to(cuda)
    assert _same(kv.utf32_first_bad(w, L), kv.utf32_first_bad_ref(w, L))
    for what in ("utf8len", "utf16len"):
        assert _same(kv.utf32_count(w, L, what), kv.utf32_count_ref(w, L, what))
    assert _same(kcx.u32_to_utf8_compose(w, L), kcx.u32_to_utf8_compose_ref(w, L))
    # a view one word into its storage takes the word loads
    if L > 1:
        v = w[1:]
        assert _same(kv.utf32_first_bad(v, L - 1), kv.utf32_first_bad_ref(v, L - 1))
        assert _same(kcx.u32_to_utf8_compose(v, L - 1), kcx.u32_to_utf8_compose_ref(v, L - 1))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,data", _inputs())
def test_compose32_matches_plain_version(cuda, name, data):
    n = len(data) + 13  # bytes past the length are garbage
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    x, L = torch.from_numpy(buf).to(cuda), len(data)
    assert _same(kc32.to_utf32_compose(x, L), kc32.to_utf32_compose_ref(x, L))
    torch.cuda.synchronize()


def _inputs16to32():
    """(name, native units) for utf16_to_utf32_compose: lone surrogates at
    0, at the 2048-unit tile edges and at the end, a pair straddling an
    edge."""
    rng = np.random.default_rng(5)
    alphabet = ["a", "é", "東", "\U0001f642", " ", "\U0010ffff"]
    text = "".join(alphabet[i] for i in rng.integers(0, 6, 12_000))
    mixed = np.frombuffer(text.encode("utf-16-le"), np.uint16)
    out = [("mixed", mixed), ("empty", np.zeros(0, np.uint16)),
           ("pair@2047", np.frombuffer(("x" * 2047 + "\U0001f642é").encode("utf-16-le"),
                                       np.uint16))]
    for pos, unit in ((0, 0xDC00), (2047, 0xD800), (2048, 0xDFFF), (4095, 0xDBFF),
                      (len(mixed) - 1, 0xD83D)):
        d = mixed.copy()
        d[pos] = unit
        out.append((f"{unit:x}@{pos}", d))
    return out


@pytest.mark.parametrize("name,units", _inputs16to32())
@pytest.mark.parametrize("be", [False, True])
def test_utf16_to_utf32_compose_matches_plain_version(cuda, name, units, be):
    L = len(units)
    n = L + 13  # units past the length are garbage
    buf = np.random.default_rng(n).integers(0, 1 << 16, n).astype(np.uint16)
    buf[:L] = units.byteswap() if be else units
    w = torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)
    assert _same(kcx.u16_to_utf32_compose(w, L, be), kcx.u16_to_utf32_compose_ref(w, L, be))
    if L > 1:  # a view one unit into its storage takes the unit loads
        v = w[1:]
        assert _same(kcx.u16_to_utf32_compose(v, L - 1, be),
                     kcx.u16_to_utf32_compose_ref(v, L - 1, be))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,words", _inputs32())
@pytest.mark.parametrize("be", [False, True])
def test_utf32_to_utf16_compose_matches_plain_version(cuda, name, words, be):
    L = len(words)
    n = L + 13  # words past the length are garbage
    buf = np.random.default_rng(n).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    buf[:L] = words
    w = torch.from_numpy(buf.view(np.int32)).to(cuda)
    assert _same(kcx.u32_to_utf16_compose(w, L, be), kcx.u32_to_utf16_compose_ref(w, L, be))
    if L > 1:
        v = w[1:]
        assert _same(kcx.u32_to_utf16_compose(v, L - 1, be),
                     kcx.u32_to_utf16_compose_ref(v, L - 1, be))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [0, 1, 7, 8, 2048, 2049, 100_003])
def test_latin1_to_utf8_compose_matches_plain_version(cuda, n):
    rng = np.random.default_rng(n)
    buf = rng.integers(0, 256, n + 13).astype(np.uint8)  # garbage past n
    b = torch.from_numpy(buf).to(cuda)
    assert _same(kcx.latin1_to_utf8_compose(b, n), kcx.latin1_to_utf8_compose_ref(b, n))
    if n > 1:  # off the 8-byte grid: byte loads
        assert _same(kcx.latin1_to_utf8_compose(b[3:], n - 1),
                     kcx.latin1_to_utf8_compose_ref(b[3:], n - 1))
    torch.cuda.synchronize()


def test_compose_wrappers_make_no_host_sync(cuda):
    """Every compose and compaction wrapper runs without a device-to-host
    read: count pass, tile_glue and emit pass of the two-pass ones, the
    status reset and the one launch of compose16, compose32, compose8 and
    b64_compact."""
    data = ("ab é 東 \U0001f642 " * 5000).encode()
    x = torch.from_numpy(np.frombuffer(data + b"\xff", np.uint8).copy()).to(cuda)
    text = data.decode()
    w16 = torch.from_numpy(np.frombuffer(text.encode("utf-16-le"), np.int16).copy()
                           ).to(cuda).view(torch.uint16)
    w32 = torch.from_numpy(np.frombuffer(text.encode("utf-32-le"), np.int32).copy()).to(cuda)
    b64 = pyb64.b64encode(data)
    chars = torch.from_numpy(np.frombuffer(b64, np.uint8).copy()).to(cuda)
    calls = [lambda: kc.to_utf16_compose(x, x.numel(), False),
             lambda: kc8.to_utf8_compose(w16, w16.numel(), False),
             lambda: kc32.to_utf32_compose(x, x.numel()),
             lambda: kcx.u32_to_utf8_compose(w32, w32.numel()),
             lambda: kc64.compact_codes(chars, chars.numel(), False, False),
             lambda: kcx.u16_to_utf32_compose(w16, w16.numel(), False),
             lambda: kcx.u32_to_utf16_compose(w32, w32.numel(), True),
             lambda: kcx.latin1_to_utf8_compose(x, x.numel())]
    for call in calls:  # build and load the library first
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _inputs_u():
    """(name, bytes) for the ASCII and detect kernels and compose16 without
    its clamp: the UTF-8 inputs, the valid-only converters' invalid edges,
    ASCII with a high byte at 0, at a 512-byte warp step and at the end, and
    the UTF-16LE / UTF-32LE forms of mixed text with bad units and words."""
    text = "ab é 東 \U0001f642 " * 3000
    u16, u32 = text.encode("utf-16-le"), text.encode("utf-32-le")
    out = _inputs() + [("e6", b"\xe6"), ("a-ff-b", b"a\xffb"), ("cut4", b"ab\xf0\x90"),
                       ("ascii", b"x" * 70_000)]
    for pos in (0, 511, 512, 69_999):
        out.append((f"ascii-high@{pos}", b"x" * pos + b"\xc3" + b"x" * (69_999 - pos)))
    out += [("utf16le", u16), ("utf16le-odd", u16 + b"a"), ("utf16le-hi-last", u16[:-2] + b"\x3d\xd8"),
            ("utf16le-lo-first", b"\x00\xdc" + u16[2:]), ("utf32le", u32), ("utf32le+3", u32 + b"abc"),
            ("utf32le-top-bit", u32[:4096] + b"\x00\x00\x00\x80" + u32[4100:])]
    return out


@pytest.mark.parametrize("name,data", _inputs_u())
def test_ascii_detect_and_unclamped_compose16_match_plain_versions(cuda, name, data):
    n = len(data) + 13  # bytes past the length are garbage
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    x, L = torch.from_numpy(buf).to(cuda), len(data)
    for length in (L, n):
        assert _same(kv.ascii_first_bad(x, length), kv.ascii_first_bad_ref(x, length))
        assert _same(kdet.detect_fused(x, length), kdet.detect_fused_ref(x, length))
    for be in (False, True):
        assert _same(kc.to_utf16_compose(x, L, be, clamp=False),
                     kc.to_utf16_compose_ref(x, L, be, clamp=False))
    if L > 1:  # a view off the 16-byte grid takes the byte loads
        v = x[3:]
        assert _same(kv.ascii_first_bad(v, L - 3), kv.ascii_first_bad_ref(v, L - 3))
        assert _same(kdet.detect_fused(v, L - 3), kdet.detect_fused_ref(v, L - 3))
    torch.cuda.synchronize()


def _inputs16_valid():
    """The UTF-16 inputs plus the valid-only converters' invalid edges and
    a run of lone highs longer than the 3N-byte buffer can hold."""
    return _inputs16() + [
        ("d83d", np.array([0xD83D], np.uint16).tobytes()),
        ("a-dc00-b", np.array([0x61, 0xDC00, 0x62], np.uint16).tobytes()),
        ("a-d800-b", np.array([0x61, 0xD800, 0x62], np.uint16).tobytes()),
        ("highs", np.full(5000, 0xDBFF, np.uint16).tobytes())]


@pytest.mark.parametrize("name,data", _inputs16_valid())
@pytest.mark.parametrize("be", [False, True])
def test_well_formed_and_valid_compose8_match_plain_versions(cuda, name, data, be):
    units = np.frombuffer(data, np.uint16)
    L = len(units)
    n = L + (0 if name == "highs" else 13)  # units past the length are garbage
    buf = np.random.default_rng(n).integers(0, 1 << 16, n).astype(np.uint16)
    buf[:L] = units.byteswap() if be else units
    if name == "hi@len-1":
        buf[L] = 0xDE42 if not be else 0x42DE
    w = torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)
    assert _same(k16.utf16_to_well_formed(w, L, be), k16.utf16_to_well_formed_ref(w, L, be))
    assert _same(kc8.to_utf8_compose(w, L, be, mode="valid"),
                 kc8.to_utf8_compose_ref(w, L, be, mode="valid"))
    if L > 1:  # a view one unit into its storage takes the unit loads
        v = w[1:]
        assert _same(k16.utf16_to_well_formed(v, L - 1, be),
                     k16.utf16_to_well_formed_ref(v, L - 1, be))
        assert _same(kc8.to_utf8_compose(v, L - 1, be, mode="valid"),
                     kc8.to_utf8_compose_ref(v, L - 1, be, mode="valid"))
    torch.cuda.synchronize()


# the fixed-rate kernels: name -> (class char, out-of-class values); the
# widen kernels take bytes, the narrow kernels units
_FIXED = {
    "ascii_widen_utf16": ("a", (0x80, 0xFF)),
    "uniform2_utf8_to_utf16": ("é", (0x41, 0xC1)),
    "uniform3_utf8_to_utf16": ("東", (0x41, 0xC3)),
    "astral_utf8_to_utf16": ("\U0001f642", (0x41, 0xC3)),
    "ascii_narrow_utf8": ("a", (0x80, 0x100)),
    "uniform2_utf16_to_utf8": ("é", (0x7F, 0x800)),
    "uniform3_utf16_to_utf8": ("東", (0x7FF, 0xD800)),
}


def _fixed_elements(name: str, count: int) -> np.ndarray:
    ch = _FIXED[name][0]
    if name.endswith("utf16"):  # a widen kernel: UTF-8 bytes
        return np.frombuffer((ch * count).encode(), np.uint8)[:count].copy()
    return np.frombuffer((ch * count).encode("utf-16-le"), np.uint16)[:count].copy()


def _inputs_fixed():
    """(kernel, case, native elements): class text cut to lengths 0-3 and
    to lengths no multiple of 2, 3, 12 or 48 (a cut character flags), and
    out-of-class elements at 0, at the thread and block steps (16 and 48
    bytes, 8 and 16 units a thread; 256 threads a block) and at the end."""
    out = []
    for name, (_, bad) in _FIXED.items():
        for count in (0, 1, 2, 3, 5, 47, 49, 97, 1001, 12_289, 50_011):
            out.append((name, f"len{count}", _fixed_elements(name, count)))
        base = _fixed_elements(name, 50_011)
        for pos in (0, 15, 16, 47, 2047, 2048, 4095, 4096, 12_287, 12_288, 50_010):
            d = base.copy()
            d[pos] = bad[pos % 2]
            out.append((name, f"{bad[pos % 2]:#x}@{pos}", d))
    return out


def _stored(data: np.ndarray, be: bool, pad: int, cuda):
    """The elements in storage order with ``pad`` garbage elements past
    them, on the card."""
    L = len(data)
    bits = 8 * data.itemsize
    buf = np.random.default_rng(L + pad).integers(0, 1 << bits, L + pad).astype(data.dtype)
    buf[:L] = data.byteswap() if be and data.dtype == np.uint16 else data
    if buf.dtype == np.uint8:
        return torch.from_numpy(buf).to(cuda)
    return torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)


@pytest.mark.parametrize("name,case,data", _inputs_fixed(),
                         ids=[f"{n}-{c}" for n, c, _ in _inputs_fixed()])
@pytest.mark.parametrize("be", [False, True])
def test_fixed_rate_kernels_match_plain_versions(cuda, name, case, data, be):
    x = _stored(data, be, 13, cuda)  # elements past the length are garbage
    L = len(data)
    fn, ref = getattr(ktr, name), getattr(ktr, name + "_ref")
    got = fn(x, L, be)
    assert _same(got, ref(x, L, be))
    width = 1 if name.startswith("ascii") or name.endswith("utf8") else len(_FIXED[name][0].encode())
    # out-of-class elements flag, and so does a character cut at the length
    assert int(got[1]) == (not case.startswith("len") or L % width != 0)
    if L > 1:  # a view off the 16-byte grid takes the element loads
        assert _same(fn(x[1:], L - 1, be), ref(x[1:], L - 1, be))
    torch.cuda.synchronize()


@pytest.mark.parametrize("ch", ["a", "é", "東", "\U0001f642"])
@pytest.mark.parametrize("chars", [1, 2, 3, 5, 47, 49, 97, 4097, 50_011])
@pytest.mark.parametrize("be", [False, True])
def test_fixed_rate_flag_is_clear_on_census_classes(cuda, ch, chars, be):
    """Each class the census admits runs its kernel with a clear flag, and
    the routed call gives CPython's bytes (the astral class has no UTF-16
    -> UTF-8 kernel)."""
    text = ch * chars
    utf8, utf16 = text.encode(), text.encode("utf-16-be" if be else "utf-16-le")
    units = len(utf16) // 2
    x = _stored(np.frombuffer(utf8, np.uint8).copy(), False, 7, cuda)
    w = _stored(np.frombuffer(text.encode("utf-16-le"), np.uint16).copy(), be, 7, cuda)
    which = {"a": 0, "é": 1, "東": 2, "\U0001f642": 3}[ch]
    census8 = o8.census_full(x, len(utf8))[:4]
    census16 = o16.census(w, units, be)
    assert census8 == census16 == tuple(i == which for i in range(4))
    widen = ("ascii_widen_utf16", "uniform2_utf8_to_utf16", "uniform3_utf8_to_utf16",
             "astral_utf8_to_utf16")[which]
    assert int(getattr(ktr, widen)(x, len(utf8), be)[1]) == 0
    if which < 3:
        narrow = ("ascii_narrow_utf8", "uniform2_utf16_to_utf8", "uniform3_utf16_to_utf8")[which]
        assert int(getattr(ktr, narrow)(w, units, be)[1]) == 0
    code, pos, out, out_len = o8.to_utf16(x, len(utf8), be)
    assert (int(code), int(pos), int(out_len)) == (0, len(utf8), units)
    assert out[:units].view(torch.int16).cpu().numpy().tobytes() == utf16
    assert not out[units:].view(torch.int16).any()
    code, pos, out, out_len = o16.to_utf8(w, units, be)
    assert (int(code), int(pos), int(out_len)) == (0, units, len(utf8))
    assert out[:len(utf8)].cpu().numpy().tobytes() == utf8
    assert not out[len(utf8):].any()
    torch.cuda.synchronize()


def test_fixed_rate_wrappers_make_no_host_sync(cuda):
    x = torch.from_numpy(np.frombuffer("é".encode() * 5000, np.uint8).copy()).to(cuda)
    w = torch.from_numpy(np.frombuffer("東".encode("utf-16-le") * 5000, np.int16).copy()
                         ).to(cuda).view(torch.uint16)
    calls = [lambda name=name: getattr(ktr, name)(x if name.endswith("utf16") else w,
                                                  5000, True) for name in _FIXED]
    for call in calls:  # build and load the library first
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# the UTF-32 fixed-rate kernels: name -> (kind, class char, out-of-class
# values); "from8" takes UTF-8 bytes, "from16" UTF-16 units, "to8" and
# "to16" UTF-32 words (0x80000000 and up are negative int32)
_FIXED32 = {
    "latin1_widen_utf32": ("from8", "a", (0x80, 0xFF)),
    "uniform2_utf8_to_utf32": ("from8", "é", (0x41, 0xC1)),
    "uniform3_utf8_to_utf32": ("from8", "東", (0x41, 0xC3)),
    "astral_utf8_to_utf32": ("from8", "\U0001f642", (0x41, 0xC3)),
    "uniform2_utf32_to_utf8": ("to8", "é", (0x7F, 0x80000000)),
    "uniform3_utf32_to_utf8": ("to8", "東", (0xD800, 0xFFFFFFFF)),
    "astral_utf32_to_utf8": ("to8", "\U0001f642", (0x110000, 0x80000000)),
    "bmp_widen_utf32": ("from16", "東", (0xD800, 0xDFFF)),
    "astral_utf16_to_utf32": ("from16", "\U0001f642", (0x41, 0xE000)),
    "bmp_narrow_utf16": ("to16", "東", (0x10000, 0xDC00)),
    "astral_utf32_to_utf16": ("to16", "\U0001f642", (0xFFFF, 0xFFFFFFFF)),
}


def _fixed32_elements(name: str, count: int) -> np.ndarray:
    kind, ch, _ = _FIXED32[name]
    text = ch * count
    if kind == "from8":
        return np.frombuffer(text.encode(), np.uint8)[:count].copy()
    if kind == "from16":
        return np.frombuffer(text.encode("utf-16-le"), np.uint16)[:count].copy()
    return np.frombuffer(text.encode("utf-32-le"), np.uint32)[:count].copy()


def _fixed32_width(name: str) -> int:
    """Input elements a code point."""
    kind, ch, _ = _FIXED32[name]
    if kind == "from8":
        return len(ch.encode())
    return 2 if kind == "from16" and ord(ch) > 0xFFFF else 1


def _inputs_fixed32():
    """(kernel, case, native elements, be): class text cut to lengths 0-9
    and around the thread (4 code points) and block (1024 code points)
    steps, one length past a whole grid's stride, and out-of-class elements
    at 0, at those steps and at the end; LE and BE for the UTF-16 ones."""
    out = []
    for name, (kind, _, bad) in _FIXED32.items():
        cases = []
        for count in (0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 17, 1023, 1025, 4097, 50_011, 1_200_007):
            cases.append((f"len{count}", _fixed32_elements(name, count)))
        base = _fixed32_elements(name, 50_011)
        for pos in (0, 3, 4, 15, 16, 1023, 1024, 4095, 4096, 50_010):
            d = base.copy()
            d[pos] = bad[pos % 2]
            cases.append((f"{bad[pos % 2]:#x}@{pos}", d))
        for be in (False, True) if kind in ("from16", "to16") else (False,):
            out += [(name, case, d, be) for case, d in cases]
    return out


def _stored32(data: np.ndarray, be: bool, pad: int, cuda):
    """The elements in storage order with ``pad`` garbage elements past
    them, on the card."""
    L = len(data)
    bits = 8 * data.itemsize
    buf = np.random.default_rng(L + pad).integers(0, 1 << bits, L + pad, dtype=np.uint64)
    buf = buf.astype(data.dtype)
    buf[:L] = data.byteswap() if be and data.dtype == np.uint16 else data
    if buf.dtype == np.uint8:
        return torch.from_numpy(buf).to(cuda)
    if buf.dtype == np.uint16:
        return torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)
    return torch.from_numpy(buf.view(np.int32)).to(cuda)


def _call32(name: str, x, length: int, be: bool, plain: bool = False):
    fn = getattr(k32, name + "_ref" if plain else name)
    return fn(x, length, be) if _FIXED32[name][0] in ("from16", "to16") else fn(x, length)


@pytest.mark.parametrize("name,case,data,be", _inputs_fixed32(),
                         ids=[f"{n}-{c}-{'be' if b else 'le'}" for n, c, _, b in _inputs_fixed32()])
def test_fixed_rate32_kernels_match_plain_versions(cuda, name, case, data, be):
    x = _stored32(data, be, 13, cuda)  # elements past the length are garbage
    L = len(data)
    got = _call32(name, x, L, be)
    assert _same(got, _call32(name, x, L, be, plain=True))
    # out-of-class elements flag, and so does a character cut at the length
    assert int(got[1]) == (not case.startswith("len") or L % _fixed32_width(name) != 0)
    if L > 1:  # a view off the vector grid takes the element accesses
        assert _same(_call32(name, x[1:], L - 1, be), _call32(name, x[1:], L - 1, be, plain=True))
    torch.cuda.synchronize()


@pytest.mark.parametrize("ch", ["a", "é", "東", "\U0001f642"])
@pytest.mark.parametrize("chars", [1, 3, 5, 1023, 1025, 50_011])
@pytest.mark.parametrize("be", [False, True])
def test_fixed_rate32_flag_is_clear_on_census_classes(cuda, ch, chars, be):
    """Each class the census admits runs its kernel with a clear flag, and
    the routed calls give CPython's bytes in every direction of UTF-32
    (UTF-32 -> UTF-8 of ASCII has no kernel)."""
    text = ch * chars
    utf8, utf32 = text.encode(), text.encode("utf-32-le")
    utf16 = text.encode("utf-16-be" if be else "utf-16-le")
    units, words = len(utf16) // 2, len(utf32) // 4
    which = {"a": 0, "é": 1, "東": 2, "\U0001f642": 3}[ch]
    x = _stored32(np.frombuffer(utf8, np.uint8).copy(), False, 7, cuda)
    w = _stored32(np.frombuffer(text.encode("utf-16-le"), np.uint16).copy(), be, 7, cuda)
    v = _stored32(np.frombuffer(utf32, np.uint32).copy(), False, 7, cuda)
    assert o8.census_full(x, len(utf8))[:4] == tuple(i == which for i in range(4))
    assert o32.census(v, words) == tuple(i == which for i in range(4)) + (which < 3,)
    assert o16.census32(w, units, be) == (which < 3, which == 3)
    from8 = ("latin1_widen_utf32", "uniform2_utf8_to_utf32", "uniform3_utf8_to_utf32",
             "astral_utf8_to_utf32")[which]
    assert int(_call32(from8, x, len(utf8), be)[1]) == 0
    if which:
        to8 = ("uniform2_utf32_to_utf8", "uniform3_utf32_to_utf8", "astral_utf32_to_utf8")[which - 1]
        assert int(_call32(to8, v, words, be)[1]) == 0
    bmp = which < 3
    assert int(_call32("bmp_narrow_utf16" if bmp else "astral_utf32_to_utf16", v, words, be)[1]) == 0
    assert int(_call32("bmp_widen_utf32" if bmp else "astral_utf16_to_utf32", w, units, be)[1]) == 0

    def check(result, want: bytes, nbytes: int):
        code, pos, out, out_len = result
        view = out.view(torch.int16) if out.dtype == torch.uint16 else out
        raw = view.cpu().numpy().tobytes()
        assert (int(code), int(out_len) * nbytes) == (0, len(want))
        assert raw[: len(want)] == want and not any(raw[len(want):])

    check(o8.to_utf32(x, len(utf8)), utf32, 4)
    check(o32.to_utf8(v, words), utf8, 1)
    check(o32.to_utf16(v, words, be), utf16, 2)
    check(o16.to_utf32(w, units, be), utf32, 4)
    lat = torch.arange(256, dtype=torch.int32, device=cuda).to(torch.uint8).repeat(chars)
    assert torch.equal(ol1.to_utf32(lat, lat.numel()).cpu(), lat.cpu().to(torch.int32))
    torch.cuda.synchronize()


def test_fixed_rate32_wrappers_make_no_host_sync(cuda):
    inputs = {"from8": torch.from_numpy(np.frombuffer("é".encode() * 5000, np.uint8).copy()),
              "from16": torch.from_numpy(np.frombuffer("東".encode("utf-16-le") * 5000, np.int16)
                                         .copy()).view(torch.uint16),
              "to8": torch.full((5000,), 0x6771, dtype=torch.int32)}
    inputs["to16"] = inputs["to8"]
    inputs = {k: v.to(cuda) for k, v in inputs.items()}
    calls = [lambda name=name: _call32(name, inputs[_FIXED32[name][0]], 5000, True)
             for name in _FIXED32]
    for call in calls:  # build and load the library first
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# -- widen32 (#24 latin1_widen_utf32, #26 bmp_widen_utf32): tile edges ------

#: widen32's entry points: (element dtype, out-of-class element, src bytes)
_WIDEN = {"latin1_widen_utf32": (np.uint8, 0x80, 1), "bmp_widen_utf32": (np.uint16, 0xDC00, 2)}
_WIDEN_CASES = [(name, be) for name in _WIDEN
                for be in ((False, True) if name == "bmp_widen_utf32" else (False,))]


def _widen_data(name: str, n: int, length: int, be: bool, seed: int) -> np.ndarray:
    """Storage-order elements: random class elements before ``length``,
    random garbage (out-of-class elements among it) after it."""
    dtype = _WIDEN[name][0]
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, np.iinfo(dtype).max + 1, n).astype(dtype)
    if dtype == np.uint8:
        buf[:length] = rng.integers(0, 0x80, length)
    else:
        v = rng.integers(0, 0xF800, length).astype(np.uint16)
        v[v >= 0xD800] += 0x800  # no surrogate
        buf[:length] = v.byteswap() if be else v
    return buf


def _widen_put(buf: np.ndarray, pos: int, value: int, be: bool) -> None:
    v = np.array([value], buf.dtype)
    buf[pos] = (v.byteswap() if be and buf.dtype == np.uint16 else v)[0]


def _widen_card(buf: np.ndarray, cuda):
    if buf.dtype == np.uint8:
        return torch.from_numpy(buf).to(cuda)
    return torch.from_numpy(buf.view(np.int16)).to(cuda).view(torch.uint16)


def _widen_call(name: str, x, length: int, be: bool, plain: bool = False):
    fn = getattr(k32, name + "_ref" if plain else name)
    return fn(x, length, be) if name == "bmp_widen_utf32" else fn(x, length)


def _widen_check(name: str, x, length: int, be: bool, flag: bool) -> None:
    got = _widen_call(name, x, length, be)
    assert _same(got, _widen_call(name, x, length, be, plain=True))
    assert int(got[1]) == flag


@pytest.mark.parametrize("name,be", _WIDEN_CASES)
@pytest.mark.parametrize("case", ["tile-1", "tile", "tile+1", "wave-1", "wave+1", "zero-tail",
                                  "bad-first", "bad-last", "bad-past"])
def test_widen32_tile_edges_match_plain_version(cuda, name, be, case):
    """Lengths around one tile and around the stages x the tiles of one
    wave (widen32_plan), a zero tail over many tiles with garbage past the
    length, and an out-of-class element at the first and the last
    in-range position of a tile (flags) and one past the length (does
    not): output and flag as the plain twin's."""
    plan = k32.widen32_plan(_WIDEN[name][2])
    T = plan["tile_words"]
    wave = plan["stages"] * plan["grid"] * T
    n, length, bad = {
        "tile-1": (T - 1, T - 1, None), "tile": (T, T, None), "tile+1": (T + 1, T + 1, None),
        "wave-1": (wave - 1, wave - 1, None), "wave+1": (wave + 1, wave + 1, None),
        "zero-tail": (40 * T + 5, T + 3, None),
        "bad-first": (3 * T + 100, 2 * T + 37, T), "bad-last": (3 * T + 100, 2 * T + 37, 2 * T - 1),
        "bad-past": (3 * T + 100, 2 * T + 37, 2 * T + 37),
    }[case]
    buf = _widen_data(name, n, length, be, seed=n + length)
    if bad is not None:
        _widen_put(buf, bad, _WIDEN[name][1], be)
    _widen_check(name, _widen_card(buf, cuda), length, be, bad is not None and bad < length)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,be,off", [(name, be, off) for name, be in _WIDEN_CASES
                                         for off in ((1, 2, 4, 8) if name == "latin1_widen_utf32"
                                                     else (1, 2, 4))])
@pytest.mark.parametrize("bad", [False, True])
def test_widen32_views_off_the_grid_match_plain_version(cuda, name, be, off, bad):
    """Views that start off the 16-byte grid at every offset the dtype
    allows: those a multiple of four elements' bytes off it take a head of
    element steps before the tiles, the others the element path over the
    whole buffer."""
    n = 5 * 4096 + 7
    buf = _widen_data(name, n, n - 3, be, seed=off)
    if bad:
        _widen_put(buf, off + 3 * 4096 + 1, _WIDEN[name][1], be)
    x = _widen_card(buf, cuda)[off:]
    _widen_check(name, x, n - 3 - off, be, bad)
    torch.cuda.synchronize()


# -- the pallas tier's kernels: SWAR, clean decode, row compaction, probe ---

def _inputs_swar():
    """(case, bytes): errors at the word, thread (16 bytes) and block (4096
    bytes) steps, at the last byte, a 4-byte sequence cut at the length."""
    base = "a é 東 \U0001f642 ".encode() * 2000
    out = [("valid", base), ("empty", b""), ("cut4@len", base[:9000] + "\U0001f642".encode()[:3]),
           ("A*32767-cut", b"A" * 32767 + b"\xf0\x9f\x98")]
    for pos in (0, 3, 4, 15, 16, 4095, 4096, 4097, 8191, len(base) - 1):
        for bad in (b"\xff", b"\x80", b"\xed\xa0\x80"):
            d = bytearray(base)
            d[pos:pos + len(bad)] = bad
            out.append((f"{bad.hex()}@{pos}", bytes(d[:len(base)])))
    return out


@pytest.mark.parametrize("case,data", _inputs_swar(), ids=[c for c, _ in _inputs_swar()])
def test_swar_utf8_and_ascii_match_plain_versions(cuda, case, data):
    x = _stored(np.frombuffer(data, np.uint8).copy(), False, 11, cuda)  # garbage past the length
    L = len(data)
    for fn, ref in ((ksw.utf8_swar_first_bad_word, ksw.utf8_swar_first_bad_word_ref),
                    (ksw.ascii_swar_first_bad_word, ksw.ascii_swar_first_bad_word_ref)):
        assert int(fn(x, L)) == int(ref(x, L))
        if L > 1:  # a view off the 16-byte grid takes the word loads
            assert int(fn(x[1:], L - 1)) == int(ref(x[1:], L - 1))
    torch.cuda.synchronize()


def _inputs_swar16():
    base = np.frombuffer(("a é 東 \U0001f642 " * 1500).encode("utf-16-le"), np.uint16)
    out = [("valid", base.copy()), ("hi@len-1", base[:-1].copy())]
    for pos in (0, 1, 7, 8, 2047, 2048, 2049, len(base) - 1):
        for bad in (0xD800, 0xDC00):
            d = base.copy()
            d[pos] = bad
            out.append((f"{bad:04x}@{pos}", d))
    return out


@pytest.mark.parametrize("case,units", _inputs_swar16(), ids=[c for c, _ in _inputs_swar16()])
@pytest.mark.parametrize("be", [False, True])
def test_swar_utf16_matches_plain_version(cuda, case, units, be):
    w = _stored(units, be, 5, cuda)
    L = len(units)
    assert int(ksw.utf16_swar_first_bad_word(w, L, be)) == int(
        ksw.utf16_swar_first_bad_word_ref(w, L, be))
    assert int(ksw.utf16_swar_first_bad_word(w[1:], L - 1, be)) == int(
        ksw.utf16_swar_first_bad_word_ref(w[1:], L - 1, be))
    torch.cuda.synchronize()


@pytest.mark.parametrize("url,both", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("case", ["clean", "short-nwords", "eq", "space", "ragged-view"])
def test_clean_decode_matches_plain_version(cuda, url, both, case):
    raw = np.random.default_rng(7).integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    chars = bytearray(pyb64.urlsafe_b64encode(raw) if url else pyb64.b64encode(raw))
    nwords = len(chars) // 4
    if case == "short-nwords":
        nwords -= 1001
    elif case == "eq":
        chars[40_001] = ord("=")
    elif case == "space":
        chars[len(chars) - 1] = ord(" ")
    x = torch.from_numpy(np.frombuffer(bytes(chars), np.uint8).copy()).to(cuda)
    if case == "ragged-view":
        x, nwords = x[4:], nwords - 1
    got = kb.clean_decode(x, nwords, url, both)
    assert _same(got, kb.clean_decode_ref(x, nwords, url, both))
    assert int(got[1]) == (case in ("eq", "space"))
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows,width", [(8, 128), (4, 256), (3, 1), (5, 32), (6, 64),
                                        (2, 4096), (1000, 128)])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_row_compact_matches_plain_version(cuda, rows, width, density):
    rng = np.random.default_rng(rows * width)
    val = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, width)).astype(np.int32)).to(cuda)
    keep = torch.from_numpy(rng.random((rows, width)) < density).to(cuda)
    assert _same(kcmp.row_compact(val, keep), kcmp.row_compact_ref(val, keep))
    three = torch.zeros((rows, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kcmp.row_compact(three, three)
    torch.cuda.synchronize()


def test_lane_shapecast_probe(cuda):
    tile = np.random.default_rng(9).integers(-2**31, 2**31, (64, 512)).astype(np.int32)
    x = torch.from_numpy(tile).to(cuda)
    for salt in (1, 2, 3):
        assert torch.equal(kv.lane_shapecast_probe(x, salt), kv.lane_shapecast_probe_ref(x, salt))
    torch.cuda.synchronize()


def test_pallas_tier_internal_tests_pass(cuda):
    from simdutf_tpu_torch.kernels.impl import TorchPallasImplementation

    for _, check in TorchPallasImplementation("cuda").internal_tests():
        check()
    torch.cuda.synchronize()


@pytest.mark.parametrize("case,data", _inputs_swar()[:14], ids=[c for c, _ in _inputs_swar()[:14]])
def test_pallas_tier_matches_the_torch_tier(cuda, case, data):
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels.impl import TorchPallasImplementation

    tier, plain = TorchPallasImplementation("cuda"), impl.TorchImplementation("cuda")
    b = np.frombuffer(data, np.uint8)
    for method in ("validate_utf8", "validate_utf8_with_errors", "validate_ascii_with_errors"):
        assert getattr(tier, method)(b) == getattr(plain, method)(b), method
    units = np.frombuffer(data.decode("utf-8", "replace").encode("utf-16-le"), np.uint16)
    for be in (False, True):
        w = units.byteswap() if be else units
        assert tier._validate16(w, be) == plain._validate16(w, be)
    enc = np.frombuffer(pyb64.b64encode(data), np.uint8)
    full, out = tier.base64_to_binary_details(enc)
    want_full, want_out = plain.base64_to_binary_details(enc)
    assert full == want_full and np.array_equal(out, want_out)
    assert tier.safety_net == 0


# -- the single-pass look-back kernels: compose16 and b64_compact ------------

T16 = kc.TILE  # bytes per compose16 tile
T64 = kc64.TILE  # chars per b64_compact tile
_MIX = ("ab é 東 \U0001f642 Жм ".encode() * 40_000)


def _mixed(size: int) -> bytes:
    """Mixed text cut to ``size`` bytes at a character start."""
    d = (_MIX * (size // len(_MIX) + 1))[:size].decode("utf-8", "ignore").encode()
    return d + b"a" * (size - len(d))


def _compose16_cases(T: int = T16):
    """(case, bytes): errors, invalid bytes and 4-byte sequences across
    the edges of tiles of ``T`` bytes and at a tile's first and last three
    bytes; cut sequences at the length; many tiles."""
    base = _mixed(4 * T + 999)
    out = [("len1", b"a"), ("len1-lead4", b"\xf0"), ("mixed", base)]
    edges = (0, 1, 2, T - 3, T - 2, T - 1, T, T + 1, T + 2, 2 * T - 1, 3 * T + 2)
    for pos in edges:
        for bad in (b"\xff", b"\x80", b"\xc0\xaf", b"\xe0\x80\x80", b"\xed\xa0\x80",
                    b"\xf4\x90\x80\x80", b"\xf0\x9f"):
            d = bytearray(base)
            d[pos:pos + len(bad)] = bad
            out.append((f"{bad.hex()}@{pos}", bytes(d)))
        d = bytearray(b"a" * len(base))
        d[pos:pos + 4] = "\U0001f642".encode()  # a valid 4-byte sequence
        out.append((f"astral@{pos}", bytes(d)))
    out.append(("orphan-after-f8@edge", b"a" * (T - 2) + b"\xf8\x80\x80" + b"a" * 50))
    out.append(("lead4@len-1", base[:T - 1] + b"\xf0"))
    return out


@pytest.mark.parametrize("case,data", _compose16_cases(), ids=[c for c, _ in _compose16_cases()])
def test_compose16_tile_edges_match_plain_version(cuda, case, data):
    L = len(data)
    n = L + 7  # garbage past the length
    buf = np.random.default_rng(L).integers(0, 256, n).astype(np.uint8)
    buf[:L] = np.frombuffer(data, np.uint8)
    x = torch.from_numpy(buf).to(cuda)
    for length in (L, n, 0) if case == "mixed" else (L,):
        for be in (False, True):
            for clamp in (True, False):
                assert _same(kc.to_utf16_compose(x, length, be, clamp),
                             kc.to_utf16_compose_ref(x, length, be, clamp)), (length, be, clamp)
    torch.cuda.synchronize()


def test_compose16_many_tiles_and_zero_tail(cuda):
    """Far more tiles than resident blocks (look-back depth, out-of-order
    starts); each call right after freeing a same-sized 0xFF buffer, so a
    zero the kernel failed to write shows."""
    L = 24 * 2**20
    data = bytearray(_mixed(L))
    bad = bytearray(data)
    bad[L - 5000] = 0xFF
    for d in (data, bad):
        x = torch.from_numpy(np.frombuffer(bytes(d) + b"\0" * 4096, np.uint8).copy()).to(cuda)
        for be, clamp in ((False, True), (True, False)):
            junk = torch.full((x.numel(),), -1, dtype=torch.int16, device=cuda)
            del junk
            got = kc.to_utf16_compose(x, L, be, clamp)
            assert _same(got, kc.to_utf16_compose_ref(x, L, be, clamp))
    torch.cuda.synchronize()


def _seq_tiles(seqs: list, off, T: int = T16) -> np.ndarray:
    """One tile of ``T`` bytes of 'a' per sequence, the sequence at byte
    ``off`` of it ("end": ending at the tile's last byte)."""
    buf = np.full((len(seqs), T), ord("a"), np.uint8)
    for i, s in enumerate(seqs):
        o = T - len(s) if off == "end" else off
        buf[i, o:o + len(s)] = np.frombuffer(s, np.uint8)
    return buf.reshape(-1)


def _fast_check_sequences():
    """Every 1- and 2-byte sequence; 3-byte sequences of every first
    byte with the class-boundary values after it; seeded 4-byte sequences
    over every lead F0-FF."""
    edge = [0x00, 0x41, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xC1,
            0xC2, 0xDF, 0xE0, 0xED, 0xEF, 0xF0, 0xF4, 0xF5, 0xF8, 0xFF]
    seqs = [bytes([a]) for a in range(256)]
    seqs += [bytes([a, b]) for a in range(256) for b in range(256)]
    seqs += [bytes([a, b, c]) for a in range(256) for b in edge for c in edge]
    rng = np.random.default_rng(4)
    for lead in range(0xF0, 0x100):
        for _ in range(300):
            seqs.append(bytes([lead]) + bytes(rng.choice(edge, 3).astype(np.uint8)))
    return seqs


@pytest.mark.parametrize("off", [0, T16 // 2 - 1, "end"])
def test_compose16_fast_check_misses_no_event(cuda, off):
    """Each tile's published key (the fast check passes a tile with no
    event) against the plain lattice's per-tile minimum."""
    seqs = _fast_check_sequences()
    per_call = 2048
    for i in range(0, len(seqs), per_call):
        buf = _seq_tiles(seqs[i:i + per_call], off)
        x = torch.from_numpy(buf).to(cuda)
        L = x.numel()
        got = kc._tile_aggregates(x, L)
        want = kc.tile_aggregates_ref(x, L)
        assert torch.equal(got[1].cpu(), want[1].cpu()), i
        assert _same(got, want), i
    torch.cuda.synchronize()


def _b64_cases():
    """(case, chars, length, buffer size): invalid chars across the new
    tile edges, whitespace runs longer than a look-back window (32 tiles),
    tail_start far before the last tile, length 1 and N."""
    raw = pyb64.b64encode(np.random.default_rng(5).bytes(3 * T64))
    mime = b"\r\n".join(raw[i: i + 76] for i in range(0, len(raw), 76))
    out = [("zero", b"", 0, 4), ("one", b"Q", 1, 4),
           ("len==N", mime[:2 * T64 + 4], 2 * T64 + 4, 2 * T64 + 4)]
    for pos in (0, 1, 2, T64 - 3, T64 - 2, T64 - 1, T64, T64 + 1, T64 + 2, 2 * T64 - 1):
        d = bytearray(mime)
        d[pos] = ord("*")
        out.append((f"bad@{pos}", bytes(d), len(d), len(d) + 13))
    ws = b" " * (40 * T64)
    for k in (1, 2, 3):  # nvalid % 4 == k, then whitespace for 40 tiles
        d = mime[:T64 + 100] + b"QUJD"[:k] + ws
        out.append((f"tail{k}-far-back", d, len(d), len(d) + 3))
    d = ws + b"TWFu" + ws + b"QU"
    out.append(("ws-runs", d, len(d), len(d) + 2))
    out.append(("all-ws", ws, len(ws), len(ws)))
    return out


@pytest.mark.parametrize("case,data,L,n", _b64_cases(), ids=[c[0] for c in _b64_cases()])
@pytest.mark.parametrize("url,both", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("wide", [False, True])
def test_b64_compact_tile_edges_match_plain_version(cuda, case, data, L, n, url, both, wide):
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    if wide:
        b16 = buf.astype(np.uint16)
        b16[len(data):] |= 0x100  # garbage past the length above 0xFF too
        x = torch.from_numpy(b16.view(np.int16)).to(cuda).view(torch.uint16)
    else:
        x = torch.from_numpy(buf).to(cuda)
    junk = torch.full((n,), 0xFF, dtype=torch.uint8, device=cuda)
    del junk
    assert _same(kc64.compact_codes(x, L, url, both), kc64.compact_codes_ref(x, L, url, both))
    torch.cuda.synchronize()


def test_b64_compact_many_tiles_and_zero_tail(cuda):
    """The MIME base64 of 12 MiB (far more tiles than resident blocks),
    uint8 and char16, each call after freeing a same-sized 0xFF buffer."""
    raw = pyb64.b64encode(np.random.default_rng(6).bytes(12 * 2**20))
    mime = b"\r\n".join(raw[i: i + 76] for i in range(0, len(raw), 76)) + b"QQ"
    L = len(mime)
    buf = np.zeros(-(-(L + 100) // 4) * 4, np.uint8)
    buf[:L] = np.frombuffer(mime, np.uint8)
    for x in (torch.from_numpy(buf).to(cuda),
              torch.from_numpy(buf.astype(np.uint16).view(np.int16)).to(cuda).view(torch.uint16)):
        junk = torch.full((x.numel(),), 0xFF, dtype=torch.uint8, device=cuda)
        del junk
        got = kc64.compact_codes(x, L, False, False)
        assert _same(got, kc64.compact_codes_ref(x, L, False, False))
        assert int(got[4]) < L  # nvalid is not a multiple of 4
    torch.cuda.synchronize()


def test_single_pass_wrappers_launch_once(cuda):
    """compose16, compose32, compose8 and b64_compact: one kernel of their
    own a call (the status reset is a memset inside the entry point, no
    torch fill), one launch by the port's own counter."""
    from simdutf_tpu_torch import trace

    data = _mixed(5 * T16)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    chars = torch.from_numpy(np.frombuffer(pyb64.b64encode(data), np.uint8).copy()).to(cuda)
    w16 = torch.from_numpy(np.frombuffer(data.decode().encode("utf-16-le"), np.int16).copy()
                           ).to(cuda).view(torch.uint16)
    calls = (lambda: kc.to_utf16_compose(x, x.numel(), False),
             lambda: kc32.to_utf32_compose(x, x.numel()),
             lambda: kc8.to_utf8_compose(w16, w16.numel(), False),
             lambda: kc8.to_utf8_compose(w16, w16.numel(), True, mode="valid"),
             lambda: kc64.compact_codes(chars, chars.numel(), False, False))
    for call in calls:
        call()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    for call in calls:
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "emset" not in e.key and "emcpy" not in e.key]
        assert sum(trace.snapshot()["launches"].values()) == 1
        assert len(kernels) <= 1, kernels  # the profiler may miss it, never add one


# -- the port's spans and counters on the card ---------------------------------

def _cell_entries(dev):
    """The benchmark cells' entries on 1 MiB inputs staged as the port
    stages them: (name, call, launches by C entry point, syncs)."""
    from simdutf_tpu_torch import impl

    def staged(data: bytes, dtype=np.uint8):
        buf, n = impl._pad(np.frombuffer(data, dtype))
        return impl.to_device(buf.copy(), n, dev)

    mib = 1 << 20
    x, n = staged(_mixed(mib))
    u, nu = staged(_mixed(mib).decode().encode("utf-16-le"), np.uint16)
    a, na = staged(b"plain ASCII text, " * (mib // 18))
    raw = np.random.default_rng(3).integers(0, 256, 3 * mib // 4, dtype=np.uint8).tobytes()
    enc = pyb64.b64encode(raw)
    mime = b"\r\n".join(enc[i:i + 76] for i in range(0, len(enc), 76))
    c, nc = staged(mime)
    return [("mixed", lambda: o8.to_utf16(x, n, False),
             {"census_utf8": 1, "compose16": 1}, 1),
            ("ascii", lambda: o8.to_utf16(a, na, False),
             {"census_utf8": 1, "ascii_widen_utf16": 1}, 1),
            ("decode", lambda: ob.decode_bulk_routed(c, nc, False, False),
             {"b64_compact8": 1, "b64_pack": 1}, 0),
            ("utf16", lambda: o16.to_utf8(u, nu, False),
             {"census_utf16": 1, "compose8": 1}, 1)]


def _profiled(call, activities):
    from torch.profiler import profile

    from simdutf_tpu_torch import trace

    trace.reset()
    with profile(activities=activities) as prof:
        call()
        torch.cuda.synchronize()
    return prof, trace.snapshot()


def test_cell_entries_launch_and_sync_counts(cuda):
    """Each benchmark cell's entry launches its two kernels and blocks the
    host as many times as its route reads the device."""
    from torch.profiler import ProfilerActivity

    for name, call, launches, syncs in _cell_entries(cuda):
        call()
        _, snap = _profiled(call, [ProfilerActivity.CPU])
        assert snap["launches"] == launches, name
        assert snap["syncs"] == syncs, name


#: device rows (kernels, copies, memsets) of each cell entry's call: the
#: census's zeroed bits, kernel and read (3); compose16 or compose8's
#: cleared counter and kernel (2), then ops/common.routed's clamp of
#: err_pos and where of out_len (2); or ascii_widen_utf16's zeroed flag
#: and kernel (2) and the fast branch's three scalar fills (3)
_CELL_OPS = {"mixed": 7, "ascii": 8, "decode": 12, "utf16": 7}


def test_cell_entries_device_op_counts(cuda):
    """Each benchmark cell's entry makes as many device operations as its
    route and kernels account for; the benchmark's ``ops_per_call`` adds
    the harness's own result read to these."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    api_call = re.compile(r"^cu(da)?[A-Z]")  # runtime calls filed as device rows
    got = {}
    for name, call, _, _ in _cell_entries(cuda):
        call()
        prof, _ = _profiled(call, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        got[name] = sum(1 for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA
                        and not api_call.match(e.name()))
    assert got == _CELL_OPS


def test_utf16_cell_entry_counts_its_fill_and_glue(cuda):
    """The UTF-16 -> UTF-8 cell's entry zero-fills nothing (compose8
    writes the zeros past out_len itself) and opens no tile glue span:
    one launch of compose8 inside its wrapper's span."""
    from torch.profiler import ProfilerActivity

    name, call, _, _ = _cell_entries(cuda)[3]
    assert name == "utf16"
    call()
    _, snap = _profiled(call, [ProfilerActivity.CPU])
    assert snap["counts"] == {}
    assert "simdutf.passglue.tile_glue" not in snap["spans"]
    assert snap["spans"]["simdutf.kernel.compose8.to_utf8_compose"]["count"] == 1


def test_sync_counter_misses_no_sync(cuda):
    """The port's ``syncs`` equals the synchronizing operations torch
    reports for the same call under ``set_sync_debug_mode``."""
    import warnings

    from torch.profiler import ProfilerActivity

    for name, call, _, _ in _cell_entries(cuda):
        call()
        torch.cuda.synchronize()
        caught = []

        def watched():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as got:
                    warnings.simplefilter("always")
                    call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            caught.extend(w for w in got if "synchroniz" in str(w.message))

        _, snap = _profiled(watched, [ProfilerActivity.CPU])
        assert snap["syncs"] == len(caught), (name, [str(w.message) for w in caught])


def test_program_spans_make_no_device_rows(cuda):
    """The program's spans are host ranges only: the trace has them, and no
    device row carries their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for name, call, _, _ in _cell_entries(cuda):
        call()
        prof, snap = _profiled(call, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        events = list(prof.profiler.kineto_results.events())
        host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
        device = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
        assert set(snap["spans"]) <= host, name
        assert device and not [d for d in device if d.startswith("simdutf.")], name


# -- compose32 (#36-#37) as one look-back launch -----------------------------

T32 = kc32.TILE  # bytes per compose32 tile


@pytest.mark.parametrize("case,data", _compose16_cases(T32),
                         ids=[c for c, _ in _compose16_cases(T32)])
def test_compose32_tile_edges_match_plain_version(cuda, case, data):
    """Errors, invalid bytes and 4-byte sequences at compose32's tile
    edges, cut sequences at the length, garbage past it; and views off the
    16-byte grid (the window takes byte loads, the words' stores stay
    aligned)."""
    L = len(data)
    n = L + 7  # garbage past the length
    buf = np.random.default_rng(L).integers(0, 256, n).astype(np.uint8)
    buf[:L] = np.frombuffer(data, np.uint8)
    x = torch.from_numpy(buf).to(cuda)
    for length in (L, n, 0) if case == "mixed" else (L,):
        assert _same(kc32.to_utf32_compose(x, length), kc32.to_utf32_compose_ref(x, length))
    for off in (1, 3, 8) if L > 8 else ():
        v = x[off:]
        assert _same(kc32.to_utf32_compose(v, L - off), kc32.to_utf32_compose_ref(v, L - off)), off
    torch.cuda.synchronize()


def test_compose32_many_tiles_and_zero_tail(cuda):
    """Far more tiles than resident blocks (look-back depth, out-of-order
    starts), valid and with an error near the end; each call right after
    freeing a same-sized 0xFF buffer, so a zero the kernel failed to write
    shows; and the 0-length call."""
    L = 24 * 2**20
    data = bytearray(_mixed(L))
    bad = bytearray(data)
    bad[L - 5000] = 0xFF
    for d in (data, bad):
        x = torch.from_numpy(np.frombuffer(bytes(d) + b"\0" * 4096, np.uint8).copy()).to(cuda)
        for length in (L, L - 1):
            junk = torch.full((x.numel(),), -1, dtype=torch.int32, device=cuda)
            del junk
            got = kc32.to_utf32_compose(x, length)
            assert _same(got, kc32.to_utf32_compose_ref(x, length)), length
    assert _same(kc32.to_utf32_compose(x, 0), kc32.to_utf32_compose_ref(x, 0))
    torch.cuda.synchronize()


@pytest.mark.parametrize("off", [0, T32 // 2 - 1, "end"])
def test_compose32_fast_check_misses_no_event(cuda, off):
    """Each compose32 tile's published key (the fast check passes a tile
    with no event) and triple against the plain lattice's."""
    seqs = _fast_check_sequences()
    per_call = 1024
    for i in range(0, len(seqs), per_call):
        x = torch.from_numpy(_seq_tiles(seqs[i:i + per_call], off, T32)).to(cuda)
        L = x.numel()
        got = kc32._tile_aggregates(x, L)
        want = kc32.tile_aggregates_ref(x, L)
        assert torch.equal(got[1].cpu(), want[1].cpu()), i
        assert _same(got, want), i
    torch.cuda.synchronize()


_C32_TEXT = "ab é 東 Жм ".encode() * 4000  # no 4-byte sequence, as the utf32 cell's text
_C32_ASTRAL = "ab é \U0001f642 東 ".encode() * 4000


def _c32_text(size: int, astral: bool = False) -> bytes:
    """Text (with 4-byte sequences when ``astral``) cut to ``size`` bytes
    at a character start, filled up with 'a'."""
    src = _C32_ASTRAL if astral else _C32_TEXT
    d = (src * (size // len(src) + 1))[:size].decode("utf-8", "ignore").encode()
    return d + b"a" * (size - len(d))


def _c32_at(size: int, pos: int, seq: bytes, astral: bool = False) -> bytes:
    """Valid text of ``size`` bytes with ``seq`` at byte ``pos``."""
    return _c32_text(pos, astral) + seq + _c32_text(size - pos - len(seq), astral)


def _compose32_pipeline_cases():
    """name -> [(bytes, length, n), ...] at compose32's tile size: the
    bytes fill the start of an n-byte buffer whose rest is seeded garbage."""
    K, W = T32, T32 // kc32.WARPS  # bytes a tile, a warp
    size = 6 * K + 777
    base, astral = _c32_text(size), _c32_text(size, True)
    lead4 = "\U0001f642".encode()

    def put(data: bytes, pos: int, seq: bytes) -> bytes:
        return data[:pos] + seq + data[pos + len(seq):]

    cases = {
        # an error in tile t + 1 while tile t's prefix is pending, and in
        # the first and the last tile; an error cut short at the length
        "err_next_tile": [(put(base, K + p, b"\xff"), size, size + 64)
                          for p in (0, 1, K // 2, K - 1)],
        "err_first_tile": [(put(base, p, s), size, size + 7)
                           for p, s in ((0, b"\x80"), (9, b"\xed\xa0\x80"), (K - 2, b"\xc0\xaf"))],
        "err_last_tile": [(put(base, size - p, s), size, size + 5)
                          for p, s in ((1, b"\xe6"), (3, b"\xf0\x9f"), (300, b"\xf8"))],
        # a valid 4-byte sequence across a tile's edge, or a warp's (the
        # warp after it decodes each lead on its own), on text whose other
        # warps accumulate
        "lead4_tile_edge": [(_c32_at(size, t * K - q, lead4), size, size + 3)
                            for t in (1, 2, 5) for q in (1, 2, 3)]
                           + [(_c32_at(size, 2 * K - 1, lead4, True), size, size + 3)],
        "lead4_warp_edge": [(_c32_at(size, K + j * W - q, lead4), size, size + 3)
                            for j in (1, 3, 7) for q in (1, 2, 3, 4)],
        # a 4-byte lead at the length (its continuations past it)
        "lead4_at_length": [(base[: 2 * K + 99] + lead4, 2 * K + 100, 2 * K + 104),
                            (astral[: 3 * K - 1] + lead4, 3 * K, 3 * K + 9)],
        # 4-byte sequences throughout: the decode of each lead
        "astral": [(astral, size, size + 11)],
        # n far above the length: the zero tail spans many tiles
        "zero_tail": [(base[: 3 * K + 5], 3 * K + 5, 40 * K)],
    }
    # the ragged last tile ending in each of its 16-byte chunks
    cases["ragged_end"] = [(base[: K + 16 * c + c % 16], K + 16 * c + c % 16,
                            K + 16 * c + c % 16 + 16) for c in range(K // 16)]
    return cases


@pytest.mark.parametrize("blocks", [1, 0], ids=["one_block", "whole_grid"])
@pytest.mark.parametrize("case", ["astral", "err_first_tile", "err_last_tile", "err_next_tile",
                                  "lead4_at_length", "lead4_tile_edge", "lead4_warp_edge",
                                  "ragged_end", "zero_tail"])
def test_compose32_pipeline_matches_plain_version(cuda, case, blocks):
    """Each case's buffers through csrc/compose32.cu's tile pipeline (on
    one block, or as many as are resident) against to_utf32_compose_ref:
    the whole int32[n] buffer (zeros past the total included) and total,
    err_any, err_pos, err_code, err_len."""
    for i, (data, length, n) in enumerate(_compose32_pipeline_cases()[case]):
        buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
        buf[: len(data)] = np.frombuffer(data, np.uint8)[:n]
        x = torch.from_numpy(buf).to(cuda)
        junk = torch.full((n,), -1, dtype=torch.int32, device=cuda)
        del junk  # a zero the kernel failed to write shows
        got = kc32._on_blocks(x, length, blocks)
        assert _same(got, kc32.to_utf32_compose_ref(x, length)), (case, i, length)
    torch.cuda.synchronize()


def test_compose32_tile_paths(cuda):
    """Each tile's count of warps that took the accumulating decode, read
    from the launch's scratch, against the plain count: every warp of
    every tile on text with no 4-byte sequence (the utf32 cell's kind),
    fewer on astral text, none on a tile the fast check flags."""
    size = 40 * T32 + 123
    plain = _c32_text(size)
    bad = plain[:5 * T32 + 7] + b"\xff" + plain[5 * T32 + 8:]
    for data, kind in ((plain, "all"), (_c32_text(size, True), "fewer"), (bad, "flagged")):
        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
        got = kc32._tile_paths(x, size).cpu()
        assert torch.equal(got, kc32.tile_paths_ref(x.cpu(), size)), kind
        full = got.numel() * kc32.WARPS
        if kind == "all":
            assert int(got.sum()) == full
        elif kind == "fewer":
            assert int(got.sum()) < full // 2
        else:
            assert int(got[5]) == 0 and int(got.sum()) == full - kc32.WARPS
    torch.cuda.synchronize()


# -- compose8 (#34-#35) as one look-back launch ------------------------------

T8 = kc8.TILE  # units per compose8 tile


def _u16(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16).copy()


def _compose8_cases():
    """(case, native units): lone surrogates in the first and the last
    tile and at tile edges, pairs across tile edges, a ragged last tile, a
    high surrogate at length - 1, every width."""
    rng = np.random.default_rng(8)
    alpha = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff"]
    text = "".join(alpha[i] for i in rng.integers(0, len(alpha), 3 * T8))
    base = _u16(text)[: 3 * T8 + 37]
    if base[-1] >> 10 == 0xD800 >> 10:
        base[-1] = 0x61
    out = [("ragged", base), ("one", _u16("é")), ("one-tile", base[:T8]),
           ("hi@len-1", np.append(base[:T8 + 5], np.uint16(0xD83D)))]
    plain = np.full(3 * T8 + 37, 0x61, np.uint16)
    for pos in (0, 1, T8 - 1, T8, 2 * T8 - 1, len(plain) - 1):
        for name, v in (("hi", 0xDBFF), ("lo", 0xDC00)):
            u = plain.copy()
            u[pos] = v
            out.append((f"{name}@{pos}", u))
        if pos + 1 < len(plain):
            u = plain.copy()
            u[pos:pos + 2] = (0xD83D, 0xDE42)
            out.append((f"pair@{pos}", u))
    bad = base.copy()
    bad[len(bad) - 3] = 0xDC00  # an error in the last tile only
    if bad[len(bad) - 4] >> 10 == 0xD800 >> 10:
        bad[len(bad) - 4] = 0x61
    out.append(("err-last-tile", bad))
    return out


@pytest.mark.parametrize("case,units", _compose8_cases(), ids=[c for c, _ in _compose8_cases()])
def test_compose8_tile_edges_match_plain_version(cuda, case, units):
    """Both modes and byte orders, garbage past the length, the whole 3N
    buffer (the zero tail included); and views off the 16-byte grid."""
    L = len(units)
    for be in (False, True):
        buf = np.random.default_rng(L).integers(0, 1 << 16, L + 7).astype(np.uint16)
        buf[:L] = units
        if case == "hi@len-1":
            buf[L] = 0xDE42  # its low surrogate, stored past the length
        stored = buf.byteswap() if be else buf
        w = torch.from_numpy(stored.view(np.int16)).to(cuda).view(torch.uint16)
        for mode in ("validate", "valid"):
            assert _same(kc8.to_utf8_compose(w, L, be, mode),
                         kc8.to_utf8_compose_ref(w, L, be, mode)), (be, mode)
            for off in (1, 3) if L > 3 else ():
                v = w[off:]
                assert v.data_ptr() % 16 != 0
                assert _same(kc8.to_utf8_compose(v, L - off, be, mode),
                             kc8.to_utf8_compose_ref(v, L - off, be, mode)), (be, mode, off)
    torch.cuda.synchronize()


@pytest.mark.parametrize("be", [False, True])
def test_compose8_valid_total_past_3n(cuda, be):
    """The valid-only mode on lone highs, 4 bytes a unit: total exceeds
    3N and the writes stop at the buffer's end, across several tiles."""
    highs = np.full(2 * T8 + 5, 0xDBFF, np.uint16)
    stored = highs.byteswap() if be else highs
    w = torch.from_numpy(stored.view(np.int16)).to(cuda).view(torch.uint16)
    got = kc8.to_utf8_compose(w, w.numel(), be, mode="valid")
    assert int(got[1]) == 4 * w.numel() > got[0].numel() == 3 * w.numel()
    assert _same(got, kc8.to_utf8_compose_ref(w, w.numel(), be, mode="valid"))
    torch.cuda.synchronize()


def test_compose8_many_tiles_and_zero_tail(cuda):
    """Far more tiles than resident blocks (look-back depth, out-of-order
    starts), valid and with an error in the last tiles, both modes; each
    call right after freeing a same-sized 0xFF buffer, so a zero the
    kernel failed to write shows; and the 0-length call."""
    units = _u16(_mixed(24 * 2**20).decode())
    L = len(units) - 1
    bad = units.copy()
    bad[L - 5000] = 0xDC00
    bad[L - 5001] = 0x61
    for u in (units, bad):
        w = torch.from_numpy(np.append(u, np.zeros(4096, np.uint16)).view(np.int16)
                             ).to(cuda).view(torch.uint16)
        for be, mode in ((False, "validate"), (True, "valid"), (False, "valid")):
            junk = torch.full((3 * w.numel(),), -1, dtype=torch.int8, device=cuda)
            del junk
            got = kc8.to_utf8_compose(w, L, be, mode)
            assert _same(got, kc8.to_utf8_compose_ref(w, L, be, mode)), (be, mode)
    assert _same(kc8.to_utf8_compose(w, 0, False), kc8.to_utf8_compose_ref(w, 0, False))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["ragged", "lo@8192", "hi@16383", "err-last-tile"])
@pytest.mark.parametrize("mode", ["validate", "valid"])
def test_compose8_published_aggregates_match_plain_version(cuda, case, mode):
    """Each tile's published triple against the plain one."""
    units = dict(_compose8_cases())[case]
    w = torch.from_numpy(units.view(np.int16)).to(cuda).view(torch.uint16)
    got = kc8._tile_aggregates(w, len(units), False, mode)
    want = kc8.tile_aggregates_ref(w, len(units), False, mode)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x.cpu())
    torch.cuda.synchronize()


# -- #23 uniform3_utf16_to_utf8 on narrow3's tiles -------------------------------

N3 = ktr.N3_TILE  # units a narrow3 tile


def _u3_units(n: int, seed: int) -> np.ndarray:
    """Native 3-byte-class units (0x800-0xFFFF, no surrogate)."""
    v = np.random.default_rng(seed).integers(0x800, 0xF800, n).astype(np.uint16)
    v[v >= 0xD800] += 0x800
    return v


def _narrow3_raw(units: np.ndarray, length: int, be: bool, in_off: int, out_off: int,
                 cuda, pad: int = 32):
    """``uniform3_utf16_to_utf8``'s entry point called on raw addresses:
    the units (garbage past ``length``) stored ``in_off`` bytes into a
    fresh card buffer, the output ``out_off`` bytes into one filled with
    0xAB. Returns (the 3n output bytes, flag, the bytes around them, the
    plan, the split of narrow3_split's twin on the same addresses, the
    units as a fresh tensor on the card)."""
    from simdutf_tpu_torch.kernels import _build

    n = len(units)
    stored = (units.byteswap() if be else units).view(np.uint8)
    raw = np.random.default_rng(n + in_off).integers(0, 256, 2 * n + pad).astype(np.uint8)
    raw[in_off: in_off + 2 * n] = stored
    xb = torch.from_numpy(raw).to(cuda)
    ob = torch.full((3 * n + pad,), 0xAB, dtype=torch.uint8, device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    w_addr, o_addr = xb.data_ptr() + in_off, ob.data_ptr() + out_off
    plan = ktr.narrow3_plan(w_addr, n, o_addr)
    _build.call("uniform3_utf16_to_utf8", w_addr, n, length, int(be), o_addr, flag.data_ptr())
    torch.cuda.synchronize()
    w = torch.from_numpy(stored.view(np.int16).copy()).to(cuda).view(torch.uint16)
    around = torch.cat([ob[:out_off], ob[out_off + 3 * n:]])
    return (ob[out_off: out_off + 3 * n], flag[0], around, plan,
            ktr.narrow3_split(w_addr, n, o_addr), w)


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("n", [N3 - 1, N3, N3 + 1, 2 * N3 + 15, 3 * N3 + 17])
def test_narrow3_every_alignment_matches_plain_version(cuda, be, n):
    """Every byte offset 0-15 of input and output: the plan's split is its
    Python twin's, the 3n bytes and the flag are the plain version's, and
    nothing outside them is written. Lengths around whole tiles, the whole
    buffer and a ragged length with garbage after it; an out-of-class unit
    in the first tile's range."""
    units = _u3_units(n, n)
    for in_off in range(16):
        for out_off in range(16):
            length = n if (in_off + out_off) % 2 else n - 3
            data = units.copy()
            bad = (in_off * 16 + out_off) % 5 == 0
            if bad:
                data[(in_off * 257 + out_off) % (n - 3)] = 0xD800 if out_off % 2 else 0x7FF
            out, flag, around, plan, split, w = _narrow3_raw(data, length, be, in_off,
                                                             out_off, cuda)
            where = (in_off, out_off, length)
            assert (plan["head"], plan["ntiles"]) == split, where
            want_out, want_flag = ktr.uniform3_utf16_to_utf8_ref(w, length, be)
            assert torch.equal(out, want_out), where
            assert int(flag) == int(want_flag) == int(bad), where
            assert bool((around == 0xAB).all()), where
    torch.cuda.synchronize()


@pytest.mark.parametrize("be", [False, True])
def test_narrow3_many_tiles_and_zero_tail(cuda, be):
    """Through the wrapper on an aligned buffer of more tiles than one wave
    (the stages' barrier phases), the length mid-tile with tiles wholly
    past it, after freeing a same-sized 0xFF buffer; an out-of-class unit
    in a late tile flags."""
    n = 5 * 2**20 + 3
    units = _u3_units(n, 7)
    length = n // 2 + 5
    for L, bad in ((length, None), (length, length - 1), (n, n // 3)):
        d = units.copy()
        if bad is not None:
            d[bad] = 0x7FF
        x = torch.from_numpy((d.byteswap() if be else d).view(np.int16).copy()
                             ).to(cuda).view(torch.uint16)
        plan = ktr.narrow3_plan(x.data_ptr(), n)
        assert plan["ntiles"] == n // N3 and plan["ntiles"] > plan["grid"] * plan["stages"]
        junk = torch.full((3 * n,), -1, dtype=torch.int8, device=cuda)
        del junk
        got = ktr.uniform3_utf16_to_utf8(x, L, be)
        assert _same(got, ktr.uniform3_utf16_to_utf8_ref(x, L, be)), (L, bad)
        assert int(got[1]) == (bad is not None)
    torch.cuda.synchronize()


# -- census_utf8: the word-parallel read and its skipped checks ----------------

#: a warp's step (32 lanes x 4 chunks of 16 bytes), a block's (8 warps) and
#: the most a grid-stride step covers (528 blocks)
CEN_WARP, CEN_BLOCK = 32 * 4 * 16, 8 * 32 * 4 * 16
CEN_GRID = 528 * CEN_BLOCK
_PLAIN = "ab é 東 Жм ".encode()  # mixed text with no 4-byte sequence


def _census_same(x, L):
    """The kernel's bits equal the plain census's, counted or not; returns
    (bits, checked chunks, chunks in range)."""
    want = int(kcen.census_bits_ref(x, L))
    assert int(kcen.census_bits(x, L)) == want
    both = kcen.census_bits(x, L, counted=True)
    assert both.dtype == torch.int64 and both.dim() == 0
    bits, checked = int(both) & 0xFFFFFFFF, int(both) >> 32
    assert bits == want
    chunks = kcen.census_chunks(x, L)
    assert 0 <= checked <= chunks
    return bits, checked, chunks


def _census_lanes(chunks: int) -> int:
    """The lanes of the census's grid over ``chunks`` chunks: a warp that
    has seen V2, V3 and V4 checks no more, so ASCII and mixed text check
    at most a chunk a lane."""
    return 256 * min(-(-chunks // (CEN_BLOCK // 16)), 528)


def _on_card(data: bytes, cuda, tail: int = 64):
    """``data`` then ``tail`` bytes of garbage, on the card."""
    buf = np.random.default_rng(len(data)).integers(0, 256, len(data) + tail).astype(np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf).to(cuda)


@pytest.mark.parametrize("off", range(16))
def test_census_on_every_base_alignment(cuda, off):
    """Slices of one buffer that start 0-15 bytes past a 16-byte boundary,
    at lengths of every residue mod 16, each with stored bytes past its
    length and past its end."""
    big = _on_card(_mixed(3 * CEN_BLOCK), cuda)
    assert big.data_ptr() % 16 == 0
    for L in [0, 1, 2, 3, 15, 16, 17] + list(range(CEN_WARP - 8, CEN_WARP + 9)) + [
            2 * CEN_BLOCK + 5]:
        for n in (L, L + 1, L + 7):
            _census_same(big[off: off + n], L)
    torch.cuda.synchronize()


@pytest.mark.parametrize("L", [e + d for e in (16, 512, CEN_WARP, CEN_BLOCK, CEN_GRID)
                               for d in (-1, 0, 1)] + [5000 + r for r in range(16)])
def test_census_lengths_at_the_warp_block_and_grid_steps(cuda, L):
    for text in (_mixed(L + 32), ("東".encode() * (L // 3 + 11))):
        x = _on_card(text[: L + 5], cuda)[: L + 5]
        _census_same(x, L)
    torch.cuda.synchronize()


def _violations(ch: str):
    """(position, byte) pairs that break ``ch``'s uniform class: at each
    residue mod 2, 3 and 4 deep in the text, and the last position."""
    w = len(ch.encode())
    base = 4 * CEN_BLOCK + 12 * 7
    out = [(base + 12 * m + r, v) for m in (2, 3, 4) for r in range(m)
           for v in (0x41, 0x80, 0xC1, 0xE0, 0xED, 0xF0, 0xF4, 0xBF)]
    return out, w


@pytest.mark.parametrize("ch", ["é", "東", "\U0001f642"])
def test_census_uniform_class_with_one_violating_byte(cuda, ch):
    """Uniform 2-, 3- and 4-byte text runs its class's check on every
    chunk; one violating byte anywhere sets the class's bit, and the
    untouched text is admitted with every chunk checked."""
    violations, w = _violations(ch)
    text = bytearray(ch.encode() * ((6 * CEN_BLOCK) // w))
    L = len(text)
    x = _on_card(bytes(text), cuda)
    bits, checked, chunks = _census_same(x, L)
    cls = {2: kcen.BIT_V2, 3: kcen.BIT_V3, 4: kcen.BIT_V4}[w]
    assert bits & cls == 0 and checked == chunks
    for p, v in violations + [(L - 1, 0x41), (L - 1, 0x80), (L - 1, 0xF4)]:
        t = bytearray(text)
        t[p] = v
        x = _on_card(bytes(t), cuda)
        got, checked, chunks = _census_same(x, L)
        assert checked == chunks or got & cls
    torch.cuda.synchronize()


@pytest.mark.parametrize("lead,nexts", [(0xE0, (0x9F, 0xA0)), (0xED, (0x9F, 0xA0)),
                                        (0xF0, (0x8F, 0x90)), (0xF4, (0x8F, 0x90))])
@pytest.mark.parametrize("at_end", [True, False])
def test_census_lead_at_the_last_byte(cuda, lead, nexts, at_end):
    """An E0, ED, F0 or F4 lead at length - 1 of uniform text, its first
    continuation stored at ``length`` (read as stored) or past the
    buffer's end (read as zero, though memory holds a continuation)."""
    ch = "東" if lead < 0xF0 else "\U0001f642"
    text = ch.encode() * (CEN_BLOCK // len(ch.encode()))
    for off in (0, 1, 5):
        for nxt in nexts:
            data = text + bytes([lead, nxt, 0x80, 0x80])
            L = len(text) + 1
            big = _on_card(b"\x80" * off + data, cuda, tail=0)
            x = big[off: off + (L if at_end else L + 3)]
            bits, _, _ = _census_same(x, L)
            cls = kcen.BIT_V3 if lead < 0xF0 else kcen.BIT_V4
            if at_end:
                assert bits & cls
    torch.cuda.synchronize()


def _late(case: str, size: int) -> tuple[bytes, int]:
    """(text of at least ``size`` bytes whose only instance of a bit comes
    in its last chunks, that bit)."""
    if case == "e_acute_in_ascii":
        d = bytearray(b"plain ASCII text " * (size // 17 + 1))
        d[-1000:-998] = "é".encode()
        return bytes(d), kcen.BIT_HAS2 | kcen.BIT_NONASCII
    if case == "ascii_after_u2":
        return "é".encode() * (size // 2) + b"a", kcen.BIT_V2 | kcen.BIT_HASLO
    return _PLAIN * (size // len(_PLAIN) + 1) + "\U0001f642".encode(), kcen.BIT_HAS4


@pytest.mark.parametrize("case", ["e_acute_in_ascii", "ascii_after_u2", "plain_then_4byte"])
def test_census_finds_a_bit_after_every_warp_has_switched(cuda, case):
    """8 MiB and more whose only instance of a bit comes late, after each
    warp's first chunks: the warps that switched to the presence tests
    still find it."""
    data, bit = _late(case, 8 << 20)
    x = _on_card(data, cuda)
    bits, checked, chunks = _census_same(x, len(data))
    assert bits & bit == bit
    if case != "ascii_after_u2":
        assert checked <= _census_lanes(chunks) < chunks, (checked, chunks)
    torch.cuda.synchronize()


@pytest.mark.parametrize("ch", ["a", "mixed", "é", "東", "\U0001f642"])
def test_census_checked_chunks(cuda, ch):
    """ASCII and mixed text run the positional checks only until each warp
    holds V2, V3 and V4 (a chunk a lane: a quarter of 8 MiB, where each
    lane reads four); text of one fixed-rate class runs them on every
    chunk."""
    size = 8 << 20
    data = _mixed(size) if ch == "mixed" else ch.encode() * (size // len(ch.encode()))
    x = _on_card(data, cuda)
    _, checked, chunks = _census_same(x, len(data))
    if ch in ("a", "mixed"):
        assert 0 < checked <= _census_lanes(chunks) < chunks, (checked, chunks)
    else:
        assert checked == chunks
    torch.cuda.synchronize()


@pytest.mark.parametrize("planted", [False, True], ids=["valid", "error_near_end"])
def test_utf8_to_utf32_cell_entry_at_full_size(cuda, planted):
    """The ``utf8_to_utf32.mixed_64m`` cell's entry, ``ops.utf8.to_utf32``,
    on one full 64 MiB buffer of the cell's text, staged as the cell stages
    it: every word and the zeros past ``out_len`` against the benchmark's
    plain reference; with a 0xFF planted at a character start near the end,
    the scalars and the words before it."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench_torch import harness
    from bench_torch.configs import utf8_to_utf32_ref as ref
    from simdutf_tpu_torch import impl

    gen = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
    data = gen.generate(harness.load_cell("utf8_to_utf32.mixed_64m").traffic, 2**31 + 22,
                        cuda)[0]
    if planted:
        k = len(data) - 4099
        while data[k] & 0xC0 == 0x80:
            k -= 1
        data[k] = 0xFF
    buf, n = impl._pad(data)
    x, n = impl.to_device(buf, n, cuda)
    code, pos, out, out_len = o8.to_utf32(x, n)
    got = tuple(torch.stack([code, pos, out_len]).tolist())
    want_code, want_pos, words = ref.convert(data.tobytes())
    assert got == (want_code, want_pos, len(words))
    assert (want_code != 0) == planted and out.shape == (x.shape[0],)
    w = out.cpu().numpy().view(np.uint32)
    assert np.array_equal(w[: len(words)], words)
    if not planted:
        assert not w[len(words):].any()
    torch.cuda.synchronize()


def _bench_modules():
    """``bench_torch``'s harness, importable from the checkout's root."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench_torch import harness

    return harness


@pytest.mark.parametrize("planted", [False, True], ids=["valid", "error_near_end"])
def test_validate_utf8_cell_entry_at_full_size(cuda, planted):
    """The ``validate_utf8.mixed_64m`` cell's entry,
    ``ops.utf8.validate_with_errors``, on one full 64 MiB buffer of the
    cell's text, staged as the cell stages it, against the benchmark's
    plain reference; with a 0xFF planted at a character start near the
    end, its code and position."""
    harness = _bench_modules()
    from bench_torch.configs import validate_utf8_ref as ref
    from simdutf_tpu_torch import impl

    gen = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
    data = gen.generate(harness.load_cell("validate_utf8.mixed_64m").traffic, 2**31 + 24,
                        cuda)[0]
    if planted:
        k = len(data) - 4099
        while data[k] & 0xC0 == 0x80:
            k -= 1
        data[k] = 0xFF
    buf, n = impl._pad(data)
    x, n = impl.to_device(buf, n, cuda)
    got = tuple(impl._scalars(*o8.validate_with_errors(x, n)))
    want = ref.validate(data.tobytes())
    assert got == want and (want[0] != 0) == planted
    torch.cuda.synchronize()


def _first_event_text(name: str) -> bytes:
    rng = np.random.default_rng(24)
    mixed = "".join(rng.choice(list("abc  éЖ東🙂"), 300_000)).encode()
    if name == "error":
        err = bytearray(mixed)
        err[len(err) // 2] = 0xFF
        return bytes(err)
    return {"mixed": mixed, "ascii": b"plain ascii text " * 20_000, "empty": b""}[name]


@pytest.mark.parametrize("name", ["mixed", "ascii", "error", "empty"])
def test_first_event_counts_exact_chunks_on_device(cuda, monkeypatch, name):
    """Under a profiler the first-event kernel adds the chunks that ran its
    lattice, those its screen flagged, to the trace's device counter: none
    on valid text, as the plain path counts; with an error at least one
    and at most the plain path's count, since each warp stops at its first
    flagged chunks. Its results are those of an untraced call, which
    launches with no counter; and a traced call makes the torch operations
    and allocations of an untraced one, but for the counter's zeros that a
    recording's first call makes."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from simdutf_tpu_torch import trace
    from simdutf_tpu_torch.kernels import _build

    class Ops(TorchDispatchMode):
        """The torch operations a call makes, views left out."""

        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.names.append(func.name())
            return func(*args, **(kwargs or {}))

    data = _first_event_text(name)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    L = len(data)
    want = [t.item() for t in kv.utf8_first_event_len_ref(x.cpu(), L)]
    exact = kv.exact_chunks_ref(x.cpu(), L)
    assert (exact > 0) == (name == "error")
    counters = []  # each launch's counter argument
    call = _build.call
    monkeypatch.setattr(_build, "call", lambda name, *a: counters.append(a[-1]) or call(name, *a))

    def allocated():
        return torch.cuda.memory_stats()["allocation.all.allocated"]

    def ops_allocs_results():
        before = allocated()
        with Ops() as ops:
            got = kv.utf8_first_event_len(x, L)
        return ops.names, allocated() - before, [t.item() for t in got]

    untraced = ops_allocs_results()
    assert untraced[2] == want and untraced[0]
    for calls in (1, 3):
        trace.span("simdutf.x")  # a call with no profiler: the next record begins anew
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            names, allocs, got = ops_allocs_results()
            assert sorted(names) == sorted(untraced[0] + ["aten::zeros"])
            assert (allocs, got) == (untraced[1] + 1, untraced[2])
            for _ in range(calls - 1):
                assert ops_allocs_results() == untraced
        counts = trace.snapshot()["counts"]
        assert counts[kv.CHUNKS] == calls * ((L + 15) // 16)
        if name == "error":
            assert calls <= counts[kv.EXACT_CHUNKS] <= calls * exact
        else:
            assert counts[kv.EXACT_CHUNKS] == 0
    assert counters[0] is None and None not in counters[1:] and len(counters) == 5


# -- the first-event kernel: errors planted where its reads and stops turn ----

FE_CHUNKS = 32 * 4  # 16-byte chunks a warp of first_event_kernel reads a step
FE_STEP = 16 * FE_CHUNKS
FE_GRID = 132 * 4 * 8 * FE_STEP  # bytes the whole grid reads a step
FE_BAD = {  # a bad sequence of each error code
    "header_bits": b"\xff",
    "too_short": b"\xe6\x9d\x41",
    "too_long": b"\x41\x80",
    "overlong": b"\xe0\x80\x80",
    "too_large": b"\xf4\x90\x80\x80",
    "surrogate": b"\xed\xa0\x80",
}


def _fe_base(n: int, dev) -> torch.Tensor:
    """``n`` bytes of valid text, 1- to 4-byte characters in a 43-byte
    unit, so a character starts at every place of a chunk somewhere."""
    unit = ("aé東🙂Ж " * 3 + "xyzq").encode()
    reps = -(-n // len(unit))
    return torch.from_numpy(np.frombuffer(unit * reps, np.uint8)[:n].copy()).to(dev)


def _fe_check(x: torch.Tensor, L: int):
    """The kernel's (pos, code) against the plain version's, both on the
    card."""
    got = [t.item() for t in kv.utf8_first_event_len(x, L)]
    want = [t.item() for t in kv.utf8_first_event_len_ref(x, L)]
    assert got == want, (L, got, want)
    return got


def _fe_plant(x: torch.Tensor, at: int, bad: bytes, clean: bool = False) -> torch.Tensor:
    """``x`` with ``bad`` written at ``at``; with ``clean``, the characters
    within four bytes of it first replaced by ASCII, so that nothing but
    ``bad`` is wrong there."""
    y = x.clone()
    if clean:
        lo, hi = max(at - 4, 0), min(at + len(bad) + 4, y.shape[0])
        while lo > 0 and int(y[lo]) & 0xC0 == 0x80:
            lo -= 1
        while hi < y.shape[0] and int(y[hi]) & 0xC0 == 0x80:
            hi += 1
        y[lo:hi] = 0x61
    y[at:at + len(bad)] = torch.tensor(list(bad), dtype=torch.uint8, device=x.device)
    return y


@pytest.mark.parametrize("edge", ["chunk", "step", "grid_step"])
@pytest.mark.parametrize("code", list(FE_BAD))
def test_first_event_planted_at_every_offset_around_an_edge(cuda, code, edge):
    """Each error code planted at every offset of 48 around a 16-byte
    chunk's start, a warp step's start (32 x 4 chunks) and the start of
    a warp's second grid-stride step, over mixed text: the kernel's
    (pos, code) is the plain version's."""
    at = {"chunk": 16 * 37, "step": 3 * FE_STEP, "grid_step": FE_GRID + FE_STEP}[edge]
    base = _fe_base(at + 3 * FE_STEP, cuda)
    found = set()
    for d in range(-24, 24):
        for clean in (False, True):
            x = _fe_plant(base, at + d, FE_BAD[code], clean)
            found.add(tuple(_fe_check(x, base.shape[0])))
    assert len(found) > 24
    torch.cuda.synchronize()


@pytest.mark.parametrize("edge", [16 * 37, 3 * FE_STEP, FE_GRID])
def test_first_event_sequences_cut_at_the_length(cuda, edge):
    """A 2-, 3- and 4-byte character cut 1-3 bytes in by a length at a
    chunk, step or grid step's edge, its other bytes stored past the
    length: TOO_SHORT at its lead, as the plain version reads it."""
    base = _fe_base(edge + 64, cuda)
    for ch in ("é", "東", "🙂"):
        enc = ch.encode()
        for cut in range(1, len(enc)):
            x = _fe_plant(base, edge - cut, enc, clean=True)
            assert _fe_check(x, edge) == [edge - cut, 2]
            assert _fe_check(x, edge - cut + len(enc))[0] == kv.BIG
    torch.cuda.synchronize()


@pytest.mark.parametrize("off", range(1, 16))
def test_first_event_on_every_unaligned_base(cuda, off):
    """A buffer whose base is ``off`` bytes past a 16-byte boundary: no
    error, an error in the first chunk, in the middle and in the last
    chunk, and a character cut at the length."""
    n = 5 * FE_STEP + 37
    buf = _fe_base(n + off, cuda)
    cases = [buf, _fe_plant(buf, off + 3, b"\xff"), _fe_plant(buf, off, b"\x80"),
             _fe_plant(buf, off + n // 2, b"\xed\xa0\x80"),
             _fe_plant(buf, off + n - 2, b"\xf0\x9f")]
    for y in cases:
        x = y[off:off + n]
        assert x.data_ptr() % 16 == off
        _fe_check(x, n)
        _fe_check(x, n - 5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("where", ["first_chunk", "last_chunk"])
def test_first_event_in_the_first_and_last_chunk(cuda, where):
    """Every error code at each byte of the buffer's first or last chunk."""
    n = 4 * FE_STEP + 16
    base = _fe_base(n, cuda)
    lo = 0 if where == "first_chunk" else n - 16
    for bad in FE_BAD.values():
        for at in range(lo, lo + 16):
            _fe_check(_fe_plant(base, at, bad[: n - at]), n)
    torch.cuda.synchronize()


@pytest.mark.parametrize("steps", [1, 2])
def test_first_event_two_errors_the_later_in_an_earlier_finishing_warp(cuda, steps):
    """The first error in the last chunks of one warp's step, which it
    reaches last, and a later error in the first chunk of the next warp's
    step, which that warp reaches first and stops at; with ``steps`` 2
    both in the warps' second grid-stride step. The kernel reports the
    first."""
    start = (steps - 1) * FE_GRID
    base = _fe_base(start + 8 * FE_STEP, cuda)
    first = start + FE_STEP - 16 + 9  # the last chunk of warp 0's step
    x = _fe_plant(base, first, b"\xff", clean=True)
    x = _fe_plant(x, start + FE_STEP + 2, b"\xc0\xaf", clean=True)
    for extra in range(2, 8):  # and later errors in every later warp
        x = _fe_plant(x, start + extra * FE_STEP, b"\x80")
    assert _fe_check(x, x.shape[0]) == [first, 1]
    torch.cuda.synchronize()


@pytest.mark.parametrize("what", ["random", "early", "valid_then_random"])
def test_first_event_stops_early_on_error_dense_input(cuda, what):
    """Input with errors everywhere (uniform random bytes), an error near
    the start of 20 MiB and errors after it in every step, and random
    bytes after 12 MiB of valid text: the first error, as the plain
    version finds it."""
    n = 20 << 20
    g = torch.Generator(device=cuda).manual_seed(25)
    rnd = torch.randint(0, 256, (n,), generator=g, device=cuda, dtype=torch.int32)
    rnd = rnd.to(torch.uint8)
    if what == "random":
        x = rnd
    elif what == "early":
        x = _fe_base(n, cuda)
        x[FE_STEP + 5] = 0xFF
        x[FE_STEP * 7::FE_STEP] = 0x80
    else:
        x = _fe_base(n, cuda)
        x[12 << 20:] = rnd[12 << 20:]
    _fe_check(x, n)
    _fe_check(x, n - 3)
    torch.cuda.synchronize()
