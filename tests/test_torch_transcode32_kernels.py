"""simdutf_tpu_torch.kernels.transcode32 against the Pallas UTF-32
fixed-rate kernels, and the routes that take them against the JAX ``xla``
tier's ops.

Each plain version (the wrapper on a CPU tensor) gets the Pallas
function's own padded buffer (``simdutf_tpu.kernels.impl._pad_widen``,
``_pad_u2``, ``_pad_u3``, ``_pad_narrow``, ``_pad_u32k``, ``_pad_word32``:
zeros past the length) and the length; the Pallas function runs in
interpret mode, as tests/test_transcode_kernels.py runs it: the
``_pallas`` forms, both butterfly forms of the BMP widen and narrow
(``_bmp_widen_bf``, ``_bmp_narrow_bf``) and ``astral_wordmap``'s four
UTF-32 variants. Classes of 1 element, one Pallas tile and a ragged
multi-tile length, LE and BE where the kernel has a byte order, and
out-of-class elements at 0, at the tile edge and at length-1 (words >=
2^31, 0x110000 and surrogates on the UTF-32 side), a character cut at the
length: the flag must be equal on every input (``_l1_32_pallas`` has none;
the port's is held to its definition), and the output equal over the class
output where the flag is clear (on flagged input the Pallas output is
meaningless). Then ``ops.utf8.to_utf32`` / ``_valid``, ``ops.utf32.to_utf8``
/ ``_valid``, ``ops.utf32.to_utf16`` / ``_valid``, ``ops.utf16.to_utf32`` /
``_valid`` and ``ops.latin1.to_utf32`` on class inputs with garbage past the
length, against the JAX ops on the same buffer: full output buffers, bit
for bit, and a spy on the wrappers shows each class took its kernel with a
clear flag. Integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import transcode as jtr
from simdutf_tpu.kernels.impl import (_pad_narrow, _pad_u2, _pad_u3, _pad_u32k, _pad_widen,
                                      _pad_word32)
from simdutf_tpu.ops import latin1 as jol1
from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu.ops import utf32 as jo32
from simdutf_tpu_torch.kernels import transcode32 as t32
from simdutf_tpu_torch.ops import latin1 as tol1
from simdutf_tpu_torch.ops import utf8 as to8
from simdutf_tpu_torch.ops import utf16 as to16
from simdutf_tpu_torch.ops import utf32 as to32

TOP = (0x80000000, 0xFFFFFFFF)  # words >= 2^31: negative as int32

# name -> (Pallas calls (x, n, be) -> (out, flag or None), their padding,
# kind, class char, elements per Pallas tile, out-of-class values). Kinds:
# "from8" takes UTF-8 bytes, "from16" UTF-16 units, "to8" and "to16" words.
SPECS = {
    "latin1_widen_utf32": (
        [lambda x, n, be: (jtr._l1_32_pallas(x), None)],
        _pad_widen, "from8", "a", 32768, (0x80, 0xFF)),
    "uniform2_utf8_to_utf32": (
        [lambda x, n, be: jtr._u2_32_pallas(x, n)],
        _pad_u2, "from8", "é", 65536, (0x41, 0xC1, 0xE9)),
    "uniform3_utf8_to_utf32": (
        [lambda x, n, be: jtr._u3_32_pallas(x, n)],
        _pad_u3, "from8", "東", 98304, (0x41, 0xC3, 0xF0)),
    "astral_utf8_to_utf32": (
        [lambda x, n, be: jtr.astral_wordmap(x, n, "u8_to_u32")],
        _pad_u2, "from8", "\U0001f642", 65536, (0x41, 0xC3, 0xF8)),
    "uniform2_utf32_to_utf8": (
        [lambda x, n, be: jtr._rev2_32_pallas(x, n)],
        _pad_u32k, "to8", "é", 32768, (0x7F, 0x800) + TOP),
    "uniform3_utf32_to_utf8": (
        [lambda x, n, be: jtr._rev3_32_pallas(x, n)],
        _pad_u32k, "to8", "東", 32768, (0x7FF, 0xD800, 0xDFFF, 0x10000) + TOP),
    "astral_utf32_to_utf8": (
        [lambda x, n, be: jtr.astral_wordmap(x, n, "u32_to_u8")],
        _pad_word32, "to8", "\U0001f642", 16384, (0xFFFF, 0x110000) + TOP),
    "bmp_widen_utf32": (
        [lambda x, n, be: jtr._bmp_widen_pallas(x, be),
         lambda x, n, be: jtr._bmp_widen_bf(x, be)],
        _pad_narrow, "from16", "東", 32768, (0xD800, 0xDBFF, 0xDC00, 0xDFFF)),
    "astral_utf16_to_utf32": (
        [lambda x, n, be: jtr.astral_wordmap(x, n, "u16pair_to_u32", big_endian=be)],
        _pad_narrow, "from16", "\U0001f642", 32768, (0x41, 0xE000)),
    "bmp_narrow_utf16": (
        [lambda x, n, be: jtr._bmp_narrow_pallas(x, be),
         lambda x, n, be: jtr._bmp_narrow_bf(x, be)],
        _pad_u32k, "to16", "東", 32768, (0x10000, 0xD800, 0xDFFF, 0x110000) + TOP),
    "astral_utf32_to_utf16": (
        [lambda x, n, be: jtr.astral_wordmap(x, n, "u32_to_u16pair", big_endian=be)],
        _pad_word32, "to16", "\U0001f642", 16384, (0xFFFF, 0xD800, 0x110000) + TOP),
}
ENDIAN = ("from16", "to16")  # the kinds that take ``be``


def _kind(name: str) -> str:
    return SPECS[name][2]


def _units(name: str) -> int:
    """UTF-16 units a code point of the class."""
    return 2 if ord(SPECS[name][3]) > 0xFFFF else 1


def _width(name: str) -> int:
    """Input elements a code point: UTF-8 bytes, UTF-16 units, 1 word."""
    kind = _kind(name)
    if kind == "from8":
        return len(SPECS[name][3].encode())
    return _units(name) if kind == "from16" else 1


def _class_data(name: str, chars: int) -> np.ndarray:
    kind, ch = _kind(name), SPECS[name][3]
    if kind == "from8":
        return np.frombuffer((ch * chars).encode(), np.uint8).copy()
    if kind == "from16":
        return np.frombuffer((ch * chars).encode("utf-16-le"), np.uint16).copy()
    return np.frombuffer((ch * chars).encode("utf-32-le"), np.uint32).copy()


def _cases(name: str):
    """(case id, elements) of one kernel: clean classes of 1 character, one
    tile and a ragged multi-tile length, then out-of-class values at 0, at
    the tile edge, at length-1, a character cut at the length and a few
    characters that fail only the class's finer checks."""
    tile, bad = SPECS[name][4:]
    width = _width(name)
    per_tile = tile // width
    out = [(f"clean-{c}", _class_data(name, c)) for c in (1, per_tile, 2 * per_tile + 333)]
    base = _class_data(name, 2 * per_tile + 333)
    for pos in (0, tile - 1, tile, len(base) - 1):
        for v in bad:
            d = base.copy()
            d[pos] = v
            out.append((f"{v:#x}@{pos}", d))
    if width > 1:
        out.append(("cut-at-length", base[:-1].copy()))
    # a surrogate and an overlong char; an overlong and a too-large one; a
    # low surrogate then a high one
    special = {"uniform3_utf8_to_utf32": (b"\xed\xa0\x80", b"\xe0\x80\x80"),
               "astral_utf8_to_utf32": (b"\xf0\x8f\xbf\xbf", b"\xf4\x90\x80\x80"),
               "astral_utf16_to_utf32": ("\udc3d\ud83d".encode("utf-16-le", "surrogatepass"),)}
    for enc in special.get(name, ()):
        d = base.copy()
        at = width * 500
        d[at:at + len(enc) // d.itemsize] = np.frombuffer(enc, d.dtype)
        out.append((f"{enc.hex()}@{at}", d))
    return out


CASES = [(name, cid, be) for name in SPECS for cid, _ in _cases(name)
         for be in ((False, True) if _kind(name) in ENDIAN else (False,))]
_DATA = {(name, cid): d for name in SPECS for cid, d in _cases(name)}


def _out_view(name: str):
    return {"from8": np.uint32, "from16": np.uint32, "to8": np.uint8, "to16": np.uint16}[
        _kind(name)]


def _pallas(name: str, data: np.ndarray, be: bool):
    """(flat padded buffer, [(Pallas out as a flat array, Pallas flag or
    None)] of each Pallas form)."""
    calls, pad = SPECS[name][:2]
    stored = data.byteswap() if be and data.dtype == np.uint16 else data
    x, n = pad(stored)
    x = np.array(x)  # the padding buffer is pooled
    flat = x.view(data.dtype).reshape(-1)
    got = []
    for call in calls:
        out, flag = call(jnp.asarray(x), n, be)
        got.append((np.asarray(out).view(_out_view(name)).reshape(-1),
                    None if flag is None else int(flag)))
    return flat, got


def _tensor(buf: np.ndarray) -> torch.Tensor:
    if buf.dtype == np.uint8:
        return torch.from_numpy(buf.copy())
    if buf.dtype == np.uint16:
        return torch.from_numpy(buf.view(np.int16).copy()).view(torch.uint16)
    return torch.from_numpy(buf.view(np.int32).copy())


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _call(name: str, x: torch.Tensor, length: int, be: bool):
    fn = getattr(t32, name)
    return fn(x, length, be) if _kind(name) in ENDIAN else fn(x, length)


def _class_len(name: str, length: int) -> int:
    """Elements of the class output: words from UTF-8 or UTF-16, bytes or
    units from words."""
    kind = _kind(name)
    if kind in ("from8", "from16"):
        return length // _width(name)
    return length * (len(SPECS[name][3].encode()) if kind == "to8" else _units(name))


def _class_flag(name: str, data: np.ndarray) -> bool:
    """The flag by its definition, on native elements with zeros after
    them: some character whose first element is in range lies outside the
    class."""
    kind, width = _kind(name), _width(name)
    if kind in ("to8", "to16"):  # the words as uint32; no class holds a surrogate
        cp = data.astype(np.int64)
        lo, hi = {"é": (0x80, 0x7FF), "東": (0x800, 0xFFFF),
                  "\U0001f642": (0x10000, 0x10FFFF)}[SPECS[name][3]]
        if name == "bmp_narrow_utf16":
            lo = 0
        return bool(((cp < lo) | (cp > hi) | ((cp >= 0xD800) & (cp <= 0xDFFF))).any())
    c = np.zeros(-(-len(data) // width) * width, np.int64)
    c[: len(data)] = data
    c = c.reshape(-1, width)
    if kind == "from16":
        if width == 1:
            return bool(((c & 0xF800) == 0xD800).any())
        return bool((~(((c[:, 0] & 0xFC00) == 0xD800) & ((c[:, 1] & 0xFC00) == 0xDC00))).any())
    if width == 1:
        return bool((c >= 0x80).any())
    cont = ((c[:, 1:] & 0xC0) == 0x80).all(axis=1)
    if width == 2:
        ok = ((c[:, 0] & 0xE0) == 0xC0) & (c[:, 0] >= 0xC2) & cont
    elif width == 3:
        cp = ((c[:, 0] & 0x0F) << 12) | ((c[:, 1] & 0x3F) << 6) | (c[:, 2] & 0x3F)
        ok = (((c[:, 0] & 0xF0) == 0xE0) & cont & (cp >= 0x800)
              & ((cp < 0xD800) | (cp > 0xDFFF)))
    else:
        cp = (((c[:, 0] & 0x07) << 18) | ((c[:, 1] & 0x3F) << 12)
              | ((c[:, 2] & 0x3F) << 6) | (c[:, 3] & 0x3F))
        ok = ((c[:, 0] & 0xF8) == 0xF0) & cont & (cp >= 0x10000) & (cp <= 0x10FFFF)
    return bool((~ok).any())


@pytest.mark.parametrize("name,cid,be", CASES)
def test_plain_version_matches_pallas(name, cid, be):
    data = _DATA[name, cid]
    flat, forms = _pallas(name, data, be)
    out, flag = _call(name, _tensor(flat), len(data), be)
    assert flag.dtype == torch.int32 and flag.dim() == 0
    assert int(flag) == _class_flag(name, data) == (not cid.startswith("clean"))
    k = _class_len(name, len(data))
    for want, want_flag in forms:
        assert want_flag in (None, int(flag))
        if not int(flag):
            assert np.array_equal(_numpy(out)[:k], want[:k])


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_version_ignores_garbage_past_length(name, be):
    """Garbage past the length changes neither the output, which is zero
    after the class output, nor the flag."""
    data = _class_data(name, 1000)
    if data.dtype == np.uint16 and be:
        data = data.byteswap()
    n = len(data) + 77
    rng = np.random.default_rng(n)
    garbage = rng.integers(0, 1 << (8 * data.itemsize), n, dtype=np.uint64).astype(data.dtype)
    zeros = np.zeros(n, data.dtype)
    for buf in (garbage, zeros):
        buf[: len(data)] = data
    out_g, flag_g = _call(name, _tensor(garbage), len(data), be)
    out_z, flag_z = _call(name, _tensor(zeros), len(data), be)
    assert int(flag_g) == int(flag_z) == 0
    assert np.array_equal(_numpy(out_g), _numpy(out_z))
    per = {"from8": 1, "from16": 1, "to8": 4, "to16": 2}[_kind(name)]
    assert _numpy(out_g).shape == (per * n,)
    assert not _numpy(out_g)[_class_len(name, len(data)):].any()


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("name", ["bmp_narrow_utf16", "astral_utf32_to_utf16"])
def test_narrow_keeps_16_bits_of_every_word(name, be):
    """On flagged input the units are the low 16 bits of the plain
    branch's values, byte-swapped for BE: bits above them never leak into
    the swapped unit."""
    words = np.array([0x12345678, 0xFFFFFFFF, 0x80000041, 0x1F642], np.uint32)
    out, flag = _call(name, _tensor(words), 4, be)
    x = words.astype(np.int64) - (words.astype(np.int64) >= 1 << 31) * (1 << 32)
    if name == "bmp_narrow_utf16":
        units = x & 0xFFFF
    else:
        units = np.stack([(0xD7C0 + (x >> 10)) & 0xFFFF, 0xDC00 + (x & 0x3FF)], 1).reshape(-1)
    if be:
        units = ((units >> 8) | (units << 8)) & 0xFFFF
    assert int(flag) == 1
    assert np.array_equal(_numpy(out)[: len(units)], units)
    assert not _numpy(out)[len(units):].any()


# --- the routes ------------------------------------------------------------------

_jto32 = jax.jit(jo8.to_utf32)
_jto32_valid = jax.jit(jo8.to_utf32_valid)
_j32to8 = jax.jit(jo32.to_utf8)
_j32to8_valid = jax.jit(jo32.to_utf8_valid)
_j32to16 = jax.jit(jo32.to_utf16, static_argnums=2)
_j32to16_valid = jax.jit(jo32.to_utf16_valid, static_argnums=2)
_j16to32 = jax.jit(jo16.to_utf32, static_argnums=2)
_j16to32_valid = jax.jit(jo16.to_utf32_valid, static_argnums=2)
_jl1_to_u32 = jax.jit(jol1.to_utf32)
ROUTE_N = 4096  # one buffer size for every route input: one JAX compile


@pytest.fixture
def spy(monkeypatch):
    """{wrapper name: [flag, ...]} of every wrapper call in the test."""
    calls = {}
    for name in SPECS:
        real = getattr(t32, name)

        def wrapped(*args, _real=real, _name=name):
            out, flag = _real(*args)
            calls.setdefault(_name, []).append(int(flag))
            return out, flag

        monkeypatch.setattr(t32, name, wrapped)
    return calls


def _garbage_buffer(data: np.ndarray, seed: int) -> tuple[np.ndarray, int]:
    """A ROUTE_N-element buffer holding ``data``, random elements past it."""
    bits = 8 * data.itemsize
    buf = np.random.default_rng(seed).integers(0, 1 << bits, ROUTE_N, dtype=np.uint64)
    buf = buf.astype(data.dtype)
    buf[: len(data)] = data
    return buf, len(data)


def _same(got, want) -> bool:
    return np.array_equal(_numpy(got).view(np.asarray(want).dtype), np.asarray(want))


U8_ROUTES = [("a", "latin1_widen_utf32"), ("é", "uniform2_utf8_to_utf32"),
             ("東", "uniform3_utf8_to_utf32"), ("\U0001f642", "astral_utf8_to_utf32")]


@pytest.mark.parametrize("chars", [1, 333, 1000])
@pytest.mark.parametrize("ch,kernel", U8_ROUTES)
def test_utf8_to_utf32_class_routes_match_xla_tier(spy, ch, kernel, chars):
    data = np.frombuffer((ch * chars).encode(), np.uint8)
    buf, L = _garbage_buffer(data, chars)
    x, jb = torch.from_numpy(buf.copy()), jnp.asarray(buf)
    want = _jto32(jb, L)
    got = to8.to_utf32(x, L)
    assert [int(v) for v in (got[0], got[1], got[3])] == [int(want[i]) for i in (0, 1, 3)]
    assert _same(got[2], want[2])
    want, total = _jto32_valid(jb, L)
    out, got_total = to8.to_utf32_valid(x, L)
    assert int(got_total) == int(total) == chars
    assert _same(out, want)
    assert spy == {kernel: [0, 0]}


U32_TO8_ROUTES = [("a", None), ("éЖ", "uniform2_utf32_to_utf8"), ("東京", "uniform3_utf32_to_utf8"),
                  ("\U0001f642\U0010ffff", "astral_utf32_to_utf8")]


@pytest.mark.parametrize("words", [1, 333, 1000])
@pytest.mark.parametrize("text,kernel", U32_TO8_ROUTES)
def test_utf32_to_utf8_class_routes_match_xla_tier(spy, text, kernel, words):
    """The ASCII class has no kernel: its branch is plain torch, as the
    ``pallas`` tier has no ASCII arm for UTF-32 -> UTF-8."""
    data = np.frombuffer((text * words).encode("utf-32-le"), np.uint32)[:words]
    buf, L = _garbage_buffer(data, words)
    w, jw = _tensor(buf), jnp.asarray(buf)
    want = _j32to8(jw, L)
    got = to32.to_utf8(w, L)
    assert [int(v) for v in (got[0], got[1], got[3])] == [int(want[i]) for i in (0, 1, 3)]
    assert _same(got[2], want[2])
    want, total = _j32to8_valid(jw, L)
    out, got_total = to32.to_utf8_valid(w, L)
    assert int(got_total) == int(total) == len(data.tobytes().decode("utf-32-le").encode())
    assert _same(out, want)
    assert spy == ({kernel: [0, 0]} if kernel else {})


U32_TO16_ROUTES = [("aé東", "bmp_narrow_utf16"), ("\U0001f642\U0010ffff", "astral_utf32_to_utf16")]


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("words", [1, 333, 1000])
@pytest.mark.parametrize("text,kernel", U32_TO16_ROUTES)
def test_utf32_to_utf16_class_routes_match_xla_tier(spy, text, kernel, words, be):
    data = np.frombuffer((text * words).encode("utf-32-le"), np.uint32)[:words]
    buf, L = _garbage_buffer(data, words)
    w, jw = _tensor(buf), jnp.asarray(buf)
    want = _j32to16(jw, L, be)
    got = to32.to_utf16(w, L, be)
    assert [int(v) for v in (got[0], got[1], got[3])] == [int(want[i]) for i in (0, 1, 3)]
    assert _same(got[2], want[2])
    want, total = _j32to16_valid(jw, L, be)
    out, got_total = to32.to_utf16_valid(w, L, be)
    assert int(got_total) == int(total) == len(data.tobytes().decode("utf-32-le").encode("utf-16-le")) // 2
    assert _same(out, want)
    assert spy == {kernel: [0, 0]}


U16_ROUTES = [("aé東", "bmp_widen_utf32"), ("\U0001f642\U0010ffff", "astral_utf16_to_utf32")]


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("chars", [1, 333, 1000])
@pytest.mark.parametrize("text,kernel", U16_ROUTES)
def test_utf16_to_utf32_class_routes_match_xla_tier(spy, text, kernel, chars, be):
    data = np.frombuffer((text * chars).encode("utf-16-le"), np.uint16)[: 2 * chars]
    if kernel == "bmp_widen_utf32":
        data = data[:chars]
    buf, L = _garbage_buffer(data.byteswap() if be else data, chars)
    w, jw = _tensor(buf), jnp.asarray(buf)
    want = _j16to32(jw, L, be)
    got = to16.to_utf32(w, L, be)
    assert [int(v) for v in (got[0], got[1], got[3])] == [int(want[i]) for i in (0, 1, 3)]
    assert _same(got[2], want[2])
    want, total = _j16to32_valid(jw, L, be)
    out, got_total = to16.to_utf32_valid(w, L, be)
    assert int(got_total) == int(total) == len(data.tobytes().decode("utf-16-le"))
    assert _same(out, want)
    assert spy == {kernel: [0, 0]}


def test_latin1_to_utf32_takes_the_widen_kernel(spy):
    """Every byte of the buffer, past the length too, as the JAX op; the
    widen kernel runs with the buffer's size and its flag (set by the
    high bytes) is not read."""
    data = np.arange(256, dtype=np.uint8).repeat(9)
    buf, L = _garbage_buffer(data, 256)
    got = tol1.to_utf32(torch.from_numpy(buf.copy()), L)
    assert _same(got, _jl1_to_u32(jnp.asarray(buf), L))
    assert spy == {"latin1_widen_utf32": [1]}


def test_mixed_input_takes_no_fixed_rate_kernel(spy):
    text = "a é 東 \U0001f642" * 50
    data = np.frombuffer(text.encode(), np.uint8)
    buf, L = _garbage_buffer(data, 5)
    to8.to_utf32(torch.from_numpy(buf.copy()), L)
    words = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    wbuf, W = _garbage_buffer(words, 6)
    to32.to_utf8(_tensor(wbuf), W)
    to32.to_utf16(_tensor(wbuf), W, False)
    units = np.frombuffer(text.encode("utf-16-le"), np.uint16)
    ubuf, U = _garbage_buffer(units, 7)
    to16.to_utf32(_tensor(ubuf), U, False)
    assert spy == {}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_wrappers_check_their_input(name):
    dtype = {"from8": torch.uint8, "from16": torch.int16}.get(_kind(name), torch.int32)
    good = torch.zeros(8, dtype=dtype)
    if _kind(name) == "from16":
        good = good.view(torch.uint16)
    with pytest.raises(ValueError):
        _call(name, good, 9, False)
    with pytest.raises(TypeError):
        _call(name, torch.zeros(8, dtype=torch.float32), 4, False)
