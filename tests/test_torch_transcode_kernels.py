"""simdutf_tpu_torch.kernels.transcode against the Pallas fixed-rate
transcode kernels, and the routes that take them against the JAX ``xla``
tier's ops.

Each plain version (the wrapper on a CPU tensor) gets the Pallas
function's own padded buffer (``simdutf_tpu.kernels.impl._pad_widen``,
``_pad_u2``, ``_pad_u3``, ``_pad_narrow``: zeros past the length) and the
length; the Pallas function (for the astral kernel ``astral_wordmap``'s
``u8_to_u16`` variant) runs in interpret mode, as
tests/test_transcode_kernels.py runs it. Classes of 1 element, one Pallas
tile and a ragged multi-tile length, LE and BE, and out-of-class elements
at 0, at the tile edges and at length-1: the flag must be equal on every
input, and the output equal over the class output's length where the flag
is clear (on flagged input the Pallas output is meaningless). Then
``ops.utf8.to_utf16`` / ``to_utf16_valid``, ``ops.utf16.to_utf8`` /
``to_utf8_valid`` (the uniform-3 class included) and ``ops.latin1
.to_utf16`` on class inputs with garbage past the length, against the JAX
ops on the same buffer: full output buffers, bit for bit, and a spy on the
wrappers shows each class took its kernel with a clear flag. Integer
results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.kernels import transcode as jtr
from simdutf_tpu.kernels.impl import _pad_narrow, _pad_u2, _pad_u3, _pad_widen
from simdutf_tpu.ops import impl as jimpl
from simdutf_tpu.ops import latin1 as jol1
from simdutf_tpu.ops import utf16 as jo16
from simdutf_tpu_torch.kernels import transcode as ttr
from simdutf_tpu_torch.ops import latin1 as tol1
from simdutf_tpu_torch.ops import utf8 as to8
from simdutf_tpu_torch.ops import utf16 as to16

# name -> (Pallas call, its padding, class char, UTF-8 bytes per char,
# elements per Pallas tile, out-of-class values); the widen family's
# elements are bytes, the narrow family's units
SPECS = {
    "ascii_widen_utf16": (lambda x, n, be: jtr.ascii_widen_utf16(x, big_endian=be),
                          _pad_widen, "a", 1, 32768, (0x80, 0xFF)),
    "uniform2_utf8_to_utf16": (
        lambda x, n, be: jtr.uniform2_utf8_to_utf16(x, n, big_endian=be),
        _pad_u2, "é", 2, 65536, (0x41, 0xC1, 0xE9)),
    "uniform3_utf8_to_utf16": (
        lambda x, n, be: jtr.uniform3_utf8_to_utf16(x, n, big_endian=be),
        _pad_u3, "東", 3, 98304, (0x41, 0xC3, 0xF0)),
    "astral_utf8_to_utf16": (
        lambda x, n, be: jtr.astral_wordmap(x, n, "u8_to_u16", big_endian=be),
        _pad_u2, "\U0001f642", 4, 65536, (0x41, 0xC3, 0xF8)),
    "ascii_narrow_utf8": (lambda x, n, be: jtr.ascii_narrow_utf8(x, big_endian=be),
                          _pad_narrow, "a", 1, 32768, (0x80, 0x100, 0xFFFF)),
    "uniform2_utf16_to_utf8": (
        lambda x, n, be: jtr.uniform2_utf16_to_utf8(x, n, big_endian=be),
        _pad_narrow, "é", 2, 32768, (0x7F, 0x800, 0x41)),
    "uniform3_utf16_to_utf8": (
        lambda x, n, be: jtr.uniform3_utf16_to_utf8(x, n, big_endian=be),
        _pad_narrow, "東", 3, 32768, (0x7FF, 0xD800, 0xDFFF)),
}
WIDEN = ("ascii_widen_utf16", "uniform2_utf8_to_utf16", "uniform3_utf8_to_utf16",
         "astral_utf8_to_utf16")


def _class_data(name: str, chars: int) -> np.ndarray:
    _, _, ch, _, _, _ = SPECS[name]
    if name in WIDEN:
        return np.frombuffer((ch * chars).encode(), np.uint8).copy()
    return np.frombuffer((ch * chars).encode("utf-16-le"), np.uint16).copy()


def _cases(name: str):
    """(case id, elements) of one kernel: clean classes of 1 element, one
    tile and a ragged multi-tile length, then out-of-class values at 0,
    at the tile edge, at length-1, and a character cut at the length."""
    _, _, _, width, tile, bad = SPECS[name]
    per_tile = tile // width if name in WIDEN else tile
    out = [(f"clean-{c}", _class_data(name, c)) for c in (1, per_tile, 2 * per_tile + 333)]
    base = _class_data(name, 2 * per_tile + 333)
    for pos in (0, tile - 1, tile, len(base) - 1):
        for v in bad:
            d = base.copy()
            d[pos] = v
            out.append((f"{v:#x}@{pos}", d))
    if name in WIDEN and width > 1:
        out.append(("cut-at-length", base[:-1].copy()))
    # a surrogate and an overlong char; an overlong and a too-large one
    special = {"uniform3_utf8_to_utf16": (b"\xed\xa0\x80", b"\xe0\x80\x80"),
               "astral_utf8_to_utf16": (b"\xf0\x8f\xbf\xbf", b"\xf4\x90\x80\x80")}
    for enc in special.get(name, ()):
        d = base.copy()
        d[width * 500:width * 501] = np.frombuffer(enc, np.uint8)
        out.append((f"{enc.hex()}@{width * 500}", d))
    return out


CASES = [(name, cid) for name in SPECS for cid, _ in _cases(name)]
_DATA = {(name, cid): d for name in SPECS for cid, d in _cases(name)}


def _pallas(name: str, data: np.ndarray, be: bool):
    """(flat padded buffer, Pallas out as a flat array, Pallas flag)."""
    call, pad, *_ = SPECS[name]
    stored = data.byteswap() if be and name not in WIDEN else data
    x, n = pad(stored)
    x = np.array(x)  # the padding buffer is pooled
    out, flag = call(jnp.asarray(x), n, be)
    flat = x.view(np.uint8 if name in WIDEN else np.uint16).reshape(-1)
    kind = np.uint16 if name in WIDEN else np.uint8
    return flat, np.asarray(out).view(kind).reshape(-1), int(flag)


def _tensor(buf: np.ndarray) -> torch.Tensor:
    if buf.dtype == np.uint8:
        return torch.from_numpy(buf.copy())
    return torch.from_numpy(buf.view(np.int16).copy()).view(torch.uint16)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.uint16 else t.numpy()


def _class_len(name: str, length: int) -> int:
    width = SPECS[name][3]
    if name in WIDEN:  # a 4-byte character gives two units
        return length // width * (2 if width == 4 else 1)
    return width * length


def _class_flag(name: str, data: np.ndarray) -> bool:
    """The flag by its definition, on native elements with zeros after
    them: some character whose first byte is in range (widen), or some
    unit (narrow), lies outside the class."""
    width = SPECS[name][3]
    if name not in WIDEN:
        u = data.astype(np.int64)
        lo, hi = {1: (0, 0x7F), 2: (0x80, 0x7FF), 3: (0x800, 0xFFFF)}[width]
        return bool(((u < lo) | (u > hi) | ((u >= 0xD800) & (u <= 0xDFFF))).any())
    c = np.zeros(-(-len(data) // width) * width, np.int64)
    c[: len(data)] = data
    c = c.reshape(-1, width)
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


def _pallas_flag(name: str, data: np.ndarray, be: bool) -> bool:
    """The flag the Pallas function raises: the definition, except that
    ``_narrow_kernel``'s little-endian mask, the int32 ``-8355712``, is
    0xFF808080 and not the 0xFF80FF80 of its comment, so an even-indexed
    unit flags only through its bits 0x8080 (0x100 at unit 0 does not)."""
    if name != "ascii_narrow_utf8" or be:
        return _class_flag(name, data)
    mask = np.where(np.arange(len(data)) % 2 == 0, 0x8080, 0xFF80)
    return bool((data.astype(np.int64) & mask).any())


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("name,cid", CASES)
def test_plain_version_matches_pallas(name, cid, be):
    data = _DATA[name, cid]
    flat, want, want_flag = _pallas(name, data, be)
    out, flag = getattr(ttr, name)(_tensor(flat), len(data), be)
    assert flag.dtype == torch.int32 and flag.dim() == 0
    assert int(flag) == _class_flag(name, data) == (not cid.startswith("clean"))
    assert want_flag == _pallas_flag(name, data, be)
    k = _class_len(name, len(data))
    if not int(flag):
        assert np.array_equal(_numpy(out)[:k], want[:k])


def test_pallas_narrow_little_endian_mask_misses_an_even_unit():
    """The one input class where the Pallas flag and the port's differ:
    0x100 at an even unit index, little-endian. The port flags every unit
    >= 0x80, as the Pallas kernel's docstring defines its flag."""
    data = np.array([0x100, 0x61], np.uint16)
    flat, _, want_flag = _pallas("ascii_narrow_utf8", data, False)
    _, flag = ttr.ascii_narrow_utf8(_tensor(flat), 2, False)
    assert (want_flag, int(flag)) == (0, 1)


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_version_ignores_garbage_past_length(name, be):
    """Garbage past the length changes neither the output, which is zero
    after the class output, nor the flag."""
    data = _class_data(name, 1000)
    if name not in WIDEN and be:
        data = data.byteswap()
    n = len(data) + 77
    rng = np.random.default_rng(n)
    garbage = rng.integers(0, 1 << (8 * data.itemsize), n).astype(data.dtype)
    zeros = np.zeros(n, data.dtype)
    for buf in (garbage, zeros):
        buf[: len(data)] = data
    fn = getattr(ttr, name)
    out_g, flag_g = fn(_tensor(garbage), len(data), be)
    out_z, flag_z = fn(_tensor(zeros), len(data), be)
    assert int(flag_g) == int(flag_z) == 0
    assert np.array_equal(_numpy(out_g), _numpy(out_z))
    k = _class_len(name, len(data))
    assert out_g.shape[0] == (n if name in WIDEN else 3 * n)
    assert not _numpy(out_g)[k:].any()


# --- the routes ------------------------------------------------------------------

_jto8 = jax.jit(jo16.to_utf8, static_argnums=2)
_jto8_valid = jax.jit(jo16.to_utf8_valid, static_argnums=2)
_jl1_to_u16 = jax.jit(jol1.to_utf16, static_argnums=2)
ROUTE_N = 4096  # one buffer size for every route input: one JAX compile


@pytest.fixture
def spy(monkeypatch):
    """{wrapper name: [flag, ...]} of every wrapper call in the test."""
    calls = {}
    for name in SPECS:
        real = getattr(ttr, name)

        def wrapped(*args, _real=real, _name=name):
            out, flag = _real(*args)
            calls.setdefault(_name, []).append(int(flag))
            return out, flag

        monkeypatch.setattr(ttr, name, wrapped)
    return calls


def _garbage_buffer(data: np.ndarray, seed: int) -> tuple[np.ndarray, int]:
    """A ROUTE_N-element buffer holding ``data``, random elements past it."""
    n = ROUTE_N
    bits = 8 * data.itemsize
    buf = np.random.default_rng(seed).integers(0, 1 << bits, n).astype(data.dtype)
    buf[: len(data)] = data
    return buf, len(data)


U8_ROUTES = [("ascii", "a", "ascii_widen_utf16"), ("u2", "é", "uniform2_utf8_to_utf16"),
             ("u3", "東", "uniform3_utf8_to_utf16"), ("u4", "\U0001f642", "astral_utf8_to_utf16")]


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("chars", [1, 333, 1000])
@pytest.mark.parametrize("cls,ch,kernel", U8_ROUTES)
def test_utf8_to_utf16_class_routes_match_xla_tier(spy, cls, ch, kernel, chars, be):
    data = np.frombuffer((ch * chars).encode(), np.uint8)
    buf, L = _garbage_buffer(data, chars)
    x, jb = torch.from_numpy(buf.copy()), jnp.asarray(buf)
    jfn = jimpl._j_u8_to_u16be if be else jimpl._j_u8_to_u16le
    code, pos, want, want_len = jfn(jb, jnp.int32(L))
    got = to8.to_utf16(x, L, be)
    assert [int(v) for v in (got[0], got[1], got[3])] == [int(code), int(pos), int(want_len)]
    assert np.array_equal(_numpy(got[2]), np.asarray(want))
    jfn = jimpl._j_u8_to_u16be_v if be else jimpl._j_u8_to_u16le_v
    want, total = jfn(jb, jnp.int32(L))
    out, got_total = to8.to_utf16_valid(x, L, be)
    assert int(got_total) == int(total) == len((ch * chars).encode("utf-16-le")) // 2
    assert np.array_equal(_numpy(out), np.asarray(want))
    assert spy == {kernel: [0, 0]}


U16_ROUTES = [("ascii", "a", "ascii_narrow_utf8"), ("u2r", "éЖ", "uniform2_utf16_to_utf8"),
              ("u3r", "東京", "uniform3_utf16_to_utf8")]


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("units", [1, 333, 1000])
@pytest.mark.parametrize("cls,text,kernel", U16_ROUTES)
def test_utf16_to_utf8_class_routes_match_xla_tier(spy, cls, text, kernel, units, be):
    data = np.frombuffer((text * units).encode("utf-16-le"), np.uint16)[:units]
    buf, L = _garbage_buffer(data.byteswap() if be else data, units)
    w, jw = _tensor(buf), jnp.asarray(buf)
    want = [np.asarray(v) for v in _jto8(jw, L, be)]
    got = to16.to_utf8(w, L, be)
    assert [int(got[i]) for i in (0, 1, 3)] == [int(want[i]) for i in (0, 1, 3)]
    assert np.array_equal(got[2].numpy(), want[2])
    want_out, total = _jto8_valid(jw, L, be)
    out, got_total = to16.to_utf8_valid(w, L, be)
    assert int(got_total) == int(total) == len(data.tobytes().decode("utf-16-le").encode())
    assert np.array_equal(out.numpy(), np.asarray(want_out))
    assert spy == {kernel: [0, 0]}


@pytest.mark.parametrize("be", [False, True])
def test_latin1_to_utf16_takes_the_widen_kernel(spy, be):
    """Every byte of the buffer, past the length too, as the JAX op; the
    widen kernel runs with the buffer's size and its flag (set by the
    high bytes) is not read."""
    data = np.arange(256, dtype=np.uint8).repeat(9)
    buf, L = _garbage_buffer(data, 256)
    got = tol1.to_utf16(torch.from_numpy(buf.copy()), L, be)
    assert np.array_equal(_numpy(got), np.asarray(_jl1_to_u16(jnp.asarray(buf), L, be)))
    assert spy == {"ascii_widen_utf16": [1]}


def test_mixed_input_takes_no_fixed_rate_kernel(spy):
    data = np.frombuffer("a é 東 \U0001f642".encode() * 50, np.uint8)
    buf, L = _garbage_buffer(data, 5)
    to8.to_utf16(torch.from_numpy(buf.copy()), L, False)
    units = np.frombuffer(data.tobytes().decode().encode("utf-16-le"), np.uint16)
    ubuf, U = _garbage_buffer(units, 6)
    to16.to_utf8(_tensor(ubuf), U, False)
    assert spy == {}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_wrappers_check_their_input(name):
    fn = getattr(ttr, name)
    good = torch.zeros(8, dtype=torch.uint8 if name in WIDEN else torch.int16)
    if name not in WIDEN:
        good = good.view(torch.uint16)
    with pytest.raises(ValueError):
        fn(good, 9, False)
    with pytest.raises(TypeError):
        fn(torch.zeros(8, dtype=torch.int32), 4, False)
