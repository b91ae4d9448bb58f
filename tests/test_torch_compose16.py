"""simdutf_tpu_torch.kernels.compose16 against the Pallas butterfly
(simdutf_tpu.kernels.butterfly.to_utf16_compose, interpret mode on CPU,
called directly as tests/test_butterfly.py does: off the TPU the general
engine routes to the scatter form instead).

Same padded buffer and length into both; every element of the contract
must be equal: the full output buffer (zeros past out_len included),
total, err_any, err_pos, err_code and err_len. Without its clamp (the
valid-only converters) the compose is held against the JAX package's
``to_utf16_valid`` engine instead. Integer results: exact.

The ``cuda`` tests at the end hold the kernel's tile pipeline against the
plain version on the card. They import no jax (it is imported inside the
CPU tests that use it), so on a machine with the card they run alone:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_compose16.py -m cuda
"""

import numpy as np
import pytest
import torch

from simdutf_tpu_torch.kernels import compose16 as tc

T = 32 * 1024  # the butterfly's tiles (the port's own tiles are 16 KiB)


def _jax():
    """jax.numpy, simdutf_tpu.kernels.butterfly and simdutf_tpu.ops.utf8."""
    import jax.numpy as jnp

    from simdutf_tpu.kernels import butterfly as jb
    from simdutf_tpu.ops import utf8 as jo8

    assert jb.TILE == T
    return jnp, jb, jo8


def _compare(data: bytes, be: bool, length: int | None = None):
    """Run both on ``data`` zero-padded to whole butterfly tiles; the
    length defaults to all of ``data``."""
    jnp, jb, _ = _jax()
    length = len(data) if length is None else length
    buf = np.zeros(max(T, -(-len(data) // T) * T), np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    want = jb.to_utf16_compose(jnp.asarray(buf), jnp.int32(length), be)
    got = tc.to_utf16_compose(torch.from_numpy(buf), length, be)
    out, rest = got[0].view(torch.int16).numpy().view(np.uint16), got[1:]
    assert np.array_equal(out, np.asarray(want[0]))
    assert [int(v) for v in rest] == [int(v) for v in want[1:]]
    return [int(v) for v in rest]


CASES = {
    # every class interleaved, straddling the 32 KiB tile edge
    "mixed_2tiles": ("ab é 東 \U0001f642 ".encode() * 2400)[:2 * T - 100],
    # dense CJK with spaces: no tile is uniform
    "zh_spaces": ("東京は日本 ".encode() * 2000)[:T - 7],
    "emoji": "\U0001f642\U0001f680".encode() * 1000,
    # a 4-byte sequence whose lead is the last byte of tile 0
    "straddle4": b"a" * (T - 1) + "\U0001f642".encode() + b"tail",
    # errors: in tile 1, at 0, cut at the length, a surrogate near the end
    "err_tile1": b"a" * (T + 5) + b"\xff" + "é".encode() * 100,
    "err_at_0": b"\x80" + "東".encode() * 100,
    "cut_at_length": "é東".encode() * 500 + "\U0001f642".encode()[:2],
    "surrogate": "é".encode() * 1000 + b"\xed\xa0\x80" + b"z" * 10,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_compose_matches_butterfly(name):
    be = name in ("mixed_2tiles", "err_tile1")
    total, err_any, err_pos, err_code, err_len = _compare(CASES[name], be)
    assert bool(err_any) == name.startswith(("err", "cut", "surrogate"))


def test_compose_truncated_lead4_keeps_low_unit():
    """A 4-byte lead in the last in-range byte: the byte at the length
    still carries a unit in ``total`` (the unit-per-byte form), in both."""
    data = b"abc" * 300 + b"\xf0"
    total, err_any, err_pos, err_code, err_len = _compare(
        data + b"\x9f\x99\x82", False, len(data))
    assert err_any and (err_pos, err_code) == (len(data) - 1, 2)
    assert total == len(data) + 1


def test_compose_empty_length():
    assert _compare(b"", False)[:2] == [0, 0]


@pytest.mark.parametrize("name", sorted(CASES) + ["truncated_lead", "ff_mid", "cut4"])
@pytest.mark.parametrize("be", [False, True])
def test_compose_without_clamp_matches_jax_valid_engine(name, be):
    """clamp=False (the valid-only converters): every in-range lead's
    mechanically decoded unit(s), past the first error too, as the JAX
    package's to_utf16_valid general branch writes them."""
    data = {"truncated_lead": b"\xe6", "ff_mid": b"a\xffb",
            "cut4": b"ab\xf0\x90"}.get(name) or CASES[name]
    jnp, _, jo8 = _jax()
    buf = np.zeros(max(T, -(-len(data) // T) * T), np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    jb8 = jnp.asarray(buf)
    cls = jo8.classify(jb8, len(data))
    lead = cls["lead"] & (np.arange(len(buf)) < len(data))
    want, _, total = jo8._emit_utf16_units(cls["cp"], lead, cls["lead4"], len(buf), be)
    got = tc.to_utf16_compose(torch.from_numpy(buf), len(data), be, clamp=False)
    assert np.array_equal(got[0].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(want).astype(np.uint16))
    assert int(got[1]) == int(total)
    # the validating call's scalars are unchanged by the clamp
    clamped = tc.to_utf16_compose(torch.from_numpy(buf), len(data), be)
    assert [int(v) for v in got[1:]] == [int(v) for v in clamped[1:]]


# -- the compose contract that ops/common.routed assembles on ----------------

_TEXT = "aé東\U0001f642 " * 40


def _units(s: str, *extra: int) -> torch.Tensor:
    u = np.concatenate([np.frombuffer(s.encode("utf-16-le"), np.uint16),
                        np.array(extra, np.uint16)])
    return torch.from_numpy(u.view(np.int16)).view(torch.uint16)


def _words(s: str, *extra: int) -> torch.Tensor:
    w = np.array([ord(c) for c in s] + list(extra), np.uint32)
    return torch.from_numpy(w.view(np.int32))


#: (input valid, input with errors), each a 1-D tensor taken whole
_INPUTS = {
    "bytes": (torch.frombuffer(bytearray(_TEXT.encode()), dtype=torch.uint8),
              torch.frombuffer(bytearray(_TEXT.encode() + b"\xff" + b"z" * 9),
                               dtype=torch.uint8)),
    "units": (_units(_TEXT), _units(_TEXT, 0xD800, 0x61, 0xDC00)),
    "words": (_words(_TEXT), _words(_TEXT, 0x110000, 0xD800, 0x61)),
}


def _wrappers():
    from simdutf_tpu_torch.kernels import compose8 as tc8
    from simdutf_tpu_torch.kernels import compose32 as tc32
    from simdutf_tpu_torch.kernels import composex as tcx

    return {
        "compose8": ("units", lambda x, n: tc8.to_utf8_compose(x, n, False)),
        "compose8_valid": ("units", lambda x, n: tc8.to_utf8_compose(x, n, False, "valid")),
        "compose16": ("bytes", lambda x, n: tc.to_utf16_compose(x, n, False)),
        "compose16_no_clamp": ("bytes",
                               lambda x, n: tc.to_utf16_compose(x, n, False, clamp=False)),
        "compose32": ("bytes", tc32.to_utf32_compose),
        "u32_to_utf8": ("words", tcx.u32_to_utf8_compose),
        "u16_to_utf32": ("units", lambda x, n: tcx.u16_to_utf32_compose(x, n, False)),
        "u32_to_utf16": ("words", lambda x, n: tcx.u32_to_utf16_compose(x, n, False)),
    }


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
@pytest.mark.parametrize("wrapper", sorted(_wrappers()))
def test_no_error_is_code_0_at_big(wrapper, valid):
    """ops/common.routed passes err_code on as it is and clamps err_pos to
    the length, so every compose wrapper must report err_code 0 and
    err_pos BIG exactly when err_any is False, and an error in range."""
    kind, fn = _wrappers()[wrapper]
    x = _INPUTS[kind][0 if valid else 1]
    length = x.shape[0] - 1  # an element past the length: garbage to ignore
    _, _, err_any, err_pos, err_code, _ = fn(x, length)
    assert bool(err_any) == (not valid and wrapper != "compose8_valid")
    assert (int(err_code) == 0 and int(err_pos) == 2**31 - 1) == (not bool(err_any))
    assert not err_any or int(err_pos) < length


# -- the tile pipeline on the card ----------------------------------------------
#
# Every case runs on one block, which takes every tile in turn through both
# staging buffers and its look-back warp (tile t + 1 is decoded while tile
# t's prefix is pending), and on the whole grid; in each byte order, with
# and without the clamp; against the plain version on the whole uint16[n]
# buffer and the five results.

_CARD_TEXT = "ab é 東 Жм ".encode() * 8000
_CARD_ASTRAL = "ab é \U0001f642 東 ".encode() * 8000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0")
    return torch.device("cuda")


def _text(size: int, astral: bool = False) -> bytes:
    """Mixed text (with 4-byte sequences when ``astral``) cut to ``size``
    bytes at a character start, filled up with 'a'."""
    src = _CARD_ASTRAL if astral else _CARD_TEXT
    d = (src * (size // len(src) + 1))[:size].decode("utf-8", "ignore").encode()
    return d + b"a" * (size - len(d))


def _with(data: bytes, pos: int, seq: bytes) -> bytes:
    d = bytearray(data)
    d[pos:pos + len(seq)] = seq
    return bytes(d)


def _pipeline_cases():
    """name -> [(bytes, length, n), ...]: the bytes fill the start of an
    n-byte buffer whose rest is seeded garbage."""
    K = tc.TILE
    base = _text(6 * K + 777)
    astral = _text(6 * K + 777, True)
    lead4 = "\U0001f642".encode()
    cases = {
        # an error in tile t + 1 while tile t's prefix is pending, and in
        # the first and the last tile; an error cut short at the length
        "err_next_tile": [(_with(base, K + p, b"\xff"), len(base), len(base) + 64)
                          for p in (0, 1, K // 2, K - 1)],
        "err_first_tile": [(_with(base, p, s), len(base), len(base) + 7)
                           for p, s in ((0, b"\x80"), (9, b"\xed\xa0\x80"), (K - 2, b"\xc0\xaf"))],
        "err_last_tile": [(_with(base, len(base) - p, s), len(base), len(base) + 5)
                          for p, s in ((1, b"\xe6"), (3, b"\xf0\x9f"), (300, b"\xf8"))],
        # a 4-byte lead whose low surrogate falls in the next tile, or at
        # the length itself (its continuations past it)
        "lead4_tile_edge": [(_with(b"a" * len(base), t * K - 1, lead4), len(base), len(base) + 3)
                            for t in (1, 2, 5)]
                           + [(_with(base, K - 1, lead4), len(base), len(base) + 3),
                              (_with(astral, 2 * K - 1, lead4), len(astral), len(astral) + 3)],
        "lead4_at_length": [(base[: 2 * K + 99] + lead4, 2 * K + 100, 2 * K + 104),
                            (astral[: 3 * K - 1] + lead4, 3 * K, 3 * K + 9)],
        # 4-byte sequences throughout: the decode of each marked byte
        "astral": [(astral, len(astral), len(astral) + 11)],
        # n far above the length: the zero tail spans many tiles
        "zero_tail": [(base[: 3 * K + 5], 3 * K + 5, 40 * K)],
    }
    # the ragged last tile ending in each of its 16-byte chunks
    cases["ragged_end"] = [(base[: K + 16 * c + c % 16], K + 16 * c + c % 16,
                            K + 16 * c + c % 16 + 16) for c in range(K // 16)]
    return cases


def _same(a, b) -> bool:
    for x, y in zip(a, b):
        if x.dtype == torch.uint16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x.to(torch.int64).cpu(), y.to(torch.int64).cpu()):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 0], ids=["one_block", "whole_grid"])
@pytest.mark.parametrize("case", ["astral", "err_first_tile", "err_last_tile", "err_next_tile",
                                  "lead4_at_length", "lead4_tile_edge", "ragged_end",
                                  "zero_tail"])
def test_pipeline_matches_plain_version(cuda, case, blocks):
    """Each case's buffers through csrc/compose16.cu's tile pipeline (on
    one block, or as many as are resident), LE and BE, with and without the
    clamp, against to_utf16_compose_ref: the whole uint16[n] buffer (zeros
    past out_len included) and total, err_any, err_pos, err_code, err_len.
    The ragged lengths take one mode each, in turn."""
    modes = [(be, clamp) for be in (False, True) for clamp in (True, False)]
    for i, (data, length, n) in enumerate(_pipeline_cases()[case]):
        buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
        buf[: len(data)] = np.frombuffer(data, np.uint8)[:n]
        x = torch.from_numpy(buf).to(cuda)
        for be, clamp in [modes[i % 4]] if case == "ragged_end" else modes:
            junk = torch.full((n,), -1, dtype=torch.int16, device=cuda)
            del junk  # a zero the kernel failed to write shows
            got = tc._on_blocks(x, length, be, clamp, blocks)
            want = tc.to_utf16_compose_ref(x, length, be, clamp)
            assert _same(got, want), (case, i, length, be, clamp)
    torch.cuda.synchronize()
