"""simdutf_tpu_torch.kernels.compose16 against the Pallas butterfly
(simdutf_tpu.kernels.butterfly.to_utf16_compose, interpret mode on CPU,
called directly as tests/test_butterfly.py does: off the TPU the general
engine routes to the scatter form instead).

Same padded buffer and length into both; every element of the contract
must be equal: the full output buffer (zeros past out_len included),
total, err_any, err_pos, err_code and err_len. Without its clamp (the
valid-only converters) the compose is held against the JAX package's
``to_utf16_valid`` engine instead. Integer results: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simdutf_tpu.kernels import butterfly as jb
from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu_torch.kernels import compose16 as tc

T = jb.TILE  # 32 KiB butterfly tiles (the port's own tiles are 16 KiB)


def _compare(data: bytes, be: bool, length: int | None = None):
    """Run both on ``data`` zero-padded to whole butterfly tiles; the
    length defaults to all of ``data``."""
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
