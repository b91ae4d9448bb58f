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
