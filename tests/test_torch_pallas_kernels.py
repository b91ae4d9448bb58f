"""The port's other kernels of the ``pallas`` tier against the JAX package:
``clean_decode`` (kernels/base64_kernel.py) against the Pallas
``_clean_decode_pallas``, ``row_compact`` (kernels/compaction.py) against
``row_compact_pallas``, both in interpret mode; ``lane_shapecast_probe``
(kernels/validate.py) against a numpy transcription of the probe kernel
of ``validate.lane_shapecast_supported``; and validate_host.py against
the golden validators it copies, on seeded windows.

Each plain version (the wrapper on a CPU tensor) gets the Pallas
function's own padded buffer as a flat tensor (``_pad_b64c`` for the
decode), and its output must equal the Pallas output flattened: bytes,
flag, counts, word for word. Integer results: exact.
"""

import base64 as pyb64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simdutf_tpu.golden import utf8 as g8
from simdutf_tpu.golden import utf16 as g16
from simdutf_tpu.kernels import base64_kernel as jb64
from simdutf_tpu.kernels import compaction as jcmp
from simdutf_tpu.kernels.impl import _pad_b64c
from simdutf_tpu_torch import validate_host as vh
from simdutf_tpu_torch.kernels import base64_kernel as tb64
from simdutf_tpu_torch.kernels import compaction as tcmp
from simdutf_tpu_torch.kernels import validate as tv

MODES = [(False, False), (True, False), (False, True)]  # (url, both)


def _b64_cases():
    raw = np.random.default_rng(41).integers(0, 256, 30_000, dtype=np.uint8).tobytes()
    std = pyb64.b64encode(raw)
    url = pyb64.urlsafe_b64encode(raw)
    cases = [("std", std, len(std) // 4), ("url", url, len(url) // 4),
             ("short-nwords", std, len(std) // 4 - 777), ("zero-nwords", std[:400], 0),
             ("one-word", b"TWFu", 1)]
    for pos, ch in ((0, b"="), (4095, b" "), (20_000, b"*"), (len(std) - 1, b"\n")):
        d = bytearray(std)
        d[pos:pos + 1] = ch
        cases.append((f"dirty{ch.hex()}@{pos}", bytes(d), len(d) // 4))
    d = bytearray(std)
    d[len(std) - 8] = ord("!")  # dirty, but in a word past nwords: no flag
    cases.append(("dirty-past-nwords", bytes(d), len(d) // 4 - 2))
    return cases


B64 = _b64_cases()


@pytest.mark.parametrize("name,chars,nwords", B64, ids=[c[0] for c in B64])
@pytest.mark.parametrize("url,both", MODES)
def test_clean_decode_matches_pallas(name, chars, nwords, url, both):
    x32, _ = _pad_b64c(np.frombuffer(chars, np.uint8))
    out, flag = jb64._clean_decode_pallas(jnp.asarray(x32), nwords, url, both)
    want = np.asarray(out).view(np.uint8).reshape(-1)
    got, got_flag = tb64.clean_decode(torch.from_numpy(x32.view(np.uint8).reshape(-1).copy()),
                                      nwords, url, both)
    assert int(got_flag) == int(flag)
    assert np.array_equal(got.numpy(), want)


def test_clean_decode_flags_each_alphabet_and_decodes_its_own():
    data = np.frombuffer(b"ab+/ab-_" + b"AAAA" * 2, np.uint8)
    t = torch.from_numpy(data.copy())
    assert int(tb64.clean_decode(t, 4, url=False)[1]) == 1  # '-_' outside default
    assert int(tb64.clean_decode(t, 4, url=True)[1]) == 1  # '+/' outside url
    out, flag = tb64.clean_decode(t, 4, both=True)
    assert int(flag) == 0
    assert out.numpy().tobytes()[:6] == pyb64.b64decode(b"ab+/ab+/")


def test_clean_decode_rejects_a_ragged_buffer():
    with pytest.raises(ValueError):
        tb64.clean_decode(torch.zeros(10, dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        tb64.clean_decode(torch.zeros(8, dtype=torch.uint8), 3)


@pytest.mark.parametrize("shape,seed,density", [((8, 128), 5, 0.4), ((4, 256), 6, 0.4),
                                                ((8, 128), 7, 0.0), ((8, 128), 8, 1.0),
                                                ((16, 32), 9, 0.7)])
def test_row_compact_matches_pallas(shape, seed, density):
    rng = np.random.default_rng(seed)
    val = rng.integers(-1000, 1000, shape).astype(np.int32)
    keep = (rng.random(shape) < density).astype(np.int32)
    out, cnt = jcmp.row_compact_pallas(jnp.asarray(val), jnp.asarray(keep))
    got, got_cnt = tcmp.row_compact(torch.from_numpy(val), torch.from_numpy(keep))
    assert np.array_equal(got.numpy(), np.asarray(out))
    assert np.array_equal(got_cnt.numpy(), np.asarray(cnt))


def test_row_compact_takes_a_bool_mask_and_wide_rows():
    rng = np.random.default_rng(3)
    val = rng.integers(0, 1 << 20, (3, 2048)).astype(np.int32)
    keep = rng.random((3, 2048)) < 0.3
    got, cnt = tcmp.row_compact(torch.from_numpy(val), torch.from_numpy(keep))
    for r in range(3):
        want = val[r][keep[r]]
        assert int(cnt[r]) == len(want)
        assert np.array_equal(got[r, :len(want)].numpy(), want)
        assert not got[r, len(want):].any()


@pytest.mark.parametrize("width", [96, 3, 0])
def test_row_compact_rejects_a_width_that_is_no_power_of_two(width):
    val = torch.zeros((4, width), dtype=torch.int32)
    with pytest.raises(ValueError):
        tcmp.row_compact(val, val)
    if width:
        with pytest.raises(ValueError):
            jcmp.row_compact_pallas(jnp.zeros((4, width), jnp.int32),
                                    jnp.zeros((4, width), jnp.int32))


def _probe_numpy(x: np.ndarray, salt: int) -> np.ndarray:
    """validate.lane_shapecast_supported's kernel ``k``, line by line."""
    x = x ^ salt
    quads = x.reshape(64, 128, 4)
    a = quads[..., 0] ^ quads[..., 3]
    b = quads[..., 1] ^ quads[..., 2]
    two = np.stack([a, b], axis=-1).reshape(64, 256)
    pairs = two.reshape(64, 128, 2)
    return np.stack([pairs[..., 0], pairs[..., 1], a, b], axis=-1).reshape(64, 512)


@pytest.mark.parametrize("salt", [1, 2, 3])
def test_lane_shapecast_probe_matches_the_probe_kernel(salt):
    tile = np.random.default_rng(salt).integers(-2**31, 2**31, (64, 512)).astype(np.int32)
    got = tv.lane_shapecast_probe(torch.from_numpy(tile), salt)
    assert np.array_equal(got.numpy(), _probe_numpy(tile, salt))


def _windows8():
    rng = np.random.default_rng(8)
    alphabet = ["a", "é", "東", "\U0001f642", " "]
    bad = [b"\x80", b"\xff", b"\xc3", b"\xe6\x9d", b"\xf0\x9f", b"\xed\xa0\x80",
           b"\xc0\xaf", b"\xf4\x90\x80\x80", b"\xf8"]
    out = [b"", b"\x80", b"\xc3"]
    for t in range(300):
        size = int(rng.integers(1, 25))
        d = bytearray("".join(alphabet[i] for i in rng.integers(0, 5, size)).encode())
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(d) + 1))
            d[p:p] = bad[int(rng.integers(len(bad)))]
        start = int(rng.integers(0, 4))  # windows may start inside a character
        out.append(bytes(d[start:start + 24]))
    return out


def test_validate_host_utf8_equals_golden():
    for w in _windows8():
        arr = np.frombuffer(w, np.uint8)
        assert vh.validate_utf8_with_errors(arr) == g8.validate_with_errors(arr), w.hex()


@pytest.mark.parametrize("be", [False, True])
def test_validate_host_utf16_equals_golden(be):
    rng = np.random.default_rng(16)
    for t in range(300):
        units = rng.choice(np.array([0x61, 0xE9, 0x6771, 0xD83D, 0xDE42, 0xDBFF, 0xDC00],
                                    np.uint16), int(rng.integers(0, 13)))
        stored = units.byteswap() if be else units
        assert (vh.validate_utf16_with_errors(stored, be)
                == g16.validate_with_errors(stored, big_endian=be)), units
