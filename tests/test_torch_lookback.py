"""The single-pass look-back kernels' plain pieces, on the CPU.

csrc/compose16.cu and csrc/base64.cu's compaction run one launch each: a
tile publishes (count, least event key, count before it), looks back for
its exclusive prefix, and writes its output. Their kernels run only on the
card (tests/test_torch_cuda.py); here:

* the per-tile triples of compose16's plain lattice
  (``tile_aggregates_ref``) combine, in tile order, to the compose
  result's total, first error and err_len, and to the JAX package's first
  error on the same bytes;
* the plain twin of compose16's fast check (``tile_flags_ref``) flags
  every tile that holds an event of that lattice: every 1- and 2-byte
  sequence, 3-byte sequences over class-boundary bytes and seeded 4-byte
  sequences over every lead F0-FF, each alone in a tile of ASCII at its
  first, a middle and its last bytes;
* every C entry point's ctypes signature has as many arguments as its
  source (a missing stream argument would be passed as a 32-bit int).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simdutf_tpu.ops import utf8 as jo8
from simdutf_tpu_torch.kernels import _build
from simdutf_tpu_torch.kernels import compose16 as tc
from simdutf_tpu_torch.ops.common import BIG

NO_EVENT = BIG << 8


def _combine(a, b):
    """The look-back's combine of two adjacent runs, ``a`` the earlier."""
    return (a[0] + b[0], min(a[1], b[1]), a[2] if a[1] < b[1] else a[0] + b[2])


def _fold(b: torch.Tensor, length: int):
    count, key, before = tc.tile_aggregates_ref(b, length)
    acc = (0, NO_EVENT, 0)
    for t in zip(count.tolist(), key.tolist(), before.tolist()):
        acc = _combine(acc, t)
    return acc


def _text(seed: int, size: int, bad: int) -> bytes:
    rng = np.random.default_rng(seed)
    alphabet = ["a", " ", "é", "東", "\U0001f642", "Ж"]
    d = bytearray("".join(alphabet[i] for i in rng.integers(0, 6, size)).encode()[:size])
    for _ in range(bad):
        p = int(rng.integers(0, len(d) + 1))
        d[p:p] = [b"\xff", b"\x80", b"\xed\xa0\x80", b"\xf0\x9f", b"\xc0\xaf",
                  b"\xf4\x90\x80\x80"][int(rng.integers(6))]
    return bytes(d)


CASES = [(f"text{s}-{bad}", _text(s, size, bad))
         for s, (size, bad) in enumerate([(3 * tc.TILE + 5, 0), (2 * tc.TILE, 1),
                                          (tc.TILE + 3, 2), (5000, 3), (tc.TILE - 1, 1)])]
CASES += [("lead4-at-edge", b"a" * (tc.TILE - 1) + "\U0001f642".encode() + b"z"),
          ("cut4-at-length", b"a" * (tc.TILE - 2) + "\U0001f642".encode()[:3]),
          ("orphan-after-f8", b"a" * (tc.TILE - 2) + b"\xf8\x80\x80" + b"a" * 9),
          ("one", b"\x80")]


@pytest.mark.parametrize("name,data", CASES, ids=[c for c, _ in CASES])
def test_tile_triples_combine_to_the_first_error(name, data):
    n = len(data) + 3
    buf = np.zeros(n, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    x = torch.from_numpy(buf)
    count, key, before = _fold(x, len(data))
    _, total, err_any, err_pos, err_code, err_len = tc.to_utf16_compose_ref(x, len(data), False)
    assert count == int(total)
    assert (key >> 8, key & 0xFF) == (int(err_pos), int(err_code))
    assert (before if key != NO_EVENT else 0) == int(err_len)
    want = jo8.validate_with_errors(jnp.asarray(buf), len(data))
    assert (int(want[1]) if int(want[0]) else BIG) == key >> 8


def _fast_check_sequences():
    edge = [0x00, 0x41, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xC1,
            0xC2, 0xDF, 0xE0, 0xED, 0xEF, 0xF0, 0xF4, 0xF5, 0xF8, 0xFF]
    rng = np.random.default_rng(7)
    one = [[a] for a in range(256)]
    two = [[a, b] for a in range(256) for b in range(256)]
    three = [[a, b, c] for a in range(256) for b in edge for c in edge]
    four = [[lead, *rng.integers(0x70, 0x100, 3).tolist()]
            for lead in range(0xF0, 0x100) for _ in range(400)]
    return {"1": one, "2": two, "3": three, "4": four}


SEQS = _fast_check_sequences()
TILE = 16  # a small tile: the check looks at most four bytes around a tile


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("width", sorted(SEQS))
def test_fast_check_twin_misses_no_event(where, width, monkeypatch):
    seqs = np.array(SEQS[width], np.uint8)
    k = seqs.shape[1]
    off = {"first": 0, "middle": TILE // 2 - 1, "last": TILE - k}[where]
    buf = np.full((len(seqs), TILE), ord("a"), np.uint8)
    buf[:, off:off + k] = seqs
    x = torch.from_numpy(buf.reshape(-1))
    L = x.numel()
    flags = tc.tile_flags_ref(x, L, TILE)
    monkeypatch.setattr(tc, "TILE", TILE)
    _, key, _ = tc.tile_aggregates_ref(x, L)
    events = key != NO_EVENT
    assert bool(events.any())
    missed = (events & ~flags[: events.numel()]).nonzero().flatten()
    assert missed.numel() == 0, [bytes(seqs[i]).hex() for i in missed[:5].tolist()]


def test_fast_check_twin_passes_valid_text():
    data = ("ab é 東 \U0001f642 Жм ".encode() * 3000)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert not bool(tc.tile_flags_ref(x, len(data), 64).any())


def test_entry_point_signatures_match_the_sources():
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {name for name, _ in entries} == set(_build.SIGNATURES)
    for name, params in entries:
        assert len([p for p in params.split(",") if p.strip()]) == len(_build.SIGNATURES[name]), name
