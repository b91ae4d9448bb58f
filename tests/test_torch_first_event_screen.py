"""The first-event kernel's SWAR screen (csrc/validate.cu ``screen``) on
the CPU, through its plain twin ``kernels/validate.screen_flags_ref``,
which computes the same word operations: it must flag every byte on which
the event lattice reports an event, and, for the kernel to run the lattice
on no chunk of valid text, nothing else. The lattice's per-byte events are
read from ``ops/utf8.classify`` as ``_first_error_from`` reads them."""

import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402
from simdutf_tpu_torch.kernels import validate as kv  # noqa: E402
from simdutf_tpu_torch.ops import utf8 as o8  # noqa: E402
from simdutf_tpu_torch.ops.common import BIG, positions, shift_right  # noqa: E402

text = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
PROFILES = harness.load_cell("validate_utf8.mixed_64m").traffic["profiles"]
EMOJI = {"weight": 1, "spaces": 0.12,
         "ranges": [[32, 126, 0.3], [0x1F300, 0x1F64F, 0.5], [0x10000, 0x10FFFF, 0.2]]}
FILL = 0x61  # 'a': covers nothing and is covered by nothing


def _events(b: torch.Tensor, length: int) -> torch.Tensor:
    """bool[n]: the bytes on which su::event_key reports an event, from
    classify's fields: a lead with an error of its own, and a continuation
    that no lead among the three bytes before it covers."""
    cls = o8.classify(b, length)
    in_range = positions(b.shape[0], b.device) < length
    seqlen = cls["seqlen"]
    covered = (shift_right(seqlen > 1, 1) | shift_right(seqlen > 2, 2)
               | shift_right(seqlen > 3, 3))
    return ((cls["lead"] & (cls["err"] != 0)) | (cls["is_cont"] & ~covered)) & in_range


def _check(b: torch.Tensor, length: int) -> torch.Tensor:
    """Assert the screen's flags against the lattice's events; returns
    the flags."""
    flags = kv.screen_flags_ref(b, length)
    cls = o8.classify(b, length)
    n = b.shape[0]
    idx = positions(n, b.device)
    lead = cls["lead"] & (idx < length)
    # _first_error_from's three kinds of event: every lead error is flagged
    # on its own byte ...
    assert not (lead & (cls["err"] != 0) & ~flags).any()
    # ... as is a leading continuation ...
    if length and n:
        assert bool(flags[0]) == bool(cls["is_cont"][0])
    # ... and a continuation left after a valid sequence is flagged, or a
    # lead among the three bytes before it that it cuts short is
    seqlen = cls["seqlen"]
    gap = (((seqlen == 1) & cls["c1"]) | ((seqlen == 2) & cls["c2"])
           | ((seqlen == 3) & cls["c3"]) | ((seqlen == 4) & o8.shift_left(cls["is_cont"], 4)))
    after = (idx + seqlen)[lead & (cls["err"] == 0) & gap]
    near = flags | shift_right(flags, 1) | shift_right(flags, 2) | shift_right(flags, 3)
    assert near[after].all()
    # the screen flags exactly the lattice's events, each on its own byte
    assert torch.equal(flags, _events(b, length))
    # so the first flagged byte is the first error
    first = int(torch.nonzero(flags)[0]) if flags.any() else BIG
    assert first == int(o8._first_error_from(cls, length)[0])
    return flags


def _slots(rows: np.ndarray, width: int, at: int) -> torch.Tensor:
    """uint8: each row of ``rows`` at byte ``at`` of a slot of ``width``
    bytes of FILL, the slots end to end."""
    out = np.full((rows.shape[0], width), FILL, np.uint8)
    out[:, at:at + rows.shape[1]] = rows
    return torch.from_numpy(out.reshape(-1))


@pytest.mark.parametrize("at", [15, 12, 13, 14])
def test_every_byte_pair(at):
    """All 65,536 byte pairs, the first at byte ``at`` of a 32-byte slot:
    at 15 across a 16-byte boundary, at 12-14 at each other place in a
    word; every pair before the length."""
    pairs = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    b = _slots(pairs.reshape(-1, 2).astype(np.uint8), 32, at)
    flags = _check(b, b.shape[0])
    assert flags.any()


@pytest.mark.parametrize("draw", range(4))
def test_every_lead_with_every_second_byte(draw):
    """Every byte as a lead, with every second byte, and a third and
    fourth byte drawn from a seeded set of boundary values; the slots are
    21 bytes wide, so the sequences fall at every place of a word and of
    a 16-byte chunk."""
    rng = random.Random(2500 + draw)
    edges = [0x00, 0x41, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xC2,
             0xE0, 0xED, 0xF0, 0xF4, 0xFF]
    third, fourth = rng.choice(edges), rng.choice(edges)
    rows = np.zeros((256, 256, 4), np.uint8)
    rows[..., 0] = np.arange(256)[:, None]
    rows[..., 1] = np.arange(256)[None, :]
    rows[..., 2], rows[..., 3] = third, fourth
    b = _slots(rows.reshape(-1, 4), 21, 8)
    _check(b, b.shape[0])


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_sequences_cut_at_the_length(cut):
    """Every lead's longest valid form, cut ``cut`` bytes in by the
    length, with garbage past it: the zero tail makes the lead short."""
    leads = np.arange(0xC0, 0x100, dtype=np.uint8)
    for k, x in enumerate(leads):
        data = bytes([FILL] * (5 + k % 11)) + bytes([x, 0x90, 0x90, 0x90])
        length = len(data) - 4 + cut
        b = torch.from_numpy(np.frombuffer(data + b"\x80\xbf\x41", np.uint8).copy())
        flags = _check(b, length)
        assert not flags[length:].any()


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_high_byte_heavy(seed):
    """Seeded buffers drawn mostly from continuation and lead bytes, with
    valid sequences among them, at a seeded length below the buffer's."""
    rng = np.random.default_rng(2510 + seed)
    n = 1 << 16
    groups = [np.arange(0x80, 0xC0), np.arange(0xC0, 0xE0), np.arange(0xE0, 0xF0),
              np.arange(0xF0, 0x100), np.array([0x41, 0x20])]
    which = rng.choice(len(groups), n, p=[0.4, 0.15, 0.15, 0.1, 0.2])
    raw = np.array([g[rng.integers(len(g), size=n)] for g in groups])[which, np.arange(n)]
    valid = np.frombuffer("é東🙂Ж\U0010ffffࠀ퟿".encode("utf-8", "surrogatepass"),
                          np.uint8)
    for p in rng.integers(0, n - len(valid), 300):
        raw[p:p + len(valid)] = valid
    b = torch.from_numpy(raw.astype(np.uint8))
    _check(b, n - int(rng.integers(0, 8)))


@pytest.mark.parametrize("name", [*PROFILES, "emoji"])
def test_valid_text_flags_nothing(name):
    """Pages of each of the cell's six scripts, and of emoji and other
    4-byte characters: no byte is flagged; one bad byte planted at a
    character start is flagged on its own, as the lattice reports it."""
    profile = EMOJI if name == "emoji" else PROFILES[name]
    g = torch.Generator().manual_seed(2520)
    b = text.pages(profile, 4, 8192, g, torch.device("cpu")).reshape(-1).clone()
    assert not kv.screen_flags_ref(b, b.shape[0]).any()
    assert kv.exact_chunks_ref(b, b.shape[0]) == 0
    k = b.shape[0] // 2 + 5
    while int(b[k]) & 0xC0 == 0x80:
        k -= 1
    b[k] = 0xFF
    flags = _check(b, b.shape[0])
    assert int(torch.nonzero(flags)[0]) == k
