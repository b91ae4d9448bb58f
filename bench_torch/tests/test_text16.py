"""The UTF-16LE text generator: one seed one input, fixed page counts,
pages of whole code points in one script filled with spaces, surrogate
pairs for code points above U+FFFF."""

import numpy as np
import pytest

from bench_torch import harness

text16 = harness.load_module(harness.HERE / "traffic" / "text16.py",
                             "bench_torch.traffic.text16")
CELL = harness.load_cell("utf16_to_utf8.mixed_64m").traffic
SMALL = dict(CELL, docs=2, doc_units=6 * 1500, page_units=1500)


def script_of(page: str) -> str | None:
    """The profile whose non-ASCII ranges are just those that a page's code
    points fall in (None if no profile's are)."""
    hit = set()
    for ch in set(page):
        for prof in CELL["profiles"].values():
            hit |= {(lo, hi) for lo, hi, _ in prof["ranges"] if lo > 0x7F and lo <= ord(ch) <= hi}
    names = [n for n, prof in CELL["profiles"].items()
             if hit == {(lo, hi) for lo, hi, _ in prof["ranges"] if lo > 0x7F}]
    return names[0] if len(names) == 1 else None


def test_cell_sizes():
    assert CELL["doc_units"] == 381 * CELL["page_units"] == 33552384
    assert CELL["page_units"] == 43 * 2048
    assert 2 * CELL["doc_units"] == 64 * 2**20 - 4096


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_one_seed_one_input(seed):
    a = text16.generate(SMALL, seed, "cpu")
    assert a.shape == (2, 2 * 6 * 1500) and a.dtype == np.uint8
    assert np.array_equal(a, text16.generate(SMALL, seed, "cpu"))
    assert not np.array_equal(a, text16.generate(SMALL, seed + 1, "cpu"))


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_pages_one_script_each(seed):
    """Every page decodes alone (whole code points, no surrogate) and is
    in one script; each script has the same number of pages for every
    seed."""
    pages = text16.generate(SMALL, seed, "cpu").reshape(-1, 2 * 1500)
    texts = [p.tobytes().decode("utf-16-le") for p in pages]
    assert all(len(t) == 1500 for t in texts)
    names = [script_of(t) for t in texts]
    assert None not in names
    assert sorted(names.count(n) for n in CELL["profiles"]) == [2] * 6
    with pytest.raises(ValueError):
        text16.generate(dict(SMALL, page_units=7000), 1, "cpu")


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_astral_range_gives_pairs(seed):
    """Code points above U+FFFF become surrogate pairs; a page holds those
    that fit whole and then spaces."""
    p = {"docs": 1, "doc_units": 4 * 1001, "page_units": 1001,
         "profiles": {"emoji": {"weight": 1, "spaces": 0.2,
                                "ranges": [[0x1F300, 0x1F64F, 0.5], [0x61, 0x7A, 0.5]]}}}
    pages = text16.generate(p, seed, "cpu").reshape(4, -1)
    astral = 0
    for page in pages:
        s = page.tobytes().decode("utf-16-le")
        assert all(0x1F300 <= ord(c) <= 0x1F64F or 0x61 <= ord(c) <= 0x7A or c == " "
                   for c in s)
        astral += sum(ord(c) > 0xFFFF for c in s)
        assert len(s) + sum(ord(c) > 0xFFFF for c in s) == 1001
    assert astral > 500


def test_script_mix_in_a_page():
    p = {"docs": 1, "doc_units": 200000, "profiles": {"latin": CELL["profiles"]["latin"]}}
    s = text16.generate(p, 3, "cpu")[0].tobytes().decode("utf-16-le")
    cps = np.array([ord(c) for c in s])
    assert abs(np.mean((cps >= 0xC0) & (cps <= 0x17F)) - 0.3 / 1.12) < 0.01
    assert abs(np.mean(cps == 0x20) - (0.12 + 0.7 / 95) / 1.12) < 0.01
