"""The traffic generators: sizes fixed for every seed, valid text, one
seed one input."""

import base64

import numpy as np
import pytest

from bench_torch import harness

text = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
mime = harness.load_module(harness.HERE / "traffic" / "base64_mime.py",
                           "bench_torch.traffic.base64_mime")
MIXED = harness.load_cell("utf8_to_utf16.mixed_64m").traffic
SMALL_PAGES = dict(MIXED, docs=2, doc_bytes=12 * 1000, page_bytes=1000)


def script_of(page: bytes) -> str | None:
    """The profile whose non-ASCII ranges are just those that a page's code
    points fall in (None if no profile's are)."""
    hit = set()
    for ch in set(page.decode("utf-8")):
        for prof in MIXED["profiles"].values():
            hit |= {(lo, hi) for lo, hi, _ in prof["ranges"] if lo > 0x7F and lo <= ord(ch) <= hi}
    names = [n for n, prof in MIXED["profiles"].items()
             if hit == {(lo, hi) for lo, hi, _ in prof["ranges"] if lo > 0x7F}]
    return names[0] if len(names) == 1 else None


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_text_sizes_and_validity(seed):
    a = text.generate(SMALL_PAGES, seed, "cpu")
    assert a.shape == (2, 12000) and a.dtype == np.uint8
    for row in a:
        s = row.tobytes().decode("utf-8")  # valid, whole code points
        assert not any(0xD800 <= ord(ch) <= 0xDFFF for ch in s)
    assert np.array_equal(a, text.generate(SMALL_PAGES, seed, "cpu"))
    assert not np.array_equal(a, text.generate(SMALL_PAGES, seed + 1, "cpu"))


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_pages_one_script_each(seed):
    """Every page is whole code points in one script; each script has the
    same number of pages for every seed."""
    a = text.generate(SMALL_PAGES, seed, "cpu").reshape(-1, 1000)
    names = [script_of(page.tobytes()) for page in a]
    assert None not in names
    assert sorted(names.count(n) for n in MIXED["profiles"]) == [4] * 6


def test_page_counts():
    assert text.page_counts([1] * 6, 381) == [64, 64, 64, 63, 63, 63]
    assert text.page_counts([3, 1], 10) == [8, 2]
    assert sum(text.page_counts([0.4, 0.35, 0.25], 7)) == 7
    with pytest.raises(ValueError):
        text.generate(dict(SMALL_PAGES, page_bytes=7000), 1, "cpu")


def test_script_mix_in_a_page():
    p = dict(MIXED, docs=1, doc_bytes=400000, page_bytes=400000,
             profiles={"latin": MIXED["profiles"]["latin"]})
    cps = np.array([ord(c) for c in text.generate(p, 3, "cpu")[0].tobytes().decode()])
    assert abs(np.mean((cps >= 0xC0) & (cps <= 0x17F)) - 0.3 / 1.12) < 0.01
    assert abs(np.mean(cps == 0x20) - (0.12 + 0.7 / 95) / 1.12) < 0.01


def test_ascii_profile_is_ascii():
    p = harness.load_cell("utf8_to_utf16.ascii_64m").traffic
    a = text.generate(dict(p, doc_bytes=10000), 9, "cpu")
    assert a.min() >= 0x20 and a.max() <= 0x7E


def test_mime_layout():
    a = mime.generate({"raw_bytes": 3 * 1000, "line": 76}, 4, "cpu")[0].tobytes()
    lines = a.split(b"\r\n")
    assert all(len(x) == 76 for x in lines[:-1]) and 0 < len(lines[-1]) <= 76
    assert len(base64.b64decode(b"".join(lines))) == 3000
    # the cell's size: 48 MiB of bytes -> 68,874,886 chars
    enc = 4 * 50331648 // 3
    assert enc + 2 * ((enc - 1) // 76) == 68874886
