"""Seeded UTF-8 text made of one-script pages, drawn on the device.

Parameters (a workload file):

* ``docs``, ``doc_bytes``: the number of documents and the bytes of each;
* ``page_bytes``: the bytes of a page (default ``doc_bytes``); it divides
  ``doc_bytes``, and a document is its pages one after another;
* ``profiles``: ``{name: {"weight", "spaces", "ranges"}}``, the scripts a
  page may be in. ``ranges`` is ``[[lo, hi, weight], ...]``, code-point
  ranges (none may touch the surrogates U+D800-U+DFFF) and their weights;
  ``spaces`` the share of code points followed by an ASCII space.

Each page is in one profile: code points drawn with its weights, uniformly
inside their range, cut back to whole code points and filled up to
``page_bytes`` with ASCII spaces (at most three). The pages of each profile
are counted from the weights (largest remainder, ties to the profile listed
first), the same for every seed; the seed draws the code points and the
order of the pages. So every seed gives the same sizes and the same mix of
scripts. The draw is done with a ``torch.Generator`` on ``device``: one seed
gives the same text on one kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

_SURROGATES = (0xD800, 0xDFFF)


def _check(ranges) -> None:
    for lo, hi, w in ranges:
        if not (0 <= lo <= hi <= 0x10FFFF and w > 0):
            raise ValueError(f"bad range {lo:#x}-{hi:#x} weight {w}")
        if lo <= _SURROGATES[1] and hi >= _SURROGATES[0]:
            raise ValueError(f"range {lo:#x}-{hi:#x} holds surrogates")


def page_counts(weights: list[float], pages: int) -> list[int]:
    """``pages`` shared out by ``weights``, largest remainder first, ties
    to the earlier weight."""
    total = float(sum(weights))
    exact = [w * pages / total for w in weights]
    counts = [int(x) for x in exact]
    by_rest = sorted(range(len(weights)), key=lambda i: (counts[i] - exact[i], i))
    for i in by_rest[: pages - sum(counts)]:
        counts[i] += 1
    return counts


def encode(cps: torch.Tensor, row_bytes: int) -> torch.Tensor:
    """Rows of code points (-1 for none) -> uint8[rows, row_bytes]: each
    row's UTF-8, the code points that fit whole, then ASCII spaces."""
    rows, k = cps.shape
    dev = cps.device
    nb = ((cps >= 0).to(torch.int32) + (cps >= 0x80).to(torch.int32)
          + (cps >= 0x800).to(torch.int32) + (cps >= 0x10000).to(torch.int32))
    end = torch.cumsum(nb, 1, dtype=torch.int64)
    nb = torch.where(end <= row_bytes, nb, torch.zeros_like(nb))
    start = end - nb + torch.arange(rows, device=dev, dtype=torch.int64).view(-1, 1) * row_bytes
    out = torch.full((rows * row_bytes,), 0x20, dtype=torch.uint8, device=dev)
    lead_bits = torch.tensor([0, 0x00, 0xC0, 0xE0, 0xF0], dtype=torch.int32, device=dev)
    for j in range(4):
        m = nb > j
        c, n, at = cps[m], nb[m], start[m] + j
        if j == 0:
            val = (lead_bits[n] | (c >> (6 * (n - 1)))) & 0xFF
        else:
            val = 0x80 | ((c >> (6 * (n - 1 - j))) & 0x3F)
        out[at] = val.to(torch.uint8)
    return out.view(rows, row_bytes)


def pages(profile: dict, rows: int, row_bytes: int, g: torch.Generator,
          dev: torch.device) -> torch.Tensor:
    """uint8[rows, row_bytes]: pages of one profile."""
    ranges = [tuple(r) for r in profile["ranges"]]
    _check(ranges)
    k = row_bytes  # a code point takes one byte or more: enough draws
    weights = torch.tensor([w for _, _, w in ranges], dtype=torch.float64)
    cuts = (torch.cumsum(weights, 0) / weights.sum())[:-1].to(torch.float32).to(dev)
    which = torch.bucketize(torch.rand((rows, k), generator=g, device=dev), cuts, right=True)
    lo = torch.tensor([r[0] for r in ranges], dtype=torch.int32, device=dev)[which]
    hi = torch.tensor([r[1] for r in ranges], dtype=torch.int32, device=dev)[which]
    span = (hi - lo + 1).to(torch.float32)
    off = (torch.rand((rows, k), generator=g, device=dev) * span).to(torch.int32)
    cps = torch.minimum(lo + off, hi)
    del which, lo, span, off
    spaces = float(profile.get("spaces", 0.0))
    if spaces > 0:
        sp = torch.rand((rows, k), generator=g, device=dev) < spaces
        cps = torch.stack([cps, torch.where(sp, 0x20, -1).to(torch.int32)], 2).view(rows, 2 * k)
    return encode(cps, row_bytes)


def generate(params: dict, seed: int, device) -> np.ndarray:
    """uint8[docs, doc_bytes] on the host; see the module docstring."""
    docs, doc_bytes = int(params["docs"]), int(params["doc_bytes"])
    page_bytes = int(params.get("page_bytes", doc_bytes))
    if doc_bytes % page_bytes:
        raise ValueError(f"page_bytes {page_bytes} does not divide doc_bytes {doc_bytes}")
    n_pages = docs * doc_bytes // page_bytes
    profiles = list(params["profiles"].values())
    counts = page_counts([float(p["weight"]) for p in profiles], n_pages)
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    order = torch.randperm(n_pages, generator=g, device=dev)
    out = torch.empty((n_pages, page_bytes), dtype=torch.uint8, device=dev)
    first = 0
    for profile, n in zip(profiles, counts):
        if n:
            out[order[first:first + n]] = pages(profile, n, page_bytes, g, dev)
        first += n
    return out.view(docs, doc_bytes).cpu().numpy()
