"""Seeded UTF-16LE text made of one-script pages, drawn on the device.

Parameters (a workload file):

* ``docs``, ``doc_units``: the number of documents and the units of each;
* ``page_units``: the units of a page (default ``doc_units``); it divides
  ``doc_units``, and a document is its pages one after another;
* ``profiles``: as for ``text.py`` (``{name: {"weight", "spaces",
  "ranges"}}``); a range may lie above U+FFFF, and its code points then
  take a surrogate pair each.

The draw is ``text.py``'s, in units: the pages of each profile are counted
from the weights by its ``page_counts``, the same for every seed; the seed
draws the order of the pages and, with a ``torch.Generator`` on
``device``, each page's code points, which are cut back to those that fit
whole in ``page_units`` and followed by ASCII spaces. One seed gives the
same text on one kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.traffic.text import _check, page_counts


def encode(cps: torch.Tensor, row_units: int) -> torch.Tensor:
    """Rows of code points (-1 for none) -> int32[rows, row_units] of
    UTF-16 unit values: each row's code points that fit whole, then ASCII
    spaces."""
    rows, _ = cps.shape
    dev = cps.device
    nu = (cps >= 0).to(torch.int32) + (cps >= 0x10000).to(torch.int32)
    end = torch.cumsum(nu, 1, dtype=torch.int64)
    nu = torch.where(end <= row_units, nu, torch.zeros_like(nu))
    start = end - nu + torch.arange(rows, device=dev, dtype=torch.int64).view(-1, 1) * row_units
    out = torch.full((rows * row_units,), 0x20, dtype=torch.int32, device=dev)
    one = nu == 1
    out[start[one]] = cps[one]
    two = nu == 2
    v = cps[two] - 0x10000
    out[start[two]] = 0xD800 | (v >> 10)
    out[start[two] + 1] = 0xDC00 | (v & 0x3FF)
    return out.view(rows, row_units)


def codepoints(profile: dict, rows: int, k: int, g: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    """int32[rows, k or 2k]: ``k`` code points a row drawn from one
    profile, each followed by a space (or -1, none) where it has
    ``spaces``."""
    ranges = [tuple(r) for r in profile["ranges"]]
    _check(ranges)
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
    return cps


def generate(params: dict, seed: int, device) -> np.ndarray:
    """uint8[docs, 2 * doc_units] of UTF-16LE on the host; see the module
    docstring."""
    docs, doc_units = int(params["docs"]), int(params["doc_units"])
    page_units = int(params.get("page_units", doc_units))
    if doc_units % page_units:
        raise ValueError(f"page_units {page_units} does not divide doc_units {doc_units}")
    n_pages = docs * doc_units // page_units
    profiles = list(params["profiles"].values())
    counts = page_counts([float(p["weight"]) for p in profiles], n_pages)
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    order = torch.randperm(n_pages, generator=g, device=dev)
    out = torch.empty((n_pages, page_units), dtype=torch.int32, device=dev)
    first = 0
    for profile, n in zip(profiles, counts):
        if n:
            # a code point takes one unit or two: page_units draws fill a page
            out[order[first:first + n]] = encode(
                codepoints(profile, n, page_units, g, dev), page_units)
        first += n
    units = out.view(-1).to(torch.int16).view(torch.uint16).cpu().numpy()
    return units.astype("<u2").view(np.uint8).reshape(docs, 2 * doc_units)
