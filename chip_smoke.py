#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (simdutf_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --fixed-rate-times [--root DIR]
                                 # only the fixed-rate kernels' and casts'
                                 # times (events and device rows), of the
                                 # package in DIR: run a parent tree and
                                 # this one in turns to compare them
    python3 chip_smoke.py --compact-times [--root DIR]
                                 # the same for compose16, compose32,
                                 # b64_compact and their routed calls
    python3 chip_smoke.py --census-times [--root DIR]
                                 # the same for census_utf8 on 64 MiB of
                                 # ASCII, mixed, é, 東 and 🙂 text
    python3 chip_smoke.py --first-event-times [--against DIR]
                                 # utf8_first_event alone by events on six
                                 # inputs: this tree's csrc/validate.cu,
                                 # and DIR's in turns in the same process

Nine paths, each driven through the port's own api
(``simdutf_tpu_torch.api`` on "cuda"): UTF-8 -> UTF-16LE/BE with UTF-8
validation and counts, UTF-16LE/BE -> UTF-8 with UTF-16 validation and
counts, forgiving base64 decode and encode, UTF-8 <-> UTF-32 with UTF-32
validation and lengths, the rest of the transcode matrix (UTF-16LE/BE
<-> UTF-32, Latin-1 <-> UTF-8/16/32), the utilities (ASCII
validation, the UTF-16 utilities, encoding detection, trim_partial, the
valid-only converters on invalid input, the capacity-limited base64
decode), the fixed-rate class branches of UTF-8 <-> UTF-16 (whole
ASCII, uniform 2- and 3-byte input, and 4-byte UTF-8 -> UTF-16; Latin-1
-> UTF-16), and those into and out of UTF-32 (UTF-8 <-> UTF-32,
UTF-16LE/BE <-> UTF-32 of BMP and astral text, Latin-1 -> UTF-32), and
the ``pallas`` tier's own paths on ``TorchPallasImplementation`` (SWAR
validation with a host rewind, ASCII copy to Latin-1, the clean base64
decode, its internal_tests).
Nothing of the JAX package or of jax is imported. Every path runs at its full depth: the whole run takes a
few minutes of the 20-minute limit. Phases, each fatal on failure:
  1. device  - name, compute capability (must be 9.0), nvidia-smi power limit;
  2. build   - nvcc builds csrc/*.cu (one process per source) into one library;
  3. parity  - every Hopper kernel against its plain torch version on the
               card, bit for bit. UTF-8: each class, errors at tile edges,
               at 0, at length-1 and at length, ragged lengths, LE and BE
               output. UTF-16 (LE and BE input): each class, lone
               surrogates at 0, at tile edges and at length-1, a high
               surrogate at length-1 whose low is stored at length, pairs
               straddling tile edges. Small buffers, garbage past the
               length, and the 64 MiB corpus with and without an error;
  4. slice   - the api on the 64 MiB mixed corpus (bench.mixed_corpus) and
               on its UTF-16LE/BE encoding, against CPython's codecs, with
               an error injected where a code point starts (so its code and
               position are known), plus the uniform classes and the zh
               profile; every kernel of a path must have launched during
               that path's calls (counts reset just before, read just
               after);
     parity64 and slice64 do the same for base64: each base64 kernel
               against its plain version (uint8 and char16 chars, the three
               alphabet modes, invalid chars at 0, at tile edges, at
               length-1 and at length, all-whitespace tiles, garbage past
               the length, length == N, the MIME corpus with and without an
               invalid char), then the base64 api on the MIME corpus
               (bench.py's: the base64 of 48 MiB of the mixed corpus, CRLF
               every 76 chars) and its char16 form, against the raw bytes
               and CPython's base64;
     parity32 and slice32 do the same for UTF-32: the UTF-32 kernels on
               each class, on words above 0x10FFFF, surrogates and words
               with the top bit set at 0, at tile edges, at length-1 and at
               length, garbage past the length and the full corpus with and
               without an error; compose32 on the UTF-8 parity inputs; then
               the api on the 64 MiB corpus and on its UTF-32LE form
               against codecs ``utf-32-le``;
     parityx and slicex do the same for the butterflyx kernels of the
               last directions: UTF-16 -> UTF-32 on the UTF-16 parity
               inputs and UTF-32 -> UTF-16 on the UTF-32 ones (LE and BE),
               Latin-1 -> UTF-8 on every byte value, high bytes at the tile
               edges and a 64 MiB Latin-1 buffer (70% 0x20-0x7E, 30%
               0xC0-0xFF, from the seed); then the api on the corpus as
               UTF-16LE/BE and UTF-32LE, on the Latin-1 buffer and on its
               UTF-8/16/32 encodings, against CPython's codecs, with a lone
               surrogate, a 0x110000 word and a 3-byte character injected
               at known positions;
     parityu and sliceu do the same for the utilities: ascii_first_bad,
               utf16_to_well_formed and detect_encodings, compose16 without
               its clamp and compose8's valid-only mode, on the UTF-8,
               UTF-16 and UTF-32 parity inputs (the valid-only converters'
               invalid edges among them); then the api on the corpus: ASCII
               validation (and on a 64 MiB ASCII buffer), to_well_formed on
               its UTF-16 units with lone surrogates injected, detection and
               autodetection of its UTF-8, UTF-16LE and UTF-32LE forms with
               and without a BOM, trim_partial, the endianness swap, the
               valid-only converters, and the safe base64 decode of the
               MIME corpus, against numpy and CPython's codecs and base64;
     paritytr and slicetr do the same for the fixed-rate kernels: the
               four UTF-8 -> UTF-16 kernels on every UTF-8 parity input, the
               three UTF-16 -> UTF-8 kernels on every UTF-16 one (LE and BE),
               and class text with out-of-class elements at the thread and
               block steps, output and flag; a census-admitted class must
               leave its flag clear; then the api on the 64 MiB ASCII, é, 東
               and 🙂 corpora, UTF-8 -> UTF-16LE/BE and back, validating and
               valid-only, and Latin-1 -> UTF-16LE/BE, against codecs, each
               call launching exactly its census and its kernel (🙂 back to
               UTF-8 only its census: that branch has no kernel);
     paritytr32 and slicetr32 do the same for the eleven UTF-32
               fixed-rate kernels: the UTF-8 -> UTF-32 ones on every UTF-8
               parity input, the UTF-32 -> UTF-8/16 ones on every UTF-32 one
               (LE and BE output), the UTF-16 -> UTF-32 ones on every UTF-16
               one (LE and BE), and class text with out-of-class elements at
               the thread and block steps; then the api on the 64 MiB ASCII,
               é, 東 and 🙂 corpora, UTF-8 -> UTF-32 -> UTF-8 and UTF-16LE/BE
               <-> UTF-32, and Latin-1 -> UTF-32, against codecs, each call
               launching exactly its census and its kernel (ASCII back to
               UTF-8 only its census);
     parityp and slicep do the same for the pallas tier: the three SWAR
               scans on every UTF-8 and UTF-16 parity input (LE and BE),
               errors at their word, thread and block steps, cut sequences
               and stale bytes past the length, a 64 MiB ASCII buffer;
               clean_decode on the whitespace-free base64 of the corpus's
               first 3/4 (three alphabets, a '=' and a ' ' injected);
               row_compact at (131072, 128) and (8192, 1024); the probe;
               then the api through use_device(TorchPallasImplementation):
               UTF-8, ASCII and UTF-16LE/BE validation, clean and with an
               error, UTF-8 -> Latin-1 of ASCII, base64 of the clean and
               the MIME corpus, internal_tests, against TorchImplementation
               and CPython, each validation launching exactly its SWAR scan
               and never the safety net, the clean decode exactly
               clean_decode;
  5. times   - device-resident kernels and the routed calls against their
               plain versions, with CUDA events, the device-to-device copy
               rate, the library yardsticks where one PyTorch call computes
               the same function (a call that computes another, such as a
               yes/no for a position, is logged as a note), the device rows
               of #24, #26, their flag fill and their casts, the launch
               plans of widen32 and narrow3 (#23), and a torch.profiler
               breakdown of each routed call.

Before the last line it prints one JSON object with every kernel (launches
on its path, largest error against its plain version, ms, ``device_us``
where a phase read its device row, plain ms,
``library_ms`` or null, and ``bound_ms``: the bytes it must move over the
card's published 3.35 TB/s; ``copy_bound_ms`` the same bytes at the
measured copy rate) and the card's
nvidia-smi name and power limit. The last line of stdout is
{"ok": true, "device": {...}}; it is printed only when every phase passed.
Without CUDA, or without the rest of the repo beside it, the script exits
with code 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

MIB = 1 << 20
CORPUS_BYTES = 64 * MIB - 4096  # bench.py's flagship size (bucket = 64 MiB)
SEED = 20261016
#: the kernels of each path, named by their C entry point; a kernel that
#: launches more than one, or one of another name, is named by its key in
#: ENTRIES
PASSES = ("census_utf8", "utf8_first_event", "utf8_count", "compose16")
PASSES16 = ("census_utf16", "utf16_first_bad", "utf16_count",
            "utf16_to_utf8_compose")
PASSES64 = ("b64_compact8", "b64_pack", "b64_encode")
PASSES32 = ("utf32_first_bad", "utf32_count", "compose32",
            "utf32_to_utf8_compose")
PASSESX = ("utf16_to_utf32_compose", "utf32_to_utf16_compose",
           "latin1_to_utf8_compose")
PASSESU = ("ascii_first_bad", "utf16_to_well_formed", "detect_encodings")
#: the fixed-rate class kernels, (name, class char) in the census's class
#: order: UTF-8 -> UTF-16, then UTF-16 -> UTF-8
FIXED8 = (("ascii_widen_utf16", "a"), ("uniform2_utf8_to_utf16", "é"),
          ("uniform3_utf8_to_utf16", "東"), ("astral_utf8_to_utf16", "\U0001f642"))
FIXED16 = (("ascii_narrow_utf8", "a"), ("uniform2_utf16_to_utf8", "é"),
           ("uniform3_utf16_to_utf8", "東"))
PASSEST = tuple(k for k, _ in FIXED8 + FIXED16)
#: the UTF-32 fixed-rate class kernels, (name, class char) by direction:
#: UTF-8 -> UTF-32 (the ASCII class through the Latin-1 widen), UTF-32 ->
#: UTF-8 (no ASCII kernel), UTF-16 -> UTF-32, UTF-32 -> UTF-16
FIXED8TO32 = (("latin1_widen_utf32", "a"), ("uniform2_utf8_to_utf32", "é"),
              ("uniform3_utf8_to_utf32", "東"), ("astral_utf8_to_utf32", "\U0001f642"))
FIXED32TO8 = (("uniform2_utf32_to_utf8", "é"), ("uniform3_utf32_to_utf8", "東"),
              ("astral_utf32_to_utf8", "\U0001f642"))
FIXED16TO32 = (("bmp_widen_utf32", "東"), ("astral_utf16_to_utf32", "\U0001f642"))
FIXED32TO16 = (("bmp_narrow_utf16", "東"), ("astral_utf32_to_utf16", "\U0001f642"))
PASSEST32 = tuple(k for k, _ in FIXED8TO32 + FIXED32TO8 + FIXED16TO32 + FIXED32TO16)
#: the kernels of the pallas tier's own paths (kernels/impl.TorchPallasImplementation)
PASSESP = ("utf8_swar_first_bad_word", "ascii_swar_first_bad_word",
           "utf16_swar_first_bad_word", "clean_decode", "row_compact",
           "lane_shapecast_probe")
#: the C entry points of each kernel named otherwise
ENTRIES = {"utf16_to_utf8_compose": ("compose8",),
           "utf32_to_utf8_compose": ("composex_count", "composex_emit"),
           "utf16_to_utf32_compose": ("u16_to_u32_count", "u16_to_u32_emit"),
           "utf32_to_utf16_compose": ("u32_to_u16_count", "u32_to_u16_emit"),
           "latin1_to_utf8_compose": ("latin1_utf8_count", "latin1_utf8_emit")}
KERNELS = {  # name -> (source, Pallas kernel replaced, also replaced)
    "census_utf8": ("simdutf_tpu_torch/csrc/census.cu",
                    "simdutf_tpu/kernels/census.py:204", []),
    "utf8_first_event": ("simdutf_tpu_torch/csrc/validate.cu",
                         "simdutf_tpu/kernels/validate.py:415",
                         ["simdutf_tpu/kernels/validate.py:438"]),
    "utf8_count": ("simdutf_tpu_torch/csrc/validate.cu",
                   "simdutf_tpu/kernels/validate.py:471", []),
    "compose16": ("simdutf_tpu_torch/csrc/compose16.cu",
                  "simdutf_tpu/kernels/butterfly.py:554",
                  ["simdutf_tpu/kernels/butterfly.py:691"]),
    "census_utf16": ("simdutf_tpu_torch/csrc/census16.cu",
                     "simdutf_tpu/kernels/census.py:354", []),
    "utf16_first_bad": ("simdutf_tpu_torch/csrc/utf16.cu",
                        "simdutf_tpu/kernels/utf16_kernels.py:143", []),
    "utf16_count": ("simdutf_tpu_torch/csrc/utf16.cu",
                    "simdutf_tpu/kernels/utf16_kernels.py:170", []),
    "utf16_to_utf8_compose": ("simdutf_tpu_torch/csrc/compose8.cu",
                              "simdutf_tpu/kernels/butterfly16.py:221",
                              ["simdutf_tpu/kernels/butterfly16.py:335"]),
    "b64_compact8": ("simdutf_tpu_torch/csrc/base64.cu",
                     "simdutf_tpu/kernels/butterfly64.py:160",
                     ["simdutf_tpu/kernels/butterfly64.py:222",
                      "simdutf_tpu/kernels/butterfly16.py:335"]),
    "b64_pack": ("simdutf_tpu_torch/csrc/base64.cu",
                 "simdutf_tpu/kernels/base64_kernel.py:189",
                 ["simdutf_tpu/kernels/base64_kernel.py:308"]),
    "b64_encode": ("simdutf_tpu_torch/csrc/base64.cu",
                   "simdutf_tpu/kernels/base64_kernel.py:414", []),
    "utf32_first_bad": ("simdutf_tpu_torch/csrc/utf32.cu",
                        "simdutf_tpu/kernels/validate.py:551", []),
    "utf32_count": ("simdutf_tpu_torch/csrc/utf32.cu",
                    "simdutf_tpu/kernels/validate.py:570", []),
    "compose32": ("simdutf_tpu_torch/csrc/compose32.cu",
                  "simdutf_tpu/kernels/butterfly32.py:187",
                  ["simdutf_tpu/kernels/butterfly32.py:267"]),
    "utf32_to_utf8_compose": ("simdutf_tpu_torch/csrc/composex.cu",
                              "simdutf_tpu/kernels/butterflyx.py:122",
                              ["simdutf_tpu/kernels/butterfly16.py:335"]),
    "utf16_to_utf32_compose": ("simdutf_tpu_torch/csrc/composex16.cu",
                               "simdutf_tpu/kernels/butterflyx.py:122",
                               ["simdutf_tpu/kernels/butterfly32.py:267"]),
    "utf32_to_utf16_compose": ("simdutf_tpu_torch/csrc/composex.cu",
                               "simdutf_tpu/kernels/butterflyx.py:122",
                               ["simdutf_tpu/kernels/butterflyx.py:318"]),
    "latin1_to_utf8_compose": ("simdutf_tpu_torch/csrc/composex.cu",
                               "simdutf_tpu/kernels/butterflyx.py:122",
                               ["simdutf_tpu/kernels/butterfly16.py:335"]),
    "ascii_first_bad": ("simdutf_tpu_torch/csrc/validate.cu",
                        "simdutf_tpu/kernels/validate.py:457", []),
    "utf16_to_well_formed": ("simdutf_tpu_torch/csrc/utf16.cu",
                             "simdutf_tpu/kernels/utf16_kernels.py:157", []),
    "detect_encodings": ("simdutf_tpu_torch/csrc/detect.cu",
                         "simdutf_tpu/kernels/detect_kernel.py:99", []),
    "ascii_widen_utf16": ("simdutf_tpu_torch/csrc/transcode.cu",
                          "simdutf_tpu/kernels/transcode.py:82", []),
    "uniform2_utf8_to_utf16": ("simdutf_tpu_torch/csrc/transcode.cu",
                               "simdutf_tpu/kernels/transcode.py:211", []),
    "uniform3_utf8_to_utf16": ("simdutf_tpu_torch/csrc/transcode.cu",
                               "simdutf_tpu/kernels/transcode.py:312", []),
    "astral_utf8_to_utf16": ("simdutf_tpu_torch/csrc/transcode.cu",
                             "simdutf_tpu/kernels/transcode.py:1127", []),
    "ascii_narrow_utf8": ("simdutf_tpu_torch/csrc/transcode.cu",
                          "simdutf_tpu/kernels/transcode.py:133", []),
    "uniform2_utf16_to_utf8": ("simdutf_tpu_torch/csrc/transcode.cu",
                               "simdutf_tpu/kernels/transcode.py:385", []),
    "uniform3_utf16_to_utf8": ("simdutf_tpu_torch/csrc/transcode.cu",
                               "simdutf_tpu/kernels/transcode.py:472", []),
    "latin1_widen_utf32": ("simdutf_tpu_torch/csrc/transcode32.cu",
                           "simdutf_tpu/kernels/transcode.py:527", []),
    "uniform2_utf8_to_utf32": ("simdutf_tpu_torch/csrc/transcode32.cu",
                               "simdutf_tpu/kernels/transcode.py:815", []),
    "uniform3_utf8_to_utf32": ("simdutf_tpu_torch/csrc/transcode32.cu",
                               "simdutf_tpu/kernels/transcode.py:937", []),
    "astral_utf8_to_utf32": ("simdutf_tpu_torch/csrc/transcode32.cu",
                             "simdutf_tpu/kernels/transcode.py:1127", []),
    "uniform2_utf32_to_utf8": ("simdutf_tpu_torch/csrc/transcode32.cu",
                               "simdutf_tpu/kernels/transcode.py:883", []),
    "uniform3_utf32_to_utf8": ("simdutf_tpu_torch/csrc/transcode32.cu",
                               "simdutf_tpu/kernels/transcode.py:1005", []),
    "astral_utf32_to_utf8": ("simdutf_tpu_torch/csrc/transcode32.cu",
                             "simdutf_tpu/kernels/transcode.py:1127", []),
    "bmp_widen_utf32": ("simdutf_tpu_torch/csrc/transcode32.cu",
                        "simdutf_tpu/kernels/transcode.py:632",
                        ["simdutf_tpu/kernels/transcode.py:612"]),
    "astral_utf16_to_utf32": ("simdutf_tpu_torch/csrc/transcode32.cu",
                              "simdutf_tpu/kernels/transcode.py:1127", []),
    "bmp_narrow_utf16": ("simdutf_tpu_torch/csrc/transcode32.cu",
                         "simdutf_tpu/kernels/transcode.py:746",
                         ["simdutf_tpu/kernels/transcode.py:726"]),
    "astral_utf32_to_utf16": ("simdutf_tpu_torch/csrc/transcode32.cu",
                              "simdutf_tpu/kernels/transcode.py:1127", []),
    "utf8_swar_first_bad_word": ("simdutf_tpu_torch/csrc/swar.cu",
                                 "simdutf_tpu/kernels/swar.py:156", []),
    "ascii_swar_first_bad_word": ("simdutf_tpu_torch/csrc/swar.cu",
                                  "simdutf_tpu/kernels/swar.py:198", []),
    "utf16_swar_first_bad_word": ("simdutf_tpu_torch/csrc/swar.cu",
                                  "simdutf_tpu/kernels/swar.py:313", []),
    "clean_decode": ("simdutf_tpu_torch/csrc/base64.cu",
                     "simdutf_tpu/kernels/base64_kernel.py:126", []),
    "row_compact": ("simdutf_tpu_torch/csrc/compaction.cu",
                    "simdutf_tpu/kernels/compaction.py:100", []),
    "lane_shapecast_probe": ("simdutf_tpu_torch/csrc/probe.cu",
                             "simdutf_tpu/kernels/validate.py:209", []),
}
#: headers a kernel's source includes that hold part of its design: the
#: single-pass look-back scan that compose16, compose32, compose8 and
#: b64_compact share, the tile pieces of the two UTF-8 look-back kernels (the fast
#: check, the window, the exact triple, the decode), and the bulk-copy
#: tile ring of the three tiled fixed-rate kernels
_UTF8_LOOKBACK = ["simdutf_tpu_torch/csrc/utf8_tile.cuh", "simdutf_tpu_torch/csrc/lookback.cuh",
                  "simdutf_tpu_torch/csrc/utf8.cuh"]
HEADERS = {"compose16": _UTF8_LOOKBACK,
           "compose32": _UTF8_LOOKBACK,
           "b64_compact8": ["simdutf_tpu_torch/csrc/lookback.cuh"],
           "utf16_to_utf8_compose": ["simdutf_tpu_torch/csrc/lookback.cuh",
                                     "simdutf_tpu_torch/csrc/utf16.cuh"],
           "uniform3_utf16_to_utf8": ["simdutf_tpu_torch/csrc/bulk.cuh"],
           "latin1_widen_utf32": ["simdutf_tpu_torch/csrc/bulk.cuh"],
           "bmp_widen_utf32": ["simdutf_tpu_torch/csrc/bulk.cuh"]}
#: HBM rate of one H100 SXM (NVIDIA's data sheet, at the 700 W limit): the
#: bound of these kernels, which all stream their bytes
PEAK_BYTES_PER_S = 3.35e12
#: device µs per call of a kernel's own row (torch.profiler), where a phase
#: measured it; the kernels' JSON line carries it beside the event ms
DEVICE_US: dict = {}
MODES64 = ((False, False), (True, False), (False, True))  # (url, both)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def counted(call):
    """(``call()``, the port's launches during it by C entry point), from
    the port's own counter (``simdutf_tpu_torch.trace``), which counts
    while a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    from simdutf_tpu_torch import trace

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = call()
    return got, trace.snapshot()["launches"]


def kernel_launches(launches: dict, k: str) -> int:
    """Launches of kernel ``k`` (its C entry points, ENTRIES) in
    ``launches``, a count by C entry point."""
    return sum(launches.get(e, 0) for e in ENTRIES.get(k, (k,)))


def log(*a) -> None:
    print(*a, flush=True)


# --- inputs ----------------------------------------------------------------

_ALPHABET = ["a", " ", "é", "ß", "Ж", "م", "東", "京", "\U0001f642", "𝄞"]
_BAD = [b"\x80", b"\xbf", b"\xff", b"\xf8", b"\xc0\xaf", b"\xc1\xbf",
        b"\xe0\x80\x80", b"\xed\xa0\x80", b"\xe6\x9d", b"\xf4\x90\x80\x80",
        b"\xf0\x8f\xbf\xbf", b"\xf0\x9f", b"\xc3"]


def utf8_from_codepoints(cps):
    """Vectorised UTF-8 encoding of a numpy array of scalar values."""
    import numpy as np

    cps = np.asarray(cps, np.int64)
    nb = 1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
    start = np.cumsum(nb) - nb
    out = np.zeros(int(nb.sum()), np.uint8)
    lead_bits = np.array([0, 0x00, 0xC0, 0xE0, 0xF0])
    shift = 6 * (nb - 1)
    out[start] = (lead_bits[nb] | (cps >> shift)).astype(np.uint8) & 0xFF
    for k in (1, 2, 3):
        m = nb > k
        out[start[m] + k] = 0x80 | ((cps[m] >> (6 * (nb[m] - 1 - k))) & 0x3F)
    return out.tobytes()


def profile_corpus(profile, nbytes: int, seed: int) -> bytes:
    """Text drawn from a tools/gen_corpus profile with numpy: code points
    from the weighted ranges (surrogates skipped), ASCII spaces after 12%
    of them when the profile mixes ranges, cut to whole code points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = nbytes  # at least one byte per code point: enough draws
    weights = np.array([w for _, w in profile], float)
    which = rng.choice(len(profile), size=k, p=weights / weights.sum())
    lo = np.array([r[0] for r, _ in profile])[which]
    hi = np.array([r[1] for r, _ in profile])[which]
    cps = lo + (rng.random(k) * (hi - lo + 1)).astype(np.int64)
    cps = cps[(cps < 0xD800) | (cps > 0xDFFF)]
    if len(profile) > 1:
        space = rng.random(len(cps)) < 0.12
        cps = np.stack([cps, np.where(space, 0x20, -1)], 1).reshape(-1)
        cps = cps[cps >= 0]
    return _whole(utf8_from_codepoints(cps)[:nbytes])


def _whole(data: bytes) -> bytes:
    """``data`` without an incomplete sequence at its end."""
    for back in range(1, min(4, len(data)) + 1):
        lead = data[-back]
        if lead & 0xC0 != 0x80:  # the last lead: does its sequence fit?
            need = (1 if lead < 0x80 else 2 if lead >> 5 == 6
                    else 3 if lead >> 4 == 14 else 4)
            return data if need <= back else data[:-back]
    return data


def lead_at(data: bytes, k: int) -> int:
    """The first position at or after ``k`` where a code point starts."""
    while data[k] & 0xC0 == 0x80:
        k += 1
    return k


def class_corpus(ch: str, nbytes: int) -> bytes:
    unit = ch.encode()
    return unit * (nbytes // len(unit))


def parity_cases(big: int):
    """(name, data bytes, buffer size) for the kernel parity phase."""
    import numpy as np

    import bench

    rng = np.random.default_rng(SEED)
    cases = []
    for cls, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"), ("u4", "🙂")):
        for size in (1, 4096 * 3 + 17, 100_003):
            cases.append((f"{cls}-{size}", class_corpus(ch, size)))
    mixed = _whole(bench.mixed_corpus(300_000))
    cases.append(("mixed-300k", mixed))
    cases.append(("empty", b""))
    # errors at compose16's tile edges (compose32's: the same size), at a
    # tile's first and last three bytes, at 0, at length-1, cut at length
    from simdutf_tpu_torch.kernels import compose16 as kc

    t = kc.TILE
    for pos in (0, 1, 2, t - 3, t - 2, t - 1, t, t + 1, t + 2, 2 * t - 1, 2 * t, 3 * t - 1):
        for bad in (b"\xff", b"\x80", b"\xed\xa0\x80", b"\xf0\x9f"):
            d = bytearray(mixed[:3 * t + 3_000])
            d[pos:pos + len(bad)] = bad
            cases.append((f"err{bad.hex()}@{pos}", bytes(d)))
    cases.append(("err@len-1", mixed[:9_999] + b"\xc3"))
    cases.append(("cut4@len", mixed[:9_000] + "🙂".encode()[:3]))
    cases.append(("lead4@len-1", mixed[:t - 1] + b"\xf0"))
    # the valid-only converters' edges: a truncated lead, 0xFF mid-buffer
    cases.append(("truncated-e6", b"\xe6"))
    cases.append(("a-ff-b", b"a\xffb"))
    # random mixtures of every class with invalid sequences
    for t in range(40):
        size = int(rng.integers(1, 70_000))
        parts = [_ALPHABET[i].encode()
                 for i in rng.integers(0, len(_ALPHABET), size)]
        d = bytearray(b"".join(parts)[:size])
        for _ in range(int(rng.integers(0, 3)) if t % 2 else 0):
            p = int(rng.integers(0, len(d) + 1))
            d[p:p] = _BAD[int(rng.integers(len(_BAD)))]
        cases.append((f"fuzz{t}", bytes(d)))
    corpus = bench.mixed_corpus(big)
    cases.append(("mixed-64MiB", corpus))
    bad = bytearray(corpus)
    bad[big // 2 + 1] = 0xFF
    cases.append(("mixed-64MiB-err", bytes(bad)))

    out = []
    for i, (name, data) in enumerate(cases):
        n = len(data)
        # buffer: exact, bucket-padded, or padded with garbage past length
        pad = (0, 8, 1000 + i)[i % 3]
        out.append((name, data, n + pad, i % 3 == 2))
    return out


def _u16(text: str):
    """Native (little-endian) UTF-16 units of ``text``, a writable array."""
    import numpy as np

    return np.frombuffer(text.encode("utf-16-le"), np.uint16).copy()


def _u32(text: str):
    """Little-endian UTF-32 words of ``text``, a writable array."""
    import numpy as np

    return np.frombuffer(text.encode("utf-32-le"), np.uint32).copy()


def parity16_cases(big: int):
    """(name, native units, buffer size in units, garbage past the length)
    for the UTF-16 kernel parity phase."""
    import numpy as np

    import bench

    rng = np.random.default_rng(SEED + 16)
    cases = []
    for cls, ch in (("ascii", "a"), ("u2r", "é"), ("u3", "東"),
                    ("astral", "\U0001f642")):
        for size in (1, 2048 * 3 + 17, 100_003):
            cases.append((f"{cls}-{size}", _u16(ch * size)))
    mixed = _u16(bench.mixed_corpus(300_000).decode("utf-8", "ignore"))
    cases.append(("mixed-300k", mixed))
    cases.append(("empty", _u16("")))
    # lone surrogates at 0, at the 2048-unit compose tile edges, near the
    # end of a 20000-unit buffer
    for pos in (0, 1, 2047, 2048, 2049, 4095, 4096, 8191, 8192, 19_999):
        for bad in (0xD800, 0xDBFF, 0xDC00, 0xDFFF):
            d = _u16("x" * 20_000) if pos % 2 else mixed[:20_000].copy()
            d[pos] = bad
            cases.append((f"lone{bad:04x}@{pos}", d))
    # a valid pair straddling a tile edge, and a high surrogate at
    # length-1 whose low is stored at length (the buffer holds the pair)
    cases.append(("pair@2047", _u16("x" * 2047 + "\U0001f642" + "é" * 3000)))
    cases.append(("hi@len-1", _u16("ab é" * 999 + "\U0001f642")))
    # the valid-only converters' edges: a high pairs with whatever follows
    # it (0 past the length), a lone low writes nothing
    cases.append(("d83d", np.array([0xD83D], np.uint16)))
    cases.append(("a-dc00-b", np.array([0x61, 0xDC00, 0x62], np.uint16)))
    cases.append(("a-d800-b", np.array([0x61, 0xD800, 0x62], np.uint16)))
    # random mixtures of every class with lone surrogates
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff"]
    for t in range(30):
        size = int(rng.integers(1, 40_000))
        d = _u16("".join(alphabet[i]
                         for i in rng.integers(0, len(alphabet), size)))[:size]
        for _ in range(int(rng.integers(0, 3)) if t % 2 else 0):
            d[int(rng.integers(0, len(d)))] = int(rng.integers(0xD800, 0xE000))
        cases.append((f"fuzz{t}", d))
    corpus = _u16(bench.mixed_corpus(big).decode("utf-8"))
    cases.append(("mixed-64MiB", corpus))
    bad = corpus.copy()
    bad[len(bad) // 2 + 1] = 0xDC00
    cases.append(("mixed-64MiB-err", bad))

    out = []
    for i, (name, units) in enumerate(cases):
        n = len(units)
        # buffer: exact, bucket-padded, or padded with garbage past length
        pad = (0, 8, 1000 + i)[i % 3]
        if name == "hi@len-1":  # the low half stays stored past the length
            out.append((name, units[:-1], n, False))
            continue
        out.append((name, units, n + pad, i % 3 == 2))
    return out


def mime_corpus(big: int) -> tuple[bytes, bytes]:
    """(raw bytes, their base64 with CRLF every 76 chars): bench.py's base64
    decode input, from the first 3/4 of the mixed corpus."""
    import base64

    import bench

    raw = bench.mixed_corpus(big)[: big * 3 // 4]
    enc = base64.b64encode(raw)
    return raw, b"\r\n".join(enc[i:i + 76] for i in range(0, len(enc), 76))


def parity64_cases(mime: bytes):
    """(name, stored chars, length, buffer size, garbage past the stored
    chars) for the base64 kernel parity phase."""
    from simdutf_tpu_torch.kernels import compact64 as kc64

    t = kc64.TILE  # b64_compact's tile, in chars
    small = mime[:60_000]
    ws = b" " * 3 * t + b"TWFu" + b"\n" * (t + 9000) + b"QUI"
    cases = [("mime-60k", small, 60_000, 60_008, False),
             ("mime-60k-garbage", small, 60_000, 61_000, True),
             ("len==N", small[:40_000], 40_000, 40_000, False),
             ("len==N-ws-last", small[:39_998] + b" Q", 40_000, 40_000, False),
             ("ws-tiles", ws, len(ws), len(ws) + 2705, True),
             ("one", b"Q", 1, 4, False),
             ("bad@len", small[:40_000] + b"*", 40_000, 40_004, False)]
    for pos in (0, 1, 2, t - 3, t - 1, t, t + 1, t + 2, 2 * t - 1, 2 * t, 39_999):
        d = bytearray(small[:40_000])
        d[pos] = ord("*")
        cases.append((f"bad@{pos}", bytes(d), 40_000, 40_000 + 4 * (pos % 3),
                      pos % 2 == 1))
    n = -(-(len(mime) + 8) // 4) * 4
    cases.append(("mime-full", mime, len(mime), n, False))
    bad = bytearray(mime)
    bad[len(bad) // 2 + 1] = ord("*")
    cases.append(("mime-full-bad", bytes(bad), len(mime), n, False))
    return cases


# --- phases ------------------------------------------------------------------

def device_phase():
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {name}, capability {cap}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {card}")
    check(cap == (9, 0), f"needs compute capability (9, 0), found {cap}")
    return name, card


def build_phase():
    from simdutf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")


def _max_err(a, b) -> int:
    """Largest absolute difference between two results (tuples of 0-d
    tensors and arrays); shapes must agree."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    worst = 0
    for x, y in zip(a, b):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.dtype == torch.uint16:
            x = x.view(torch.int16).to(torch.int64) & 0xFFFF
            y = y.view(torch.int16).to(torch.int64) & 0xFFFF
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def parity_phase(device, big: int = CORPUS_BYTES) -> dict:
    """Each kernel against its plain version on ``device``; returns the
    largest error seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import compose16 as kc
    from simdutf_tpu_torch.kernels import validate as kv

    errs = dict.fromkeys(PASSES, 0)
    cases = parity_cases(big)
    for name, data, n, garbage in cases:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        buf[:L] = np.frombuffer(data, np.uint8)
        if garbage:
            buf[L:] = np.random.default_rng(L).integers(0, 256, n - L)
        x = torch.from_numpy(buf).to(device)
        got = {
            "census_utf8": (kcen.census_bits(x, L), kcen.census_bits_ref(x, L)),
            "utf8_first_event": (
                kv.utf8_first_event_len(x, L) + kv.utf8_first_event(x),
                kv.utf8_first_event_len_ref(x, L)
                + kv.utf8_first_event_len_ref(x, n)),
            "utf8_count": (
                tuple(kv._count_call(x, L, w) for w in kv._MODES),
                tuple(kv.count_ref(x, L, w) for w in kv._MODES)),
            "compose16": (
                kc.to_utf16_compose(x, L, False) + kc.to_utf16_compose(x, L, True),
                kc.to_utf16_compose_ref(x, L, False)
                + kc.to_utf16_compose_ref(x, L, True)),
        }
        if x.is_cuda:
            torch.cuda.synchronize()
        for k, (kern, plain) in got.items():
            e = _max_err(kern, plain)
            errs[k] = max(errs[k], e)
            check(e == 0, f"parity {k} on {name} (n={n}, length={L}): "
                          f"max abs err {e}")
    log(f"parity: {len(cases)} inputs, every kernel bit-identical to its "
        f"plain version (LE and BE)")
    return errs


def _units_buffer(name: str, units, n: int, garbage: bool):
    """The n-unit native buffer of a parity16 case: the units, garbage or
    zeros past them, and for ``hi@len-1`` the pair's low half stored at the
    length."""
    import numpy as np

    L = len(units)
    buf = np.zeros(n, np.uint16)
    if garbage:
        buf[:] = np.random.default_rng(L).integers(0, 1 << 16, n)
    buf[:L] = units
    if name == "hi@len-1":
        buf[L] = _u16("\U0001f642")[1]
    return buf


def _words_buffer(name: str, words, n: int, garbage: bool):
    """The n-word buffer of a parity32 case: the words, garbage or zeros
    past them, and for ``bad@len`` a surrogate stored at the length."""
    import numpy as np

    L = len(words)
    buf = np.zeros(n, np.uint32)
    if garbage:
        buf[:] = np.random.default_rng(L).integers(0, 1 << 32, n, dtype=np.uint64)
    buf[:L] = words
    if name == "bad@len":
        buf[L] = 0xD800
    return buf


def parity16_phase(device, big: int = CORPUS_BYTES) -> dict:
    """Each UTF-16 kernel against its plain version on ``device``, LE and
    BE input; returns the largest error seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import compose8 as kc8
    from simdutf_tpu_torch.kernels import utf16_kernels as k16

    errs = dict.fromkeys(PASSES16, 0)
    cases = parity16_cases(big)
    for name, units, n, garbage in cases:
        L = len(units)
        buf = _units_buffer(name, units, n, garbage)
        for be in (False, True):
            stored = buf.byteswap() if be else buf
            w = torch.from_numpy(stored.view(np.int16)).to(device).view(torch.uint16)
            got = {
                "census_utf16": (kcen.census16_bits(w, L, be),
                                 kcen.census16_bits_ref(w, L, be)),
                "utf16_first_bad": (k16.utf16_first_bad(w, L, be),
                                    k16.utf16_first_bad_ref(w, L, be)),
                "utf16_count": (
                    tuple(k16.utf16_reduce(w, L, be, m) for m in k16._MODES),
                    tuple(k16.utf16_reduce_ref(w, L, be, m) for m in k16._MODES)),
                "utf16_to_utf8_compose": (kc8.to_utf8_compose(w, L, be),
                                          kc8.to_utf8_compose_ref(w, L, be)),
            }
            if w.is_cuda:
                torch.cuda.synchronize()
            for k, (kern, plain) in got.items():
                e = _max_err(kern, plain)
                errs[k] = max(errs[k], e)
                check(e == 0, f"parity {k} on {name} (n={n}, length={L}, "
                              f"be={be}): max abs err {e}")
            # the compose total is the utf8len count on every input
            check(int(got["utf16_to_utf8_compose"][0][1])
                  == int(got["utf16_count"][0][1]),
                  f"compose total != utf8len on {name}, be={be}")
    log(f"parity16: {len(cases)} inputs, LE and BE, every UTF-16 kernel "
        f"bit-identical to its plain version")
    return errs


def slice_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's api on ``device``; returns the launch count of each
    kernel during the main-path calls."""
    import bench
    from tools.gen_corpus import PROFILES

    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.errors import error_code as ec

    su.use_device(device)
    data = bench.mixed_corpus(big)
    want = data.decode("utf-8").encode("utf-16-le")

    (res, out, val, n16, ncp), launches = counted(lambda: (
        *su.convert_utf8_to_utf16le_with_errors(data), su.validate_utf8_with_errors(data),
        su.utf16_length_from_utf8(data), su.count_utf8(data)))

    check(res.error == ec.SUCCESS and res.count == len(want) // 2,
          f"transcode result {res}")
    check(out == want, "transcode output differs from codecs")
    check(val.error == ec.SUCCESS and val.count == len(data), f"validate {val}")
    check(n16 == len(want) // 2, f"utf16_length {n16} != {len(want) // 2}")
    check(ncp == len(data.decode("utf-8")), f"count_utf8 {ncp}")
    for k in PASSES:
        check(kernel_launches(launches, k) > 0, f"kernel {k} did not launch on the main path")
    log(f"slice: {len(data)} B mixed corpus, {len(want) // 2} units, equal "
        f"to codecs; launches {launches}")

    res, out = su.convert_utf8_to_utf16be_with_errors(data)
    check(res.is_ok and out == data.decode("utf-8").encode("utf-16-be"),
          "big-endian transcode differs from codecs")

    # 0xFF where a code point starts: HEADER_BITS there, and the output is
    # the prefix before it
    k = lead_at(data, len(data) * 3 // 5)
    bad = data[:k] + b"\xff" + data[k + 1:]
    res, out = su.convert_utf8_to_utf16le_with_errors(bad)
    val = su.validate_utf8_with_errors(bad)
    check((res.error, res.count) == (ec.HEADER_BITS, k),
          f"injected 0xFF at {k}: port {res}")
    check((val.error, val.count) == (ec.HEADER_BITS, k),
          f"injected 0xFF at {k}, validate: port {val}")
    check(out == data[:k].decode("utf-8").encode("utf-16-le"),
          "partial output is not the valid prefix")
    log(f"slice: injected 0xFF reported as ({res.error.name}, {res.count}), "
        f"partial output = valid prefix ({len(out) // 2} units)")

    inputs = [(c, class_corpus(ch, big // 4))
              for c, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"),
                            ("u4", "🙂"))]
    inputs.append(("zh", profile_corpus(PROFILES["zh"], big // 4, SEED)))
    for name, d in inputs:
        res, out = su.convert_utf8_to_utf16le_with_errors(d)
        check(res.is_ok and out == d.decode("utf-8").encode("utf-16-le"),
              f"{name}: transcode differs from codecs")
        check(su.validate_utf8_with_errors(d).count == len(d), f"{name}: validate")
    log(f"slice: classes {[n for n, _ in inputs]} at {big // 4} B equal codecs")
    return launches


def slice16_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's UTF-16 -> UTF-8 api on ``device``, on the UTF-16LE/BE
    encoding of the 64 MiB corpus; returns the launch count of
    each UTF-16 kernel during the main-path calls."""
    import numpy as np

    import bench
    from tools.gen_corpus import PROFILES

    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.errors import error_code as ec

    su.use_device(device)
    data = bench.mixed_corpus(big)
    text = data.decode("utf-8")
    le, be = text.encode("utf-16-le"), text.encode("utf-16-be")
    units = len(le) // 2

    (res, out, val, n8, ncp), launches = counted(lambda: (
        *su.convert_utf16le_to_utf8_with_errors(le), su.validate_utf16le_with_errors(le),
        su.utf8_length_from_utf16le(le), su.count_utf16le(le)))

    check(res.is_ok and res.count == len(data), f"utf16le transcode {res}")
    check(out == data, "utf16le transcode differs from the corpus bytes")
    check(val.is_ok and val.count == units, f"validate_utf16le {val}")
    check(n8 == len(data), f"utf8_length_from_utf16le {n8} != {len(data)}")
    check(ncp == len(text), f"count_utf16le {ncp} != {len(text)}")
    for k in PASSES16:
        check(kernel_launches(launches, k) > 0, f"kernel {k} did not launch on the main path")
    log(f"slice16: {units} units ({len(le)} B UTF-16LE) -> {len(data)} B, "
        f"equal to the corpus; launches {launches}")

    res, out = su.convert_utf16be_to_utf8_with_errors(be)
    check(res.is_ok and out == data, "utf16be transcode differs from the corpus")
    check(su.validate_utf16be_with_errors(be).count == units, "validate_utf16be")
    check(su.utf8_length_from_utf16be(be) == len(data), "utf8_length_from_utf16be")
    check(su.count_utf16be(be) == len(text), "count_utf16be")
    check(su.convert_valid_utf16le_to_utf8(le) == data
          and su.convert_valid_utf16be_to_utf8(be) == data,
          "convert_valid_utf16*_to_utf8 differs from the corpus")

    # a lone surrogate mid-buffer, at a unit that follows no high surrogate
    bad = np.frombuffer(le, np.uint16).copy()
    k = units * 3 // 5
    while (bad[k - 1] & 0xFC00) == 0xD800:
        k += 1
    bad[k] = 0xDC00
    res, out = su.convert_utf16le_to_utf8_with_errors(bad.tobytes())
    val = su.validate_utf16le_with_errors(bad.tobytes())
    check((res.error, res.count) == (ec.SURROGATE, k),
          f"injected lone surrogate at {k}: port {res}")
    check((val.error, val.count) == (ec.SURROGATE, k),
          f"injected lone surrogate at {k}, validate: port {val}")
    check(out == bad[:k].tobytes().decode("utf-16-le").encode("utf-8"),
          "partial output is not the valid prefix")
    res_be, out_be = su.convert_utf16be_to_utf8_with_errors(bad.byteswap().tobytes())
    check((res_be.error, res_be.count) == (res.error, res.count) and out_be == out,
          "big-endian injected error differs from little-endian")
    log(f"slice16: injected lone surrogate reported as ({res.error.name}, "
        f"{res.count}), partial output = valid prefix ({len(out)} B)")

    inputs = [(c, class_corpus(ch, big // 4))
              for c, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"),
                            ("u4", "🙂"))]
    inputs.append(("zh", profile_corpus(PROFILES["zh"], big // 4, SEED)))
    for name, d in inputs:
        w = d.decode("utf-8").encode("utf-16-le")
        res, out = su.convert_utf16le_to_utf8_with_errors(w)
        check(res.is_ok and out == d, f"{name}: utf16le transcode differs")
        check(su.validate_utf16le_with_errors(w).count == len(w) // 2,
              f"{name}: validate_utf16le")
    log(f"slice16: classes {[n for n, _ in inputs]} at {big // 4} B of UTF-8 "
        f"equal the corpus bytes")
    return launches


def parity64_phase(device, big: int = CORPUS_BYTES) -> dict:
    """Each base64 kernel against its plain version on ``device``, uint8
    and char16 chars, the three alphabet modes; returns the largest error
    seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import base64_kernel as kb
    from simdutf_tpu_torch.kernels import compact64 as kc64
    from simdutf_tpu_torch.ops import base64_ops as ob

    def record(k, name, kern, plain):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(kern, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {name}: max abs err {e}")

    errs = dict.fromkeys(PASSES64, 0)
    raw, mime = mime_corpus(big)
    cases = parity64_cases(mime)
    for name, data, L, n, garbage in cases:
        buf = np.zeros(n, np.uint8)
        if garbage:
            buf[:] = np.random.default_rng(L).integers(0, 256, n)
        buf[:len(data)] = np.frombuffer(data, np.uint8)
        for wide in (False, True):
            if wide:  # a unit above 0xFF whose low byte is 'A'
                b16 = buf.astype(np.uint16)
                if name.startswith("mime"):
                    b16[L // 3] = 0x141
                x = torch.from_numpy(b16.view(np.int16)).to(device).view(torch.uint16)
            else:
                x = torch.from_numpy(buf).to(device)
            for url, both in MODES64:
                what = f"{name} (n={n}, length={L}, wide={wide}, url={url}, both={both})"
                got = kc64.compact_codes(x, L, url, both)
                record("b64_compact8", what, got, kc64.compact_codes_ref(x, L, url, both))
                record("b64_pack", what, kb.pack(got[0]), kb.pack_ref(got[0]))
                record("b64_compact8", what, ob.decode_bulk_routed(x, L, url, both),
                       ob.decode_bulk(x, L, url, both))
    # pack on arbitrary bytes, encode on the raw corpus and on ragged sizes
    rng = np.random.default_rng(SEED + 64)
    for n in (4, 16, 20, 1028, 3 * 1536 * 5 + 12):
        b = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)).to(device)
        record("b64_pack", f"random {n}", kb.pack(b), kb.pack_ref(b))
        m = n // 3 * 3
        for url in (False, True):
            record("b64_encode", f"random {m}", kb.encode(b[:m], url),
                   kb.encode_ref(b[:m], url))
    r = torch.from_numpy(np.frombuffer(raw, np.uint8)[: len(raw) // 3 * 3].copy()).to(device)
    for url in (False, True):
        record("b64_encode", f"raw corpus, url={url}", kb.encode(r, url),
               kb.encode_ref(r, url))
    log(f"parity64: {len(cases)} char buffers, uint8 and char16, three alphabet "
        f"modes, every base64 kernel bit-identical to its plain version")
    return errs


def slice64_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's base64 api on ``device``, on the MIME corpus and its
    char16 form; returns the launch count of each base64 kernel
    during the main-path calls."""
    import base64

    import numpy as np

    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.errors import error_code as ec

    su.use_device(device)
    raw, mime = mime_corpus(big)
    mime16 = np.frombuffer(mime, np.uint8).astype(np.uint16)

    (res, out, res16, out16, enc, enc_url), launches = counted(lambda: (
        *su.base64_to_binary(mime), *su.base64_to_binary(mime16),
        su.binary_to_base64(raw), su.binary_to_base64(raw, su.base64_url)))

    check(res.error == ec.SUCCESS and res.count == len(raw), f"decode result {res}")
    check(out == raw, "decoded MIME corpus differs from the raw bytes")
    check(res16.is_ok and out16 == raw, f"char16 decode {res16} differs")
    check(enc == base64.b64encode(raw), "encode differs from base64.b64encode")
    check(enc_url == base64.urlsafe_b64encode(raw), "url encode differs")
    for k in PASSES64:
        check(kernel_launches(launches, k) > 0, f"kernel {k} did not launch on the main path")
    log(f"slice64: {len(mime)} chars of MIME base64 -> {len(raw)} B, uint8 and "
        f"char16, equal to the raw bytes; encode equal to base64.b64encode "
        f"(default and url); launches {launches}")

    # '*' in place of an alphabet char: INVALID_BASE64_CHARACTER there,
    # and the bytes of the whole quads before it
    bad = np.frombuffer(mime, np.uint8).copy()
    k = len(bad) * 3 // 5
    while bad[k] in (ord("\r"), ord("\n")):
        k += 1
    bad[k] = ord("*")
    quads = (k - mime.count(b"\r\n", 0, k) * 2) // 4
    full, out = su.base64_to_binary_details(bad)
    check((full.error, full.input_count, full.output_count)
          == (ec.INVALID_BASE64_CHARACTER, k, 3 * quads)
          and out == raw[: 3 * quads],
          f"injected invalid char at {k}: port {full}")
    full16, out16 = su.base64_to_binary_details(bad.astype(np.uint16))
    check((full16, out16) == (full, out), "char16 injected invalid char differs")
    log(f"slice64: injected invalid char reported as ({full.error.name}, "
        f"{full.input_count}), partial output {full.output_count} B = the raw "
        f"bytes of the {quads} whole quads before it")
    check(su.maximal_binary_length_from_base64(base64.b64encode(raw)) == len(raw)
          and su.base64_length_from_binary(len(raw)) == len(enc),
          "base64 length helpers")
    return launches


def parity32_cases(big: int):
    """(name, words, buffer size in words, garbage past the length) for the
    UTF-32 kernel parity phase."""
    import numpy as np

    import bench

    rng = np.random.default_rng(SEED + 32)
    bad_words = (0x110000, 0xD800, 0xDFFF, 0x80000000, 0xFFFFFFFF)
    cases = []
    for cls, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"),
                    ("astral", "\U0001f642")):
        for size in (1, 2048 * 3 + 17, 100_003):
            cases.append((f"{cls}-{size}", _u32(ch * size)))
    mixed = _u32(bench.mixed_corpus(300_000).decode("utf-8", "ignore"))
    cases.append(("mixed-300k", mixed))
    cases.append(("empty", _u32("")))
    # invalid words at 0, at the 2048-word compose tile edges, at length-1
    for pos in (0, 1, 2047, 2048, 2049, 4095, 4096, 8191, 8192, 19_999):
        for word in bad_words:
            d = mixed[:20_000].copy()
            d[pos] = word
            cases.append((f"{word:x}@{pos}", d))
    alphabet = ["a", " ", "é", "Ж", "東", "\U0001f642", "\U0010ffff"]
    for t in range(20):
        size = int(rng.integers(1, 40_000))
        d = _u32("".join(alphabet[i]
                         for i in rng.integers(0, len(alphabet), size)))
        for _ in range(int(rng.integers(0, 3)) if t % 2 else 0):
            d[int(rng.integers(0, len(d)))] = bad_words[int(rng.integers(5))]
        cases.append((f"fuzz{t}", d))
    corpus = _u32(_whole(bench.mixed_corpus(big)).decode("utf-8"))
    cases.append(("mixed-64MiB", corpus))
    bad = corpus.copy()
    bad[len(bad) // 2 + 1] = 0xD800
    cases.append(("mixed-64MiB-err", bad))

    out = []
    for i, (name, words) in enumerate(cases):
        pad = (0, 8, 1000 + i)[i % 3]
        out.append((name, words, len(words) + pad, i % 3 == 2))
    # an invalid word stored at the length, outside the range
    out.append(("bad@len", mixed[:5000], 5008, False))
    return out


def parity32_phase(device, big: int = CORPUS_BYTES) -> dict:
    """Each UTF-32 kernel against its plain version on ``device``, and
    compose32 on the UTF-8 parity inputs; returns the largest error seen
    per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import compose32 as kc32
    from simdutf_tpu_torch.kernels import composex as kcx
    from simdutf_tpu_torch.kernels import validate as kv

    def record(k, what, kern, plain):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(kern, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {what}: max abs err {e}")

    errs = dict.fromkeys(PASSES32, 0)
    cases = parity32_cases(big)
    for name, words, n, garbage in cases:
        L = len(words)
        buf = _words_buffer(name, words, n, garbage)
        w = torch.from_numpy(buf.view(np.int32)).to(device)
        what = f"{name} (n={n}, length={L})"
        record("utf32_first_bad", what, kv.utf32_first_bad(w, L),
               kv.utf32_first_bad_ref(w, L))
        record("utf32_count", what,
               tuple(kv.utf32_count(w, L, m) for m in kv._MODES32),
               tuple(kv.utf32_count_ref(w, L, m) for m in kv._MODES32))
        record("utf32_to_utf8_compose", what, kcx.u32_to_utf8_compose(w, L),
               kcx.u32_to_utf8_compose_ref(w, L))
    cases8 = parity_cases(big)
    for name, data, n, garbage in cases8:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        buf[:L] = np.frombuffer(data, np.uint8)
        if garbage:
            buf[L:] = np.random.default_rng(L).integers(0, 256, n - L)
        x = torch.from_numpy(buf).to(device)
        record("compose32", f"{name} (n={n}, length={L})",
               kc32.to_utf32_compose(x, L), kc32.to_utf32_compose_ref(x, L))
    log(f"parity32: {len(cases)} word buffers and {len(cases8)} UTF-8 buffers, "
        f"every UTF-32 kernel bit-identical to its plain version")
    return errs


def slice32_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's UTF-8 <-> UTF-32 api on ``device``, on the 64 MiB mixed
    corpus and its UTF-32LE form; returns the launch count of each UTF-32
    kernel during the main-path calls."""
    import numpy as np

    import bench
    from tools.gen_corpus import PROFILES

    from simdutf_tpu_torch import TorchImplementation
    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.errors import error_code as ec

    su.use_device(device)
    data = bench.mixed_corpus(big)
    text = data.decode("utf-8")
    w32 = text.encode("utf-32-le")
    words = len(w32) // 4

    (res, out, val, n8, n16, res8, out8), launches = counted(lambda: (
        *su.convert_utf8_to_utf32_with_errors(data), su.validate_utf32_with_errors(w32),
        su.utf8_length_from_utf32(w32), su.utf16_length_from_utf32(w32),
        *su.convert_utf32_to_utf8_with_errors(w32)))

    check(res.is_ok and res.count == words, f"utf8 -> utf32 result {res}")
    check(out == w32, "utf8 -> utf32 output differs from codecs")
    check(val.is_ok and val.count == words, f"validate_utf32 {val}")
    check(n8 == len(data), f"utf8_length_from_utf32 {n8} != {len(data)}")
    check(n16 == len(text.encode("utf-16-le")) // 2, f"utf16_length_from_utf32 {n16}")
    check(res8.is_ok and res8.count == len(data), f"utf32 -> utf8 result {res8}")
    check(out8 == data, "utf32 -> utf8 output differs from the corpus bytes")
    for k in PASSES32:
        check(kernel_launches(launches, k) > 0, f"kernel {k} did not launch on the main path")
    log(f"slice32: {len(data)} B -> {words} words -> {len(data)} B, equal to "
        f"codecs utf-32-le; launches {launches}")
    check(su.convert_valid_utf8_to_utf32(data) == w32
          and su.convert_valid_utf32_to_utf8(w32) == data,
          "convert_valid_utf8_to_utf32 / convert_valid_utf32_to_utf8 differ")

    # invalid words at a known position: their code there, and the prefix
    arr = np.frombuffer(w32, np.uint32)
    k = words * 3 // 5
    for word, code in ((0xD800, ec.SURROGATE), (0x110000, ec.TOO_LARGE),
                       (0xFFFFFFFF, ec.TOO_LARGE)):
        bad = arr.copy()
        bad[k] = word
        res, out = su.convert_utf32_to_utf8_with_errors(bad)
        val = su.validate_utf32_with_errors(bad)
        check((res.error, res.count) == (val.error, val.count) == (code, k),
              f"injected {word:#x} at {k}: port {res}, validate {val}")
        check(out == text[:k].encode("utf-8"), "partial output is not the valid prefix")
    # a second opinion on the last: the port on the CPU over a window
    lo = max(0, k - (1 << 20))
    cpu_res, cpu_out = TorchImplementation("cpu").convert_utf32_to_utf8_with_errors(
        bad[lo:k + (1 << 20)])
    check((cpu_res.error, cpu_res.count) == (ec.TOO_LARGE, k - lo)
          and cpu_out.tobytes() == text[lo:k].encode("utf-8"),
          f"CPU window around the injected word: {cpu_res}")
    k8 = lead_at(data, len(data) * 3 // 5)
    bad8 = data[:k8] + b"\xff" + data[k8 + 1:]
    res, out = su.convert_utf8_to_utf32_with_errors(bad8)
    check((res.error, res.count) == (ec.HEADER_BITS, k8)
          and out == data[:k8].decode("utf-8").encode("utf-32-le"),
          f"injected 0xFF at {k8}: port {res}")
    log(f"slice32: injected words reported at {k} (SURROGATE, TOO_LARGE x2), "
        f"0xFF at byte {k8} as ({res.error.name}, {res.count}); partial "
        f"outputs = valid prefixes; CPU window agrees")

    inputs = [(c, class_corpus(ch, big // 4))
              for c, ch in (("ascii", "a"), ("u2", "é"), ("u3", "東"),
                            ("u4", "🙂"))]
    inputs.append(("zh", profile_corpus(PROFILES["zh"], big // 4, SEED)))
    for name, d in inputs:
        res, out = su.convert_utf8_to_utf32_with_errors(d)
        check(res.is_ok and out == d.decode("utf-8").encode("utf-32-le"),
              f"{name}: utf8 -> utf32 differs from codecs")
        res8, out8 = su.convert_utf32_to_utf8_with_errors(out)
        check(res8.is_ok and out8 == d, f"{name}: utf32 -> utf8 differs")
    log(f"slice32: classes {[n for n, _ in inputs]} at {big // 4} B of UTF-8 "
        f"round-trip equal to codecs")
    return launches


def latin1_corpus(nbytes: int, seed: int = SEED) -> bytes:
    """Latin-1 text made with numpy: 70% of bytes in 0x20-0x7E, 30% in
    0xC0-0xFF (tools/gen_corpus.py's ``latin`` profile cut to Latin-1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    low = rng.random(nbytes, dtype=np.float32) < 0.7
    return np.where(low, rng.integers(0x20, 0x7F, nbytes, dtype=np.uint8),
                    rng.integers(0xC0, 0x100, nbytes, dtype=np.uint8)).tobytes()


def latin1_cases(big: int):
    """(name, Latin-1 bytes, buffer size, garbage past the length) for the
    latin1_to_utf8_compose parity."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    every = bytes(range(256))
    cases = [("every-byte", every), ("every-byte-x40", every * 40), ("empty", b""),
             ("ascii-100003", b"a" * 100_003), ("high-100003", b"\xe9" * 100_003)]
    edges = bytearray(b"x" * 20_000)
    for p in (0, 2047, 2048, 4095, 4096, 19_999):
        edges[p] = 0xFF
    cases.append(("high@edges", bytes(edges)))
    for t in range(10):
        cases.append((f"fuzz{t}", latin1_corpus(int(rng.integers(1, 50_000)), SEED + t)))
    cases.append(("latin1-64MiB", latin1_corpus(big)))
    return [(name, data, len(data) + (0, 8, 1000 + i)[i % 3], i % 3 == 2)
            for i, (name, data) in enumerate(cases)]


def parityx_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The three butterflyx compose kernels against their plain versions
    on ``device``: UTF-16 -> UTF-32 on the UTF-16 parity inputs (LE and BE
    input), UTF-32 -> UTF-16 on the UTF-32 parity inputs (LE and BE
    output), Latin-1 -> UTF-8 on every byte value, high bytes at the tile
    edges, random and the 64 MiB Latin-1 buffer; returns the largest error
    seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import composex as kcx

    def record(k, what, kern, plain):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(kern, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {what}: max abs err {e}")

    errs = dict.fromkeys(PASSESX, 0)
    cases16 = parity16_cases(big)
    for name, units, n, garbage in cases16:
        L = len(units)
        buf = _units_buffer(name, units, n, garbage)
        for be in (False, True):
            stored = buf.byteswap() if be else buf
            w = torch.from_numpy(stored.view(np.int16)).to(device).view(torch.uint16)
            record("utf16_to_utf32_compose", f"{name} (n={n}, length={L}, be={be})",
                   kcx.u16_to_utf32_compose(w, L, be), kcx.u16_to_utf32_compose_ref(w, L, be))
    cases32 = parity32_cases(big)
    for name, words, n, garbage in cases32:
        L = len(words)
        w = torch.from_numpy(_words_buffer(name, words, n, garbage).view(np.int32)).to(device)
        for be in (False, True):
            record("utf32_to_utf16_compose", f"{name} (n={n}, length={L}, be={be})",
                   kcx.u32_to_utf16_compose(w, L, be), kcx.u32_to_utf16_compose_ref(w, L, be))
    cases8 = latin1_cases(big)
    for name, data, n, garbage in cases8:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        if garbage:
            buf[:] = np.random.default_rng(L).integers(0, 256, n)
        buf[:L] = np.frombuffer(data, np.uint8)
        b = torch.from_numpy(buf).to(device)
        record("latin1_to_utf8_compose", f"{name} (n={n}, length={L})",
               kcx.latin1_to_utf8_compose(b, L), kcx.latin1_to_utf8_compose_ref(b, L))
    log(f"parityx: {len(cases16)} unit buffers and {len(cases32)} word buffers (LE and "
        f"BE), {len(cases8)} Latin-1 buffers, every butterflyx kernel bit-identical "
        f"to its plain version")
    return errs


def slicex_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's UTF-16 <-> UTF-32 and Latin-1 api on ``device``: the
    64 MiB corpus as UTF-16LE/BE -> UTF-32, its UTF-32LE form -> UTF-16LE/BE,
    a 64 MiB Latin-1 buffer -> UTF-8/16/32 and its encodings -> Latin-1,
    against CPython's codecs; returns the launch count of each butterflyx
    kernel during the main-path calls."""
    import numpy as np

    import bench

    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.errors import error_code as ec

    su.use_device(device)
    text = bench.mixed_corpus(big).decode("utf-8")
    le, be, w32 = text.encode("utf-16-le"), text.encode("utf-16-be"), text.encode("utf-32-le")
    lat = latin1_corpus(big)
    ltext = lat.decode("latin-1")
    l8, l16, l32 = ltext.encode(), ltext.encode("utf-16-le"), ltext.encode("utf-32-le")

    (res32, out32, res16, out16, out8), launches = counted(lambda: (
        *su.convert_utf16le_to_utf32_with_errors(le),
        *su.convert_utf32_to_utf16le_with_errors(w32), su.convert_latin1_to_utf8(lat)))

    check(res32.is_ok and res32.count == len(w32) // 4 and out32 == w32,
          f"utf16le -> utf32 {res32} differs from codecs")
    check(res16.is_ok and res16.count == len(le) // 2 and out16 == le,
          f"utf32 -> utf16le {res16} differs from codecs")
    check(out8 == l8, "latin1 -> utf8 differs from codecs")
    for k in PASSESX:
        check(kernel_launches(launches, k) > 0, f"kernel {k} did not launch on the main path")
    log(f"slicex: {len(le) // 2} units -> {len(w32) // 4} words -> {len(le) // 2} "
        f"units, {len(lat)} Latin-1 B -> {len(l8)} B, equal to codecs; "
        f"launches {launches}")

    check(su.convert_utf16be_to_utf32_with_errors(be) == (res32, w32)
          and su.convert_utf16be_to_utf32(be) == w32
          and su.convert_valid_utf16le_to_utf32(le) == w32
          and su.convert_valid_utf16be_to_utf32(be) == w32,
          "utf16be / valid utf16 -> utf32 differ from codecs")
    check(su.convert_utf32_to_utf16be_with_errors(w32)[1] == be
          and su.convert_utf32_to_utf16be(w32) == be
          and su.convert_valid_utf32_to_utf16le(w32) == le
          and su.convert_valid_utf32_to_utf16be(w32) == be,
          "utf32 -> utf16be / valid utf32 -> utf16 differ from codecs")
    check(su.convert_latin1_to_utf16le(lat) == l16
          and su.convert_latin1_to_utf16be(lat) == ltext.encode("utf-16-be")
          and su.convert_latin1_to_utf32(lat) == l32,
          "latin1 -> utf16 / utf32 differ from codecs")
    for name, data in (("utf8", l8), ("utf16le", l16), ("utf32", l32)):
        res, out = getattr(su, f"convert_{name}_to_latin1_with_errors")(data)
        check(res.is_ok and res.count == len(lat) and out == lat,
              f"{name} -> latin1 {res} differs from the Latin-1 bytes")
        check(getattr(su, f"convert_valid_{name}_to_latin1")(data) == lat,
              f"valid {name} -> latin1 differs")
    check(su.convert_utf16be_to_latin1(ltext.encode("utf-16-be")) == lat,
          "utf16be -> latin1 differs")
    log("slicex: BE, valid-only and every Latin-1 direction at full width equal codecs")

    # errors at known positions: their code there, and the valid prefix
    units = np.frombuffer(le, np.uint16).copy()
    k = len(units) * 3 // 5
    while (units[k - 1] & 0xFC00) == 0xD800:
        k += 1
    units[k] = 0xDC00
    res, out = su.convert_utf16le_to_utf32_with_errors(units.tobytes())
    check((res.error, res.count) == (ec.SURROGATE, k)
          and out == units[:k].tobytes().decode("utf-16-le").encode("utf-32-le"),
          f"lone surrogate at {k}: port {res}")
    res_be, out_be = su.convert_utf16be_to_utf32_with_errors(units.byteswap().tobytes())
    check((res_be.error, res_be.count, out_be) == (res.error, res.count, out),
          "big-endian lone surrogate differs from little-endian")
    words = np.frombuffer(w32, np.uint32).copy()
    kw = len(words) * 3 // 5
    words[kw] = 0x110000
    res, out = su.convert_utf32_to_utf16le_with_errors(words)
    check((res.error, res.count) == (ec.TOO_LARGE, kw)
          and out == text[:kw].encode("utf-16-le"), f"0x110000 at {kw}: port {res}")
    kl = len(lat) * 3 // 5
    k8 = len(ltext[:kl].encode())
    bad8 = l8[:k8] + "東".encode() + l8[k8:]
    res, out = su.convert_utf8_to_latin1_with_errors(bad8)
    check((res.error, res.count) == (ec.TOO_LARGE, k8) and out == lat[:kl],
          f"3-byte char at byte {k8}: port {res}")
    log(f"slicex: lone surrogate at unit {k} (LE and BE), 0x110000 at word {kw} and a "
        f"3-byte char at byte {k8} reported there; partial outputs = valid prefixes")

    inputs = [("ascii", b"a" * (big // 4)), ("all-high", b"\xe9" * (big // 4))]
    for name, d in inputs:
        want = d.decode("latin-1").encode()
        check(su.convert_latin1_to_utf8(d) == want, f"{name}: latin1 -> utf8 differs")
        check(su.convert_utf8_to_latin1(want) == d, f"{name}: utf8 -> latin1 differs")
    for name, ch in (("bmp", "東"), ("astral", "🙂")):
        t = ch * (big // 16)
        w16, ww = t.encode("utf-16-le"), t.encode("utf-32-le")
        check(su.convert_utf16le_to_utf32(w16) == ww, f"{name}: utf16 -> utf32 differs")
        check(su.convert_utf32_to_utf16le(ww) == w16, f"{name}: utf32 -> utf16 differs")
    log("slicex: Latin-1 ASCII and all-high, BMP and astral classes equal codecs")
    return launches


def well_formed_np(units):
    """numpy reference of to_well_formed on native units: a high surrogate
    not followed by a low one, or a low one not preceded by a high one,
    becomes U+FFFD."""
    import numpy as np

    hi = (units & 0xFC00) == 0xD800
    lo = (units & 0xFC00) == 0xDC00
    next_lo = np.append(lo[1:], False)
    prev_hi = np.insert(hi[:-1], 0, False)
    return np.where((hi & ~next_lo) | (lo & ~prev_hi), 0xFFFD, units).astype(np.uint16)


def parityu_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The utilities' kernels against their plain versions on ``device``:
    ascii_first_bad, detect_encodings and compose16 without its clamp on
    the UTF-8 parity inputs (plus a 64 MiB ASCII buffer with and without a
    high byte), detect_encodings on the UTF-16LE and UTF-32LE bytes of the
    UTF-16 and UTF-32 parity inputs, utf16_to_well_formed and compose8's
    valid-only mode on the UTF-16 ones (LE and BE); returns the largest
    error seen per kernel (all must be 0), the compose modes under their
    kernels' names."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import compose8 as kc8
    from simdutf_tpu_torch.kernels import compose16 as kc
    from simdutf_tpu_torch.kernels import detect_kernel as kdet
    from simdutf_tpu_torch.kernels import utf16_kernels as k16
    from simdutf_tpu_torch.kernels import validate as kv

    def record(k, what, kern, plain):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(kern, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {what}: max abs err {e}")

    errs = dict.fromkeys(PASSESU + ("compose16", "utf16_to_utf8_compose"), 0)
    cases8 = parity_cases(big)
    high_end = bytearray(b"a" * big)
    high_end[-1] = 0xC3
    cases8 += [("ascii-64MiB", b"a" * big, big + 8, False),
               ("ascii-64MiB-high@end", bytes(high_end), big + 8, True)]
    for name, data, n, garbage in cases8:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        buf[:L] = np.frombuffer(data, np.uint8)
        if garbage:
            buf[L:] = np.random.default_rng(L).integers(0, 256, n - L)
        x = torch.from_numpy(buf).to(device)
        what = f"{name} (n={n}, length={L})"
        record("ascii_first_bad", what,
               (kv.ascii_first_bad(x, L), kv.ascii_first_bad(x, n)),
               (kv.ascii_first_bad_ref(x, L), kv.ascii_first_bad_ref(x, n)))
        record("detect_encodings", what, kdet.detect_fused(x, L), kdet.detect_fused_ref(x, L))
        if not name.startswith("ascii-64MiB"):
            for be in (False, True):
                record("compose16", f"{what}, unclamped, be={be}",
                       kc.to_utf16_compose(x, L, be, clamp=False),
                       kc.to_utf16_compose_ref(x, L, be, clamp=False))
    cases16 = parity16_cases(big)
    for name, units, n, garbage in cases16:
        L = len(units)
        buf = _units_buffer(name, units, n, garbage)
        for be in (False, True):
            stored = buf.byteswap() if be else buf
            w = torch.from_numpy(stored.view(np.int16)).to(device).view(torch.uint16)
            what = f"{name} (n={n}, length={L}, be={be})"
            record("utf16_to_well_formed", what, k16.utf16_to_well_formed(w, L, be),
                   k16.utf16_to_well_formed_ref(w, L, be))
            record("utf16_to_utf8_compose", f"{what}, valid-only",
                   kc8.to_utf8_compose(w, L, be, mode="valid"),
                   kc8.to_utf8_compose_ref(w, L, be, mode="valid"))
        b = torch.from_numpy(buf.view(np.uint8)).to(device)
        record("detect_encodings", f"{name} as UTF-16LE bytes", kdet.detect_fused(b, 2 * L),
               kdet.detect_fused_ref(b, 2 * L))
        record("detect_encodings", f"{name} as UTF-16LE bytes, odd length",
               kdet.detect_fused(b, max(2 * L - 1, 0)), kdet.detect_fused_ref(b, max(2 * L - 1, 0)))
    cases32 = parity32_cases(big)
    for name, words, n, garbage in cases32:
        L = len(words)
        b = torch.from_numpy(_words_buffer(name, words, n, garbage).view(np.uint8)).to(device)
        for length in (4 * L, 4 * L - 3 if L else 0):
            record("detect_encodings", f"{name} as UTF-32LE bytes, length {length}",
                   kdet.detect_fused(b, length), kdet.detect_fused_ref(b, length))
    log(f"parityu: {len(cases8)} byte buffers, {len(cases16)} unit buffers (LE and BE) and "
        f"{len(cases32)} word buffers, ascii_first_bad, utf16_to_well_formed, "
        f"detect_encodings, compose16 unclamped and compose8 valid-only bit-identical "
        f"to their plain versions")
    return errs


def sliceu_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's utilities api on ``device`` at full size; returns the
    launch count of each utilities kernel during the main-path calls."""
    import base64

    import numpy as np

    import bench

    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.encodings import encoding_type as et
    from simdutf_tpu_torch.errors import error_code as ec

    su.use_device(device)
    data = bench.mixed_corpus(big)
    text = data.decode("utf-8")
    le, be, w32 = text.encode("utf-16-le"), text.encode("utf-16-be"), text.encode("utf-32-le")
    units = np.frombuffer(le, np.uint16)
    first_high = int(np.flatnonzero(np.frombuffer(data, np.uint8) >= 0x80)[0])
    # lone surrogates at known places, each over a unit that is no
    # surrogate: a low after no high, a high before no low, a high at the end
    bad = units.copy()
    k_lo = len(bad) // 5
    while (bad[k_lo - 1] & 0xFC00) == 0xD800 or (bad[k_lo] & 0xF800) == 0xD800:
        k_lo += 1
    bad[k_lo] = 0xDC00
    k_hi = len(bad) * 3 // 5
    while (bad[k_hi] & 0xF800) == 0xD800 or (bad[k_hi + 1] & 0xFC00) == 0xDC00:
        k_hi += 1
    bad[k_hi] = 0xD800
    k_end = len(bad) - 1
    while (bad[k_end] & 0xF800) == 0xD800:
        k_end -= 1
    bad = bad[:k_end + 1]
    bad[k_end] = 0xDBFF
    want_wf = well_formed_np(bad)
    check(np.flatnonzero(want_wf != bad).tolist() == [k_lo, k_hi, k_end],
          "three lone surrogates injected")

    def codec_ok(d: bytes, codec: str) -> bool:
        try:
            d.decode(codec)
            return True
        except UnicodeDecodeError:
            return False

    codecs = ("utf-8", "utf-16-le", "utf-32-le")
    flag = {"utf-8": et.UTF8, "utf-16-le": et.UTF16_LE, "utf-32-le": et.UTF32_LE}

    def detected(d: bytes) -> int:
        return sum(int(flag[c]) for c in codecs if codec_ok(d, c))

    (asc, wf, det, v16, v8), launches = counted(lambda: (
        su.validate_ascii_with_errors(data), su.to_well_formed_utf16le(bad.tobytes()),
        su.detect_encodings(data), su.convert_valid_utf8_to_utf16le(data),
        su.convert_valid_utf16le_to_utf8(le)))

    check((asc.error, asc.count) == (ec.TOO_LARGE, first_high),
          f"validate_ascii_with_errors {asc}, first byte >= 0x80 at {first_high}")
    check(wf == want_wf.tobytes(), "to_well_formed_utf16le differs from numpy")
    check(det == detected(data), f"detect_encodings of the corpus: {det}")
    check(v16 == le and v8 == data, "valid-only converters differ from codecs")
    for k in PASSESU + ("compose16", "utf16_to_utf8_compose"):
        check(kernel_launches(launches, k) > 0, f"kernel {k} did not launch on the main path")
    log(f"sliceu: {len(data)} B corpus: validate_ascii ({asc.error.name}, {asc.count}); "
        f"to_well_formed of {len(bad)} units with 3 lone surrogates = numpy; "
        f"detect_encodings {det}; valid-only converters = codecs; launches {launches}")

    ascii_buf = bytearray(class_corpus("a", big))
    check(su.validate_ascii_with_errors(bytes(ascii_buf)) == (ec.SUCCESS, big)
          and su.validate_ascii(bytes(ascii_buf)), "64 MiB ASCII buffer")
    ascii_buf[-1] = 0x80
    check(su.validate_ascii_with_errors(bytes(ascii_buf)) == (ec.TOO_LARGE, big - 1),
          "64 MiB ASCII buffer with 0x80 at its end")
    check(su.to_well_formed_utf16be(bad.byteswap().tobytes()) == want_wf.byteswap().tobytes()
          and su.to_well_formed_utf16le(le) == le, "to_well_formed_utf16be / valid input")
    check(su.change_endianness_utf16(le) == units.byteswap().tobytes() == be,
          "change_endianness_utf16 differs from numpy's byteswap")

    boms = {"utf-8": b"\xef\xbb\xbf", "utf-16-le": b"\xff\xfe", "utf-32-le": b"\xff\xfe\x00\x00"}
    for codec, d in zip(codecs, (data, le, w32)):
        want = detected(d)
        # the first encoding that decodes (UTF-32LE text with no surrogate
        # in its low halves is valid UTF-16LE too)
        first = next((flag[c] for c in codecs if codec_ok(d, c)), et.unspecified)
        got, auto = su.detect_encodings(d), su.autodetect_encoding(d)
        check(got == want and want & int(flag[codec]) and auto == first,
              f"{codec}: detect {got} (codecs {want}), autodetect {auto!r} ({first!r})")
        with_bom = boms[codec] + d
        check(su.detect_encodings(with_bom) == int(flag[codec])
              and su.autodetect_encoding(with_bom) == flag[codec], f"{codec} with its BOM")
    log("sliceu: detect_encodings and autodetect_encoding of the corpus as UTF-8, UTF-16LE "
        "and UTF-32LE, with and without a BOM, equal to codecs")

    k = len(data) * 2 // 3
    while data[k] & 0xC0 != 0x80:  # cut inside a character
        k += 1
    lead = k - 1
    while data[lead] & 0xC0 == 0x80:
        lead -= 1
    check(su.trim_partial_utf8(data[:k]) == lead and su.trim_partial_utf8(data) == len(data),
          f"trim_partial_utf8 of the corpus cut at {k}")
    hi = int(np.flatnonzero((units & 0xFC00) == 0xD800)[len(units) // 1000])
    check(su.trim_partial_utf16le(units[:hi + 1].tobytes()) == hi
          and su.trim_partial_utf16be(units[:hi + 1].byteswap().tobytes()) == hi,
          "trim_partial_utf16 after a high surrogate")

    raw, mime = mime_corpus(big)
    top = su.maximal_binary_length_from_base64(mime)
    res, out = su.base64_to_binary_safe(mime, top)
    check(res.error == ec.SUCCESS and res.count == len(mime)
          and out == base64.b64decode(mime) == raw, f"base64_to_binary_safe of the MIME corpus {res}")
    small = base64.b64encode(raw[:1000])
    res, out = su.base64_to_binary_safe(small, 500)
    check(res.error == ec.OUTPUT_BUFFER_TOO_SMALL and out == raw[:498]
          and res.count == 664, f"base64_to_binary_safe below the maximal length: {res}")
    log(f"sliceu: trim_partial at a cut character, the endianness swap, and the safe decode of "
        f"{len(mime)} MIME chars (capacity {top}) equal to CPython's base64")
    return launches


def _fixed_injected(big: int):
    """(name, bytes) of class text with out-of-class bytes at 0, at the
    kernels' thread and block steps (16 and 48 bytes a thread, 256
    threads a block) and at length-1, plus a 3- and a 4-byte character
    cut at the length; and (name, native units) of UTF-16 class text with
    out-of-class units likewise."""
    import numpy as np

    size = 100_008
    out8, out16 = [], []
    for ch, bad in (("a", 0x80), ("é", 0x41), ("東", 0xC3), ("\U0001f642", 0x41)):
        base = class_corpus(ch, size)
        for pos in (0, 15, 16, 47, 4095, 4096, 12_287, 12_288, len(base) - 1):
            d = bytearray(base)
            d[pos] = bad
            out8.append((f"{ch}-{bad:#x}@{pos}", bytes(d)))
    out8 += [(f"{ch}-cut@len", class_corpus(ch, size)[:-1]) for ch in ("東", "\U0001f642")]
    for ch, bad in (("a", 0x100), ("é", 0x800), ("東", 0xD800)):
        base = _u16(ch * size)
        for pos in (0, 7, 8, 15, 2047, 2048, 4095, 4096, len(base) - 1):
            d = base.copy()
            d[pos] = bad
            out16.append((f"{ch}-{bad:#x}@{pos}", d))
    return out8, out16


def paritytr_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The seven fixed-rate kernels against their plain versions on
    ``device``, output and flag bit for bit, LE and BE: the four UTF-8 ->
    UTF-16 kernels on every UTF-8 parity input and on class text with
    out-of-class bytes at the thread and block steps, the three UTF-16 ->
    UTF-8 kernels on every UTF-16 parity input and on class units likewise;
    a kernel whose class the census admits must leave its flag clear.
    Returns the largest error seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import transcode as ktr
    from simdutf_tpu_torch.ops import utf8 as o8
    from simdutf_tpu_torch.ops import utf16 as o16

    def record(k, what, kern, plain):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(kern, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {what}: max abs err {e}")

    errs = dict.fromkeys(PASSEST, 0)
    inj8, inj16 = _fixed_injected(big)
    cases8 = parity_cases(big) + [(name, d, len(d) + 13, True) for name, d in inj8]
    admitted = 0
    for name, data, n, garbage in cases8:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        if garbage:
            buf[:] = np.random.default_rng(L).integers(0, 256, n)
        buf[:L] = np.frombuffer(data, np.uint8)
        x = torch.from_numpy(buf).to(device)
        classes = o8.census_full(x, L)[:4]
        for (k, _), cls in zip(FIXED8, classes):
            fn, ref = getattr(ktr, k), getattr(ktr, k + "_ref")
            for be in (False, True):
                got = fn(x, L, be)
                record(k, f"{name} (n={n}, length={L}, be={be})", got, ref(x, L, be))
                check(not cls or int(got[1]) == 0, f"{k} flags {name}, a census class")
                admitted += cls
    cases16 = parity16_cases(big) + [(name, u, len(u) + 13, True) for name, u in inj16]
    for name, units, n, garbage in cases16:
        L = len(units)
        buf = _units_buffer(name, units, n, garbage)
        for be in (False, True):
            stored = buf.byteswap() if be else buf
            w = torch.from_numpy(stored.view(np.int16)).to(device).view(torch.uint16)
            classes = o16.census(w, L, be)[:3]
            for (k, _), cls in zip(FIXED16, classes):
                got = getattr(ktr, k)(w, L, be)
                record(k, f"{name} (n={n}, length={L}, be={be})", got,
                       getattr(ktr, k + "_ref")(w, L, be))
                check(not cls or int(got[1]) == 0, f"{k} flags {name}, a census class")
                admitted += cls
    log(f"paritytr: {len(cases8)} byte buffers and {len(cases16)} unit buffers (LE and BE), "
        f"every fixed-rate kernel's output and flag bit-identical to its plain version; "
        f"flag clear on all {admitted} calls on a census-admitted class")
    return errs


def slicetr_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's api on the 64 MiB ASCII, é, 東 and 🙂 corpora: UTF-8 ->
    UTF-16LE/BE (validating and valid-only) and their UTF-16LE/BE -> UTF-8,
    against CPython's codecs, and Latin-1 -> UTF-16LE/BE of the 64 MiB
    Latin-1 buffer. Each call runs with the counts set to 0 just before it
    and read just after: a class call must launch exactly its census and
    its fixed-rate kernel (no compose kernel; the astral UTF-16 -> UTF-8
    branch, which has no kernel, only its census), the Latin-1 widen
    exactly the ASCII widen kernel. Returns the launches of each fixed-rate kernel
    summed over these calls."""
    from simdutf_tpu_torch import api as su

    su.use_device(device)
    total = dict.fromkeys(PASSEST, 0)

    def launched(call, want: dict):
        got, launches = counted(call)
        check(launches == want, f"launches {launches}, want {want}")
        for k in PASSEST:
            total[k] += launches.get(k, 0)
        return got

    for (k8, ch), k16 in zip(FIXED8, [k for k, _ in FIXED16] + [None]):
        back = {"census_utf16": 1, k16: 1} if k16 else {"census_utf16": 1}
        data = class_corpus(ch, big)
        text = data.decode("utf-8")
        for be, codec in ((False, "utf-16-le"), (True, "utf-16-be")):
            want = text.encode(codec)
            end = "be" if be else "le"
            res, out = launched(lambda: getattr(su, f"convert_utf8_to_utf16{end}_with_errors")(data),
                                {"census_utf8": 1, k8: 1})
            check(res.is_ok and res.count == len(want) // 2 and out == want,
                  f"{ch} utf8 -> {codec}: {res} differs from codecs")
            out = launched(lambda: getattr(su, f"convert_valid_utf8_to_utf16{end}")(data),
                           {"census_utf8": 1, k8: 1})
            check(out == want, f"{ch} valid utf8 -> {codec} differs from codecs")
            res, out = launched(lambda: getattr(su, f"convert_utf16{end}_to_utf8_with_errors")(want),
                                back)
            check(res.is_ok and res.count == len(data) and out == data,
                  f"{ch} {codec} -> utf8: {res} differs from the corpus")
            out = launched(lambda: getattr(su, f"convert_valid_utf16{end}_to_utf8")(want),
                           back)
            check(out == data, f"{ch} valid {codec} -> utf8 differs from the corpus")
        log(f"slicetr: {len(data)} B of {ch!r} -> {len(want) // 2} units LE and BE -> {len(data)} B "
            f"(validating and valid-only) equal codecs; each call launched census + {k8} / "
            f"{k16 or 'no kernel'}")
    lat = latin1_corpus(big)
    for end, codec in (("le", "utf-16-le"), ("be", "utf-16-be")):
        out = launched(lambda: getattr(su, f"convert_latin1_to_utf16{end}")(lat),
                       {"ascii_widen_utf16": 1})
        check(out == lat.decode("latin-1").encode(codec), f"latin1 -> {codec} differs")
    log(f"slicetr: {len(lat)} Latin-1 B -> UTF-16LE/BE equal codecs through ascii_widen_utf16; "
        f"launches {total}")
    return total


def _fixed32_injected():
    """Class text with out-of-class elements at 0, at the UTF-32 kernels'
    thread and block steps (4 code points a thread, 256 threads a block)
    and at length-1, and characters cut at the length: (name, bytes) of
    UTF-8, (name, words) of UTF-32 and (name, native units) of UTF-16."""
    size = 100_008
    out8, out32, out16 = [], [], []
    for ch, bad in (("a", 0x80), ("é", 0x41), ("東", 0xC3), ("\U0001f642", 0x41)):
        base = class_corpus(ch, size)
        for pos in (0, 3, 4, 15, 16, 47, 48, 4095, 4096, 12_287, 12_288, len(base) - 1):
            d = bytearray(base)
            d[pos] = bad
            out8.append((f"{ch}-{bad:#x}@{pos}", bytes(d)))
    out8 += [(f"{ch}-cut@len", class_corpus(ch, size)[:-1]) for ch in ("é", "東", "\U0001f642")]
    for ch, bads in (("é", (0x800, 0x80000000)), ("東", (0xD800, 0xFFFFFFFF)),
                     ("\U0001f642", (0x110000, 0xFFFF))):
        base = _u32(ch * size)
        for i, pos in enumerate((0, 3, 4, 1023, 1024, 4095, 4096, len(base) - 1)):
            d = base.copy()
            d[pos] = bads[i % 2]
            out32.append((f"{ch}-{bads[i % 2]:#x}@{pos}", d))
    for ch, bad in (("東", 0xDC00), ("\U0001f642", 0x41)):
        base = _u16(ch * size)
        for pos in (0, 3, 4, 7, 8, 2047, 2048, 4095, 4096, len(base) - 1):
            d = base.copy()
            d[pos] = bad
            out16.append((f"{ch}-{bad:#x}@{pos}", d))
    out16.append(("\U0001f642-cut@len", _u16("\U0001f642" * size)[:-1]))
    return out8, out32, out16


def paritytr32_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The eleven UTF-32 fixed-rate kernels against their plain versions
    on ``device``, output and flag bit for bit: the four UTF-8 -> UTF-32
    kernels on every UTF-8 parity input, the five from UTF-32 on every
    UTF-32 parity input (UTF-16 output LE and BE), the two UTF-16 ->
    UTF-32 kernels on every UTF-16 parity input (LE and BE), and class
    text with out-of-class elements at the thread and block steps; a
    kernel whose class the census admits must leave its flag clear.
    Returns the largest error seen per kernel (all must be 0)."""
    import numpy as np
    import torch

    from simdutf_tpu_torch.kernels import transcode32 as k32
    from simdutf_tpu_torch.ops import utf8 as o8
    from simdutf_tpu_torch.ops import utf16 as o16
    from simdutf_tpu_torch.ops import utf32 as o32

    def record(k, what, cls, args):
        got = getattr(k32, k)(*args)
        plain = getattr(k32, k + "_ref")(*args)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(got, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {what}: max abs err {e}")
        check(not cls or int(got[1]) == 0, f"{k} flags {what}, a census class")
        return int(cls)

    errs = dict.fromkeys(PASSEST32, 0)
    inj8, inj32, inj16 = _fixed32_injected()
    admitted = 0
    cases8 = parity_cases(big) + [(name, d, len(d) + 13, True) for name, d in inj8]
    for name, data, n, garbage in cases8:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        if garbage:
            buf[:] = np.random.default_rng(L).integers(0, 256, n)
        buf[:L] = np.frombuffer(data, np.uint8)
        x = torch.from_numpy(buf).to(device)
        for (k, _), cls in zip(FIXED8TO32, o8.census_full(x, L)[:4]):
            admitted += record(k, f"{name} (n={n}, length={L})", cls, (x, L))
    cases32 = parity32_cases(big) + [(name, w, len(w) + 13, True) for name, w in inj32]
    for name, words, n, garbage in cases32:
        L = len(words)
        w = torch.from_numpy(_words_buffer(name, words, n, garbage).view(np.int32)).to(device)
        _, u2, u3, astral, bmp = o32.census(w, L)
        what = f"{name} (n={n}, length={L})"
        for (k, _), cls in zip(FIXED32TO8, (u2, u3, astral)):
            admitted += record(k, what, cls, (w, L))
        for be in (False, True):
            for (k, _), cls in zip(FIXED32TO16, (bmp, astral)):
                admitted += record(k, f"{what}, be={be}", cls, (w, L, be))
    cases16 = parity16_cases(big) + [(name, u, len(u) + 13, True) for name, u in inj16]
    for name, units, n, garbage in cases16:
        L = len(units)
        buf = _units_buffer(name, units, n, garbage)
        for be in (False, True):
            stored = buf.byteswap() if be else buf
            w = torch.from_numpy(stored.view(np.int16)).to(device).view(torch.uint16)
            for (k, _), cls in zip(FIXED16TO32, o16.census32(w, L, be)):
                admitted += record(k, f"{name} (n={n}, length={L}, be={be})", cls, (w, L, be))
    log(f"paritytr32: {len(cases8)} byte, {len(cases32)} word and {len(cases16)} unit buffers "
        f"(LE and BE), every UTF-32 fixed-rate kernel's output and flag bit-identical to its "
        f"plain version; flag clear on all {admitted} calls on a census-admitted class")
    return errs


def slicetr32_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The port's api on the 64 MiB ASCII, é, 東 and 🙂 corpora: UTF-8 ->
    UTF-32 -> UTF-8 and UTF-16LE/BE <-> UTF-32 (validating and valid-only),
    and Latin-1 -> UTF-32 of the 64 MiB Latin-1 buffer, against CPython's
    codecs. Each call runs with the counts set to 0 just before it and read
    just after: a class call must launch exactly its census and its
    fixed-rate kernel (the UTF-32 census counts its ``utf32_first_bad``
    pass; ASCII back to UTF-8 has no kernel, only its census), Latin-1 ->
    UTF-32 exactly the Latin-1 widen. Returns the launches of each kernel
    summed over these calls."""
    from simdutf_tpu_torch import api as su

    su.use_device(device)
    total = dict.fromkeys(PASSEST32, 0)

    def launched(call, want: dict):
        got, launches = counted(call)
        check(launches == want, f"launches {launches}, want {want}")
        for k in PASSEST32:
            total[k] += launches.get(k, 0)
        return got

    from8 = {ch: k for k, ch in FIXED8TO32}
    to8 = {ch: k for k, ch in FIXED32TO8}
    for ch in from8:
        data = class_corpus(ch, big)
        text = data.decode("utf-8")
        w32 = text.encode("utf-32-le")
        fwd = {"census_utf8": 1, from8[ch]: 1}
        res, out = launched(lambda: su.convert_utf8_to_utf32_with_errors(data), fwd)
        check(res.is_ok and res.count == len(w32) // 4 and out == w32,
              f"{ch} utf8 -> utf32: {res} differs from codecs")
        check(launched(lambda: su.convert_valid_utf8_to_utf32(data), fwd) == w32,
              f"{ch} valid utf8 -> utf32 differs from codecs")
        back = {"utf32_first_bad": 1, **({to8[ch]: 1} if ch in to8 else {})}
        res, out = launched(lambda: su.convert_utf32_to_utf8_with_errors(w32), back)
        check(res.is_ok and res.count == len(data) and out == data,
              f"{ch} utf32 -> utf8: {res} differs from the corpus")
        check(launched(lambda: su.convert_valid_utf32_to_utf8(w32), back) == data,
              f"{ch} valid utf32 -> utf8 differs from the corpus")
        bmp = ch != "\U0001f642"
        k16 = {"census_utf16": 1, "bmp_widen_utf32" if bmp else "astral_utf16_to_utf32": 1}
        k32 = {"utf32_first_bad": 1, "bmp_narrow_utf16" if bmp else "astral_utf32_to_utf16": 1}
        for end, codec in (("le", "utf-16-le"), ("be", "utf-16-be")):
            u16 = text.encode(codec)
            res, out = launched(
                lambda: getattr(su, f"convert_utf16{end}_to_utf32_with_errors")(u16), k16)
            check(res.is_ok and res.count == len(w32) // 4 and out == w32,
                  f"{ch} {codec} -> utf32: {res} differs from codecs")
            check(launched(lambda: getattr(su, f"convert_valid_utf16{end}_to_utf32")(u16), k16)
                  == w32, f"{ch} valid {codec} -> utf32 differs from codecs")
            res, out = launched(
                lambda: getattr(su, f"convert_utf32_to_utf16{end}_with_errors")(w32), k32)
            check(res.is_ok and res.count == len(u16) // 2 and out == u16,
                  f"{ch} utf32 -> {codec}: {res} differs from codecs")
            check(launched(lambda: getattr(su, f"convert_valid_utf32_to_utf16{end}")(w32), k32)
                  == u16, f"{ch} valid utf32 -> {codec} differs from codecs")
        log(f"slicetr32: {len(data)} B of {ch!r} -> {len(w32) // 4} words -> {len(data)} B, "
            f"UTF-16LE/BE <-> UTF-32 (validating and valid-only) equal codecs; each call "
            f"launched its census + {from8[ch]} / {to8.get(ch, 'no kernel')} / "
            f"{next(iter(k16.keys() - {'census_utf16'}))} / "
            f"{next(iter(k32.keys() - {'utf32_first_bad'}))}")
    lat = latin1_corpus(big)
    out = launched(lambda: su.convert_latin1_to_utf32(lat), {"latin1_widen_utf32": 1})
    check(out == lat.decode("latin-1").encode("utf-32-le"), "latin1 -> utf32 differs")
    log(f"slicetr32: {len(lat)} Latin-1 B -> UTF-32 equal codecs through latin1_widen_utf32; "
        f"launches {total}")
    return total


def _swar_injected():
    """(name, bytes, buffer size, garbage past the length) for the SWAR
    parity: errors at the word, thread (16 bytes) and block (4096 bytes)
    steps of the kernel and at the last byte, a 4-byte sequence cut at the
    length, and stale bytes >= 0x80 stored past the length."""
    import bench

    base = _whole(bench.mixed_corpus(300_000)[:100_000])
    out = []
    for pos in (3, 4, 15, 16, 17, 4095, 4096, 4097, 12_288, len(base) - 1):
        for bad in (b"\xff", b"\x80", b"\xed\xa0\x80", b"\xc0\xaf"):
            d = bytearray(base)
            d[pos:pos + len(bad)] = bad
            d = bytes(d[:len(base)])
            out.append((f"{bad.hex()}@{pos}", d, len(d), False))
    cut = _whole(base[:50_001]) + "\U0001f642".encode()[:3]
    out.append(("cut4@len", cut, len(cut) + 1, False))
    out.append(("A*32767-cut4", b"A" * 32767 + b"\xf0\x9f\x98", 32_770, False))
    out.append(("stale@len", base[:60_000], 60_016, True))
    return out


def parityp_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The pallas tier's six kernels against their plain versions on
    ``device``: the UTF-8 and ASCII SWAR scans on every UTF-8 parity input,
    on errors at the kernel's word, thread and block steps, at the last
    byte, a cut sequence and stale bytes past the length, and on a 64 MiB
    ASCII buffer with and without a byte >= 0x80 near its end; the UTF-16
    SWAR scan on every UTF-16 parity input (LE and BE); clean_decode on the
    whitespace-free base64 of the corpus's first 3/4 under the three
    alphabets, and with a '=' and a ' ' injected; row_compact at (131072,
    128) and (8192, 1024), keep density 0.4; the probe for salts 1-3.
    Returns the largest error seen per kernel (all must be 0)."""
    import base64

    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch.kernels import base64_kernel as kb64
    from simdutf_tpu_torch.kernels import compaction as kcmp
    from simdutf_tpu_torch.kernels import swar as ksw
    from simdutf_tpu_torch.kernels import validate as kv

    def record(k, what, kern, plain):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        e = _max_err(kern, plain)
        errs[k] = max(errs[k], e)
        check(e == 0, f"parity {k} on {what}: max abs err {e}")

    errs = dict.fromkeys(PASSESP, 0)
    high_end = bytearray(b"a" * big)
    high_end[-5] = 0xE9
    cases8 = parity_cases(big) + _swar_injected() + [
        ("ascii-64MiB", b"a" * big, big + 8, False),
        ("ascii-64MiB-e9@end-5", bytes(high_end), big + 8, True)]
    flagged = 0
    for name, data, n, garbage in cases8:
        L = len(data)
        buf = np.zeros(n, np.uint8)
        if garbage:
            buf[:] = np.random.default_rng(L).integers(0x80, 0x100, n)
        buf[:L] = np.frombuffer(data, np.uint8)
        x = torch.from_numpy(buf).to(device)
        what = f"{name} (n={n}, length={L})"
        got = ksw.utf8_swar_first_bad_word(x, L)
        record("utf8_swar_first_bad_word", what, got, ksw.utf8_swar_first_bad_word_ref(x, L))
        flagged += int(got) != ksw.BIG
        record("ascii_swar_first_bad_word", what, ksw.ascii_swar_first_bad_word(x, L),
               ksw.ascii_swar_first_bad_word_ref(x, L))
    cases16 = parity16_cases(big)
    for name, units, n, garbage in cases16:
        L = len(units)
        buf = _units_buffer(name, units, n, garbage)
        for be in (False, True):
            stored = buf.byteswap() if be else buf
            w = torch.from_numpy(stored.view(np.int16)).to(device).view(torch.uint16)
            record("utf16_swar_first_bad_word", f"{name} (n={n}, length={L}, be={be})",
                   ksw.utf16_swar_first_bad_word(w, L, be),
                   ksw.utf16_swar_first_bad_word_ref(w, L, be))
    log(f"parityp: {len(cases8)} byte buffers ({flagged} flagged by the UTF-8 scan) and "
        f"{len(cases16)} unit buffers (LE and BE), the three SWAR scans bit-identical to "
        f"their plain versions")

    raw = bench.mixed_corpus(big)[: big * 3 // 4]
    clean = np.frombuffer(base64.b64encode(raw), np.uint8)
    variants = [("std", clean, False, False), ("std-both", clean, False, True),
                ("url", np.frombuffer(base64.urlsafe_b64encode(raw), np.uint8), True, False)]
    for ch, at in ((b"=", len(clean) // 3), (b" ", len(clean) - 7)):
        d = clean.copy()
        d[at] = ord(ch)
        variants.append((f"{ch.decode()!r}@{at}", d, False, False))
    for name, chars, url, both in variants:
        x = torch.from_numpy(chars.copy()).to(device)
        got = kb64.clean_decode(x, len(chars) // 4, url, both)
        record("clean_decode", f"{name} ({len(chars)} chars)", got,
               kb64.clean_decode_ref(x, len(chars) // 4, url, both))
        check(int(got[1]) == ("@" in name), f"clean_decode flag on {name}: {int(got[1])}")
        if name == "std":
            check(got[0].cpu().numpy().tobytes() == raw, "clean_decode differs from the raw bytes")
        del x, got
    log(f"parityp: clean_decode of {len(clean)} chars (default, both, url; '=' and ' ' "
        f"injected) bit-identical to its plain version, the flag set on the dirty ones only")

    rng = np.random.default_rng(SEED + 46)
    for rows, width in ((131_072, 128), (8192, 1024)):
        val = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, width)).astype(np.int32)).to(device)
        keep = torch.from_numpy(rng.random((rows, width)) < 0.4).to(device)
        record("row_compact", f"({rows}, {width})", kcmp.row_compact(val, keep),
               kcmp.row_compact_ref(val, keep))
    tile = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 512)).astype(np.int32)).to(device)
    for salt in (1, 2, 3):
        record("lane_shapecast_probe", f"salt {salt}", kv.lane_shapecast_probe(tile, salt),
               kv.lane_shapecast_probe_ref(tile, salt))
    log("parityp: row_compact at (131072, 128) and (8192, 1024), keep density 0.4, and the "
        "probe for salts 1-3 bit-identical to their plain versions")
    return errs


def slicep_phase(device, big: int = CORPUS_BYTES) -> dict:
    """The pallas tier's api on ``device``, through
    ``use_device(TorchPallasImplementation(device))``: UTF-8 validation of
    the 64 MiB corpus, clean and with 0xFF 60 MiB in; ASCII validation and
    UTF-8 -> Latin-1 of a 64 MiB ASCII buffer (validation also with a byte
    >= 0x80 near its end); UTF-16LE/BE validation of the corpus's units,
    clean and with a lone low surrogate; base64 decode of the
    whitespace-free base64 of the corpus's first 3/4 (the clean route) and
    of its MIME form (the forgiving route); ``internal_tests``. Each result
    is held against ``TorchImplementation(device)`` and CPython; each call
    runs with the counts set to 0 just before it and read just after: a
    validation launches exactly its SWAR scan (no safety net), the clean
    decode exactly ``clean_decode`` (no ``b64_compact``). Returns the
    launches of the six kernels summed over these calls."""
    import base64

    import numpy as np

    import bench
    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch.errors import error_code as ec
    from simdutf_tpu_torch.impl import TorchImplementation
    from simdutf_tpu_torch.kernels.impl import TorchPallasImplementation

    tier = su.use_device(TorchPallasImplementation(device))
    plain = TorchImplementation(device)
    total = dict.fromkeys(PASSESP, 0)

    def launched(call, want):
        got, launches = counted(call)
        check(want is None or launches == want, f"launches {launches}, want {want}")
        for k in PASSESP:
            total[k] += launches.get(k, 0)
        return got, launches

    def codec_error(d: bytes, codec: str):
        try:
            d.decode(codec)
            return None
        except UnicodeDecodeError as exc:
            return exc.start

    data = bench.mixed_corpus(big)
    k8 = lead_at(data, min(60 * MIB, len(data) * 15 // 16))
    bad8 = data[:k8] + b"\xff" + data[k8 + 1:]
    swar8 = {"utf8_swar_first_bad_word": 1}
    for what, d, want in (("corpus", data, (ec.SUCCESS, len(data))),
                          ("corpus with 0xFF 60 MiB in", bad8, (ec.HEADER_BITS, k8))):
        res, _ = launched(lambda: su.validate_utf8_with_errors(d), swar8)
        ok, _ = launched(lambda: su.validate_utf8(d), swar8)
        ref = plain.validate_utf8_with_errors(np.frombuffer(d, np.uint8))
        check(tuple(res) == want == tuple(ref) and ok == res.is_ok
              and codec_error(d, "utf-8") == (None if ok else k8),
              f"validate_utf8 of the {what}: {res}, TorchImplementation {ref}, want {want}")
    log(f"slicep: validate_utf8(_with_errors) of {len(data)} B, clean and with 0xFF at {k8}: "
        f"= TorchImplementation and CPython, one SWAR launch a call")

    asc = class_corpus("a", big)
    asc_bad = asc[:big - 5] + b"\x80" + asc[big - 4:]
    swara = {"ascii_swar_first_bad_word": 1}
    for what, d, want in (("ASCII buffer", asc, (ec.SUCCESS, big)),
                          ("ASCII buffer with 0x80 at its end - 5", asc_bad, (ec.TOO_LARGE, big - 5))):
        res, _ = launched(lambda: su.validate_ascii_with_errors(d), swara)
        ref = plain.validate_ascii_with_errors(np.frombuffer(d, np.uint8))
        check(tuple(res) == want == tuple(ref)
              and codec_error(d, "ascii") == (None if res.is_ok else big - 5),
              f"validate_ascii of the {what}: {res}, TorchImplementation {ref}")
    (res, out), _ = launched(lambda: su.convert_utf8_to_latin1_with_errors(asc), swara)
    want_res, want_out = plain.convert_utf8_to_latin1_with_errors(np.frombuffer(asc, np.uint8))
    check(res == want_res == (ec.SUCCESS, big)
          and out == want_out.tobytes() == asc.decode("utf-8").encode("latin-1"),
          f"convert_utf8_to_latin1 of the ASCII buffer: {res}")
    log(f"slicep: validate_ascii of {big} B of ASCII, clean and with 0x80 at {big - 5}, and "
        f"convert_utf8_to_latin1 of it (a copy): = TorchImplementation and CPython")

    units = np.frombuffer(data.decode("utf-8").encode("utf-16-le"), np.uint16)
    bad16 = units.copy()
    k16 = len(bad16) * 3 // 5
    while (bad16[k16 - 1] & 0xFC00) == 0xD800 or (bad16[k16] & 0xF800) == 0xD800:
        k16 += 1
    bad16[k16] = 0xDC00
    for what, u, want in (("units", units, (ec.SUCCESS, len(units))),
                          (f"units with a lone low at {k16}", bad16, (ec.SURROGATE, k16))):
        for end, be in (("le", False), ("be", True)):
            stored = u.byteswap() if be else u
            res, _ = launched(
                lambda: getattr(su, f"validate_utf16{end}_with_errors")(stored.tobytes()),
                {"utf16_swar_first_bad_word": 1})
            ref = plain._validate16(stored, be)
            at = codec_error(stored.tobytes(), f"utf-16-{end}")
            check(tuple(res) == want == tuple(ref)
                  and at == (None if res.is_ok else 2 * k16),
                  f"validate_utf16{end} of the {what}: {res}, TorchImplementation {ref}")
    log(f"slicep: validate_utf16le/be of {len(units)} units, clean and with a lone low at "
        f"{k16}: = TorchImplementation and CPython, one SWAR launch a call")

    raw, mime = mime_corpus(big)
    clean = base64.b64encode(raw)
    (full, out), _ = launched(lambda: su.base64_to_binary_details(clean), {"clean_decode": 1})
    ref_full, ref_out = plain.base64_to_binary_details(np.frombuffer(clean, np.uint8))
    check(full == ref_full and full.is_ok and out == ref_out.tobytes() == raw,
          f"clean base64 decode {full}, TorchImplementation {ref_full}")
    (full, out), mime_launches = launched(lambda: su.base64_to_binary_details(mime), None)
    ref_full, ref_out = plain.base64_to_binary_details(np.frombuffer(mime, np.uint8))
    check(full == ref_full and full.is_ok and out == ref_out.tobytes() == raw
          and mime_launches.get("b64_compact8", 0) > 0,
          f"MIME base64 decode {full}, TorchImplementation {ref_full}, launches {mime_launches}")
    log(f"slicep: base64 of {len(raw)} B = base64.b64decode: clean ({len(clean)} chars) through "
        f"clean_decode alone, MIME ({len(mime)} chars) through the forgiving route "
        f"(launches {mime_launches}); both = TorchImplementation")

    checks, launches = launched(lambda: [(name, fn()) for name, fn in tier.internal_tests()],
                                None)
    log(f"slicep: internal_tests {[name for name, _ in checks]} passed; launches {launches}")
    check(tier.safety_net == 0, f"the SWAR safety net was entered {tier.safety_net} times")
    for k in PASSESP:
        check(total[k] > 0, f"kernel {k} did not launch on the main path")
    log(f"slicep: safety net entered {tier.safety_net} times; launches {total}")
    su.use_device(device)
    return total


def cuda_ms(fn, iters: int = 10, trials: int = 7) -> float:
    """Median over trials of the mean time of ``iters`` calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def note_call(call, what: str, card: str) -> None:
    """Log the ms by events of a PyTorch call that computes a different
    function from the kernel beside it: a note, never a library yardstick."""
    log(f"time note {what}: {cuda_ms(call):.4f} ms (a different function: no yardstick) "
        f"[{card}]")


def _time_pairs(pairs: dict, nbytes: int, card: str) -> dict:
    """{name: (kernel ms, plain ms)} of each (kernel, plain) pair, timed in
    turns; ``nbytes`` is the input size for the GB/s figures."""
    ms = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: the pair shares one card and state
        p1 = cuda_ms(plain, iters=3, trials=3)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain, iters=3, trials=3)
        ms[name] = (statistics.median([k1, k2]), statistics.median([p1, p2]))
        log(f"time {name}: kernel {ms[name][0]:.4f} ms "
            f"({nbytes / ms[name][0] / 1e6:.1f} GB/s in), plain torch "
            f"{ms[name][1]:.4f} ms ({nbytes / ms[name][1] / 1e6:.1f} GB/s in) "
            f"[{card}]")
    return ms


def times_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict]:
    """ms of each kernel and of its plain version at the main paths'
    shapes (the 64 MiB mixed corpus, and its UTF-16LE encoding,
    device-resident), and the bytes each kernel must move."""
    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import compose8 as kc8
    from simdutf_tpu_torch.kernels import compose16 as kc
    from simdutf_tpu_torch.kernels import utf16_kernels as k16
    from simdutf_tpu_torch.kernels import validate as kv
    from simdutf_tpu_torch.ops import utf8 as o8
    from simdutf_tpu_torch.ops import utf16 as o16

    data = bench.mixed_corpus(big)
    x, L = impl.to_device(*impl._pad(np.frombuffer(data, np.uint8)), "cuda")
    units = np.frombuffer(data.decode("utf-8").encode("utf-16-le"), np.uint16)
    w, U = impl.to_device(*impl._pad(units), "cuda")
    torch.cuda.synchronize()

    def plain_to_utf16():
        int(kcen.census_bits_ref(x, L))  # the route's one sync
        return kc.to_utf16_compose_ref(x, L, False)

    def plain_to_utf8():
        int(kcen.census16_bits_ref(w, U, False))  # the route's one sync
        return kc8.to_utf8_compose_ref(w, U, False)

    ms = _time_pairs({
        "census_utf8": (lambda: kcen.census_bits(x, L),
                        lambda: kcen.census_bits_ref(x, L)),
        "utf8_first_event": (lambda: kv.utf8_first_event_len(x, L),
                             lambda: kv.utf8_first_event_len_ref(x, L)),
        "utf8_count": (lambda: kv.utf8_count(x, L),
                       lambda: kv.count_ref(x, L, "count")),
        "compose16": (lambda: kc.to_utf16_compose(x, L, False),
                                  lambda: kc.to_utf16_compose_ref(x, L, False)),
        "to_utf16 (ops.utf8, routed)": (lambda: o8.to_utf16(x, L, False),
                                        plain_to_utf16),
    }, L, card)
    ms.update(_time_pairs({
        "census_utf16": (lambda: kcen.census16_bits(w, U, False),
                         lambda: kcen.census16_bits_ref(w, U, False)),
        "utf16_first_bad": (lambda: k16.utf16_first_bad(w, U, False),
                            lambda: k16.utf16_first_bad_ref(w, U, False)),
        "utf16_count": (lambda: k16.utf16_reduce(w, U, False, "utf8len"),
                        lambda: k16.utf16_reduce_ref(w, U, False, "utf8len")),
        "utf16_to_utf8_compose": (lambda: kc8.to_utf8_compose(w, U, False),
                                  lambda: kc8.to_utf8_compose_ref(w, U, False)),
        "to_utf8 (ops.utf16, routed)": (lambda: o16.to_utf8(w, U, False),
                                        plain_to_utf8),
    }, 2 * U, card))
    breakdown(lambda: o8.to_utf16(x, L, False), "to_utf16 (mixed 64 MiB)", card)
    breakdown(lambda: o16.to_utf8(w, U, False),
              f"to_utf8 (mixed 64 MiB as UTF-16LE, {U} units)", card)
    # bytes each kernel must move: its input read once, its whole output
    # buffer written once
    moved = {"census_utf8": L, "utf8_first_event": L, "utf8_count": L,
             "compose16": L + 2 * x.numel(),
             "census_utf16": 2 * U, "utf16_first_bad": 2 * U,
             "utf16_count": 2 * U, "utf16_to_utf8_compose": 2 * U + 3 * w.numel()}
    return ms, moved


def copy_phase(card: str, nbytes: int = 256 * MIB) -> float:
    """The card's device-to-device copy rate, bytes read + written per
    second, on a buffer five times the L2 cache."""
    import torch

    x = torch.ones(nbytes, dtype=torch.uint8, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: y.copy_(x))
    log(f"time d2d copy of {nbytes} B: {ms:.4f} ms, "
        f"{2 * nbytes / ms / 1e6:.1f} GB/s read+write [{card}]")
    return 2 * nbytes / ms * 1e3


def times64_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict]:
    """ms of each base64 kernel and of its plain version at the base64
    path's shapes (the MIME corpus in its bucket, device-resident; its
    dense codes; the raw bytes), of the routed decode and the encode, and
    the public api's decode and encode on the host clock."""
    import numpy as np
    import torch

    from simdutf_tpu_torch import api as su
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import base64_kernel as kb
    from simdutf_tpu_torch.kernels import compact64 as kc64
    from simdutf_tpu_torch.ops import base64_ops as ob

    raw, mime = mime_corpus(big)
    x, L = impl.to_device(*impl._pad(np.frombuffer(mime, np.uint8)), "cuda")
    r, R = impl.to_device(*impl._pad(np.frombuffer(raw, np.uint8), 1536), "cuda")
    codes = kc64.compact_codes(x, L, False, False)[0]
    torch.cuda.synchronize()
    ms = _time_pairs({
        "b64_compact8": (lambda: kc64.compact_codes(x, L, False, False),
                        lambda: kc64.compact_codes_ref(x, L, False, False)),
        "b64_pack": (lambda: kb.pack(codes), lambda: kb.pack_ref(codes)),
        "decode (ops.base64_ops, routed)": (
            lambda: ob.decode_bulk_routed(x, L, False, False),
            lambda: kb.pack_ref(kc64.compact_codes_ref(x, L, False, False)[0])),
    }, L, card)
    ms.update(_time_pairs({
        "b64_encode": (lambda: kb.encode(r, False), lambda: kb.encode_ref(r, False)),
        "encode (ops.base64_ops.encode_bulk)": (lambda: ob.encode_bulk(r, False),
                                                lambda: ob.encode_small(r, False)),
    }, r.numel(), card))
    for what, fn, nbytes in (("base64_to_binary", lambda: su.base64_to_binary(mime), L),
                             ("binary_to_base64", lambda: su.binary_to_base64(raw), R)):
        fn()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        log(f"time api.{what} (host clock, bytes in and out of host "
            f"memory): {statistics.median(host):.2f} ms, "
            f"{nbytes / statistics.median(host) / 1e6:.2f} GB/s in [{card}]")
    breakdown(lambda: ob.decode_bulk_routed(x, L, False, False),
              f"base64 decode (MIME, {L} chars)", card)
    moved = {"b64_compact8": L + x.numel(),
             "b64_pack": codes.numel() + codes.numel() // 4 * 3,
             "b64_encode": r.numel() + r.numel() // 3 * 4}
    return ms, moved


def times32_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict]:
    """ms of each UTF-32 kernel and of its plain version at the UTF-32
    paths' shapes (the 64 MiB mixed corpus and its UTF-32LE form in a
    64 Mi-word bucket, device-resident), of both routed transcodes, with
    a torch.profiler breakdown of each."""
    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import compose32 as kc32
    from simdutf_tpu_torch.kernels import composex as kcx
    from simdutf_tpu_torch.kernels import validate as kv
    from simdutf_tpu_torch.ops import utf8 as o8
    from simdutf_tpu_torch.ops import utf32 as o32

    data = bench.mixed_corpus(big)
    x, L = impl.to_device(*impl._pad(np.frombuffer(data, np.uint8)), "cuda")
    words = np.frombuffer(data.decode("utf-8").encode("utf-32-le"), np.uint32)
    w, W = impl.to_device(*impl._pad(words), "cuda")
    torch.cuda.synchronize()

    def plain_to_utf32():
        int(kcen.census_bits_ref(x, L))  # the route's one sync
        return kc32.to_utf32_compose_ref(x, L)

    def plain_to_utf8():
        lo, hi = torch.aminmax(w[:W])  # the census, with its one sync
        torch.stack([lo.to(torch.int64), hi.to(torch.int64),
                     kv.utf32_first_bad_ref(w, W)]).tolist()
        return kcx.u32_to_utf8_compose_ref(w, W)

    ms = _time_pairs({
        "utf32_first_bad": (lambda: kv.utf32_first_bad(w, W),
                            lambda: kv.utf32_first_bad_ref(w, W)),
        "utf32_count": (lambda: kv.utf32_count(w, W, "utf8len"),
                        lambda: kv.utf32_count_ref(w, W, "utf8len")),
        "utf32_to_utf8_compose": (lambda: kcx.u32_to_utf8_compose(w, W),
                                  lambda: kcx.u32_to_utf8_compose_ref(w, W)),
        "to_utf8 (ops.utf32, routed)": (lambda: o32.to_utf8(w, W), plain_to_utf8),
    }, 4 * W, card)
    ms.update(_time_pairs({
        "compose32": (lambda: kc32.to_utf32_compose(x, L),
                                  lambda: kc32.to_utf32_compose_ref(x, L)),
        "to_utf32 (ops.utf8, routed)": (lambda: o8.to_utf32(x, L), plain_to_utf32),
    }, L, card))
    breakdown(lambda: o8.to_utf32(x, L), f"to_utf32 (mixed 64 MiB, {L} B)", card)
    breakdown(lambda: o32.to_utf8(w, W),
              f"utf32 to_utf8 (mixed 64 MiB as UTF-32LE, {W} words)", card)
    moved = {"utf32_first_bad": 4 * W, "utf32_count": 4 * W,
             "compose32": L + 4 * x.numel(),
             "utf32_to_utf8_compose": 4 * W + 4 * w.numel()}
    return ms, moved


def timesx_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict]:
    """ms of each butterflyx kernel of this slice and of its plain version
    at the paths' shapes (the corpus's UTF-16LE units and UTF-32LE words,
    the 64 MiB Latin-1 buffer, device-resident), of the three routed
    calls, with a torch.profiler breakdown of each."""
    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import composex as kcx
    from simdutf_tpu_torch.kernels import validate as kv
    from simdutf_tpu_torch.ops import latin1 as ol1
    from simdutf_tpu_torch.ops import utf16 as o16
    from simdutf_tpu_torch.ops import utf32 as o32

    text = bench.mixed_corpus(big).decode("utf-8")
    w16, U = impl.to_device(*impl._pad(np.frombuffer(text.encode("utf-16-le"), np.uint16)),
                            "cuda")
    w32, W = impl.to_device(*impl._pad(np.frombuffer(text.encode("utf-32-le"), np.uint32)),
                            "cuda")
    lat, B = impl.to_device(*impl._pad(np.frombuffer(latin1_corpus(big), np.uint8)), "cuda")
    torch.cuda.synchronize()

    def plain_to_utf32():
        int(kcen.census16_bits_ref(w16, U, False))  # the route's one sync
        return kcx.u16_to_utf32_compose_ref(w16, U, False)

    def plain_to_utf16():
        lo, hi = torch.aminmax(w32[:W])  # the census, with its one sync
        torch.stack([lo.to(torch.int64), hi.to(torch.int64),
                     kv.utf32_first_bad_ref(w32, W)]).tolist()
        return kcx.u32_to_utf16_compose_ref(w32, W, False)

    def plain_latin1():
        int(kcen.census_bits_ref(lat, B))  # the route's one sync
        return kcx.latin1_to_utf8_compose_ref(lat, B)

    ms = _time_pairs({
        "utf16_to_utf32_compose": (lambda: kcx.u16_to_utf32_compose(w16, U, False),
                                   lambda: kcx.u16_to_utf32_compose_ref(w16, U, False)),
        "to_utf32 (ops.utf16, routed)": (lambda: o16.to_utf32(w16, U, False),
                                         plain_to_utf32),
    }, 2 * U, card)
    ms.update(_time_pairs({
        "utf32_to_utf16_compose": (lambda: kcx.u32_to_utf16_compose(w32, W, False),
                                   lambda: kcx.u32_to_utf16_compose_ref(w32, W, False)),
        "to_utf16 (ops.utf32, routed)": (lambda: o32.to_utf16(w32, W, False),
                                         plain_to_utf16),
    }, 4 * W, card))
    ms.update(_time_pairs({
        "latin1_to_utf8_compose": (lambda: kcx.latin1_to_utf8_compose(lat, B),
                                   lambda: kcx.latin1_to_utf8_compose_ref(lat, B)),
        "to_utf8 (ops.latin1, routed)": (lambda: ol1.to_utf8(lat, B), plain_latin1),
    }, B, card))
    breakdown(lambda: o16.to_utf32(w16, U, False),
              f"utf16 to_utf32 (mixed 64 MiB as UTF-16LE, {U} units)", card)
    breakdown(lambda: o32.to_utf16(w32, W, False),
              f"utf32 to_utf16 (mixed 64 MiB as UTF-32LE, {W} words)", card)
    breakdown(lambda: ol1.to_utf8(lat, B), f"latin1 to_utf8 ({B} B)", card)
    moved = {"utf16_to_utf32_compose": 2 * U + 4 * w16.numel(),
             "utf32_to_utf16_compose": 4 * W + 2 * 2 * w32.numel(),
             "latin1_to_utf8_compose": B + 2 * lat.numel()}
    return ms, moved


def timesu_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict, dict]:
    """ms of each utilities kernel and of its plain version at its path's
    shapes: ascii_first_bad on a 64 MiB ASCII buffer (every byte read),
    with ``torch.amax`` over the same bytes as a note (a yes/no, not the
    position: no yardstick); utf16_to_well_formed on the corpus's
    UTF-16LE units in their 64 Mi-unit bucket; detect_encodings on the
    64 MiB corpus and on its UTF-32LE bytes; a torch.profiler breakdown of
    each, for the device time under the wrappers' host pace."""
    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import detect_kernel as kdet
    from simdutf_tpu_torch.kernels import utf16_kernels as k16
    from simdutf_tpu_torch.kernels import validate as kv

    data = bench.mixed_corpus(big)
    text = data.decode("utf-8")
    a, A = impl.to_device(*impl._pad(np.frombuffer(class_corpus("a", big), np.uint8)), "cuda")
    x, L = impl.to_device(*impl._pad(np.frombuffer(data, np.uint8)), "cuda")
    w, U = impl.to_device(*impl._pad(np.frombuffer(text.encode("utf-16-le"), np.uint16)), "cuda")
    b32, B = impl.to_device(*impl._pad(np.frombuffer(text.encode("utf-32-le"), np.uint8)), "cuda")
    torch.cuda.synchronize()
    ms = _time_pairs({
        "ascii_first_bad": (lambda: kv.ascii_first_bad(a, A), lambda: kv.ascii_first_bad_ref(a, A)),
    }, A, card)
    note_call(lambda: torch.amax(a[:A]), f"torch.amax over the {A} B ASCII buffer (a yes/no, "
              f"not ascii_first_bad's position)", card)
    library = {}
    ms.update(_time_pairs({
        "utf16_to_well_formed": (lambda: k16.utf16_to_well_formed(w, U, False),
                                 lambda: k16.utf16_to_well_formed_ref(w, U, False)),
    }, 2 * U, card))
    ms.update(_time_pairs({
        "detect_encodings": (lambda: kdet.detect_fused(x, L), lambda: kdet.detect_fused_ref(x, L)),
    }, L, card))
    _time_pairs({
        f"detect_encodings (UTF-32LE bytes, {B} B)": (lambda: kdet.detect_fused(b32, B),
                                                      lambda: kdet.detect_fused_ref(b32, B)),
    }, B, card)
    breakdown(lambda: kv.ascii_first_bad(a, A), f"ascii_first_bad ({A} B ASCII)", card)
    breakdown(lambda: k16.utf16_to_well_formed(w, U, False),
              f"utf16_to_well_formed ({U} units, {w.numel()}-unit bucket)", card)
    breakdown(lambda: kdet.detect_fused(x, L), f"detect_encodings ({L} B corpus)", card)
    breakdown(lambda: kdet.detect_fused(b32, B), f"detect_encodings ({B} B UTF-32LE)", card)
    log(f"bytes: ascii_first_bad {A}, utf16_to_well_formed {4 * w.numel()}, "
        f"detect_encodings {L} (UTF-32LE form {B})")
    moved = {"ascii_first_bad": A, "utf16_to_well_formed": 4 * w.numel(),
             "detect_encodings": L}
    return ms, moved, library


def timestr_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict, dict]:
    """ms of each fixed-rate kernel and of its plain version at the class
    calls' shapes: the UTF-8 -> UTF-16 kernels on the 64 MiB ASCII, é, 東
    and 🙂 corpora in their 64 MiB bucket, the UTF-16 -> UTF-8 kernels on
    ``big`` units of each class in a 64 Mi-unit bucket, device-resident;
    the routed class calls against the census's and the branch's plain
    versions; the library yardstick ``x.to(torch.int16)`` (the LE widen of
    ASCII bytes; no PyTorch call computes the uniform classes) and, as a
    note, ``w.view(torch.int16).to(torch.uint8)`` (uint8[n] where the ASCII
    narrow writes uint8[3n]); a torch.profiler breakdown of each routed
    class call."""
    import numpy as np
    import torch

    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import transcode as ktr
    from simdutf_tpu_torch.ops import utf8 as o8
    from simdutf_tpu_torch.ops import utf16 as o16

    ms, moved, library = {}, {}, {}
    for k, ch in FIXED8:
        x, L = impl.to_device(*impl._pad(np.frombuffer(class_corpus(ch, big), np.uint8)), "cuda")
        torch.cuda.synchronize()
        fn, ref = getattr(ktr, k), getattr(ktr, k + "_ref")

        def plain_route(x=x, L=L, ref=ref):
            int(kcen.census_bits_ref(x, L))  # the route's one sync
            return ref(x, L, False)

        ms.update(_time_pairs({
            k: (lambda x=x, L=L, fn=fn: fn(x, L, False), lambda x=x, L=L, ref=ref: ref(x, L, False)),
            f"to_utf16 (ops.utf8, routed, {ch!r} class)": (lambda x=x, L=L: o8.to_utf16(x, L, False),
                                                            plain_route),
        }, L, card))
        breakdown(lambda x=x, L=L: o8.to_utf16(x, L, False),
                  f"to_utf16 ({ch!r} class, {L} B in a {x.numel()} B bucket)", card)
        moved[k] = L + 2 * x.numel()
        if k == "ascii_widen_utf16":
            library[k] = cuda_ms(lambda x=x: x.to(torch.int16))
            log(f"time library x.to(torch.int16) over the {x.numel()} B bucket: "
                f"{library[k]:.4f} ms [{card}]")
        del x
    for k, ch in FIXED16:
        w, U = impl.to_device(*impl._pad(_u16(ch * big)), "cuda")
        torch.cuda.synchronize()
        fn, ref = getattr(ktr, k), getattr(ktr, k + "_ref")

        def plain_route(w=w, U=U, ref=ref):
            int(kcen.census16_bits_ref(w, U, False))  # the route's one sync
            return ref(w, U, False)

        ms.update(_time_pairs({
            k: (lambda w=w, U=U, fn=fn: fn(w, U, False), lambda w=w, U=U, ref=ref: ref(w, U, False)),
            f"to_utf8 (ops.utf16, routed, {ch!r} class)": (lambda w=w, U=U: o16.to_utf8(w, U, False),
                                                            plain_route),
        }, 2 * U, card))
        breakdown(lambda w=w, U=U: o16.to_utf8(w, U, False),
                  f"to_utf8 ({ch!r} class, {U} units in a {w.numel()}-unit bucket)", card)
        moved[k] = 2 * U + 3 * w.numel()
        if k == "ascii_narrow_utf8":
            note_call(lambda w=w: w.view(torch.int16).to(torch.uint8),
                      f"w.view(torch.int16).to(torch.uint8) over the {w.numel()}-unit bucket "
                      f"(uint8[n], not the kernel's uint8[3n])", card)
        if k == "uniform3_utf16_to_utf8":
            log(f"plan: {narrow3_plan_text(w.numel())} [{card}]")
        del w
    log(f"bytes: {moved}")
    return ms, moved, library


def timestr32_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict, dict]:
    """ms of each UTF-32 fixed-rate kernel and of its plain version at the
    class calls' shapes, device-resident: the 64 MiB ASCII, é, 東 and 🙂
    corpora in their 64 MiB bucket (UTF-8 -> UTF-32), their UTF-32 words
    (-> UTF-8, -> UTF-16LE) and UTF-16LE units (-> UTF-32) in their
    buckets; the routed class calls against the census's and the branch's
    plain versions, and Latin-1 -> UTF-32 of the 64 MiB Latin-1 buffer;
    the library yardsticks ``x.to(torch.int32)`` (#24, the ASCII bytes) and
    ``u.to(torch.int32)`` (#26, LE BMP units; none where the cast has no
    CUDA kernel for uint16), each with its device row from torch.profiler
    beside #24's and #26's own and their flag fill's, and widen32's launch
    plan; ``w.to(torch.int16)`` (#28: int16[n] where the kernel writes
    uint16[2n]) as a note; no PyTorch call computes the other classes; a
    torch.profiler breakdown of each routed call."""
    import numpy as np
    import torch

    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen
    from simdutf_tpu_torch.kernels import transcode32 as k32
    from simdutf_tpu_torch.kernels import validate as kv
    from simdutf_tpu_torch.ops import latin1 as ol1
    from simdutf_tpu_torch.ops import utf8 as o8
    from simdutf_tpu_torch.ops import utf16 as o16
    from simdutf_tpu_torch.ops import utf32 as o32

    ms, moved, library = {}, {}, {}

    def staged(arr):
        x, n = impl.to_device(*impl._pad(arr), "cuda")
        torch.cuda.synchronize()
        return x, n

    def yardstick(k, call, what):
        try:
            library[k] = cuda_ms(call)
        except (RuntimeError, NotImplementedError) as exc:  # a cast with no CUDA kernel
            log(f"time library {what}: none, {type(exc).__name__}: {str(exc)[:120]} [{card}]")
            return
        log(f"time library {what}: {library[k]:.4f} ms [{card}]")

    def timed(k, kern, plain, route, plain_route, nbytes, what):
        ms.update(_time_pairs({k: (kern, plain), what: (route, plain_route)}, nbytes, card))
        breakdown(route, what, card)

    def rows_of(call, what):
        _, rows = device_rows(call)
        check(bool(rows), f"torch.profiler saw no device row of {what}")
        return rows

    def widen_rows(k, kern, cast, what):
        """#24's or #26's own device row and its flag fill's beside its
        event ms, then its cast's, timed as the library yardstick."""
        rows = rows_of(kern, k)
        DEVICE_US[k] = rows[0][0]
        others = ", ".join(f"{'flag fill' if 'Fill' in key or 'emset' in key else 'other'} "
                           f"{us:.2f} us ({key[:70]})" for us, _, key in rows[1:])
        log(f"device {k}: {rows[0][0]:.2f} us/call of its own row, {ms[k][0]:.4f} ms by "
            f"events; {others or 'no other row'} [{card}]")
        yardstick(k, cast, what)
        if k in library:
            log(f"device {what}: {rows_of(cast, what)[0][0]:.2f} us/call, "
                f"{library[k]:.4f} ms by events [{card}]")

    for k, ch in FIXED8TO32:
        x, L = staged(np.frombuffer(class_corpus(ch, big), np.uint8))
        fn, ref = getattr(k32, k), getattr(k32, k + "_ref")

        def plain_route(x=x, L=L, ref=ref):
            int(kcen.census_bits_ref(x, L))  # the route's one sync
            return ref(x, L)

        timed(k, lambda x=x, L=L, fn=fn: fn(x, L), lambda x=x, L=L, ref=ref: ref(x, L),
              lambda x=x, L=L: o8.to_utf32(x, L), plain_route, L,
              f"to_utf32 (ops.utf8, routed, {ch!r} class, {L} B in a {x.numel()} B bucket)")
        moved[k] = L + 4 * x.numel()
        if k == "latin1_widen_utf32":
            widen_rows(k, lambda x=x, L=L, fn=fn: fn(x, L), lambda x=x: x.to(torch.int32),
                       f"x.to(torch.int32) over the {x.numel()} B bucket")
        del x
    lat, B = staged(np.frombuffer(latin1_corpus(big), np.uint8))
    ms.update(_time_pairs({"to_utf32 (ops.latin1, routed)": (
        lambda: ol1.to_utf32(lat, B), lambda: k32.latin1_widen_utf32_ref(lat, B))}, B, card))
    breakdown(lambda: ol1.to_utf32(lat, B), f"latin1 to_utf32 ({B} B)", card)
    del lat

    def census32_plain(w, W):
        lo, hi = torch.aminmax(w[:W])  # the census, with its one sync
        torch.stack([lo.to(torch.int64), hi.to(torch.int64), kv.utf32_first_bad_ref(w, W)]).tolist()

    for k, ch in FIXED32TO8 + FIXED32TO16:
        w, W = staged(_u32(class_corpus(ch, big).decode()))
        fn, ref = getattr(k32, k), getattr(k32, k + "_ref")
        to8 = k in dict(FIXED32TO8)
        args = (w, W) if to8 else (w, W, False)

        def plain_route(w=w, W=W, ref=ref, args=args):
            census32_plain(w, W)
            return ref(*args)

        timed(k, lambda fn=fn, args=args: fn(*args), lambda ref=ref, args=args: ref(*args),
              (lambda w=w, W=W: o32.to_utf8(w, W)) if to8 else
              (lambda w=w, W=W: o32.to_utf16(w, W, False)), plain_route, 4 * W,
              f"{'to_utf8' if to8 else 'to_utf16le'} (ops.utf32, routed, {ch!r} class, {W} words "
              f"in a {w.numel()}-word bucket)")
        moved[k] = 4 * W + 4 * w.numel()  # 4n bytes out: UTF-8 or 2n units
        if k == "bmp_narrow_utf16":
            note_call(lambda w=w: w.to(torch.int16),
                      f"w.to(torch.int16) over the {w.numel()}-word bucket (int16[n], not the "
                      f"kernel's uint16[2n])", card)
        del w
    for k, ch in FIXED16TO32:
        u, U = staged(_u16(class_corpus(ch, big).decode()))
        fn, ref = getattr(k32, k), getattr(k32, k + "_ref")

        def plain_route(u=u, U=U, ref=ref):
            bits = kcen.census16_bits_ref(u, U, False)  # census32, with its one sync
            sur = ((u.view(torch.int16)[:U] >> 11) == -5).any()
            torch.stack([bits.to(torch.int64), sur.to(torch.int64)]).tolist()
            return ref(u, U, False)

        timed(k, lambda u=u, U=U, fn=fn: fn(u, U, False), lambda u=u, U=U, ref=ref: ref(u, U, False),
              lambda u=u, U=U: o16.to_utf32(u, U, False), plain_route, 2 * U,
              f"to_utf32 (ops.utf16, routed, {ch!r} class, {U} units in a {u.numel()}-unit bucket)")
        moved[k] = 2 * U + 4 * u.numel()
        if k == "bmp_widen_utf32":
            widen_rows(k, lambda u=u, U=U, fn=fn: fn(u, U, False), lambda u=u: u.to(torch.int32),
                       f"u.to(torch.int32) over the {u.numel()}-unit uint16 bucket")
        del u
    log(f"plan: {widen32_plan_text()} [{card}]")
    log(f"bytes: {moved}")
    return ms, moved, library


def fixed_rate_inputs(big: int = CORPUS_BYTES):
    """({kernel: (call, bytes it must move)} of the 18 fixed-rate class
    kernels at their class calls' shapes, device-resident as timestr_phase
    and timestr32_phase stage them; {what: call} of the PyTorch casts
    timed beside them (#18, #24 and #26 compute their kernel's function;
    #19's and #28's write a different buffer and are kept as notes))."""
    import numpy as np
    import torch

    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import transcode as ktr
    from simdutf_tpu_torch.kernels import transcode32 as k32

    def staged(arr):
        return impl.to_device(*impl._pad(arr), "cuda")

    calls, casts = {}, {}
    for k, ch in FIXED8:
        x, L = staged(np.frombuffer(class_corpus(ch, big), np.uint8))
        calls[k] = (lambda x=x, L=L, fn=getattr(ktr, k): fn(x, L, False), L + 2 * x.numel())
        if k == "ascii_widen_utf16":
            casts["x.to(torch.int16) (#18)"] = lambda x=x: x.to(torch.int16)
    for k, ch in FIXED16:
        w, U = staged(_u16(ch * big))
        calls[k] = (lambda w=w, U=U, fn=getattr(ktr, k): fn(w, U, False), 2 * U + 3 * w.numel())
        if k == "ascii_narrow_utf8":
            casts["w.view(torch.int16).to(torch.uint8) (#19, uint8[n] of uint8[3n])"] = (
                lambda w=w: w.view(torch.int16).to(torch.uint8))
    for k, ch in FIXED8TO32:
        x, L = staged(np.frombuffer(class_corpus(ch, big), np.uint8))
        calls[k] = (lambda x=x, L=L, fn=getattr(k32, k): fn(x, L), L + 4 * x.numel())
        if k == "latin1_widen_utf32":
            casts["x.to(torch.int32) (#24)"] = lambda x=x: x.to(torch.int32)
    for k, ch in FIXED32TO8 + FIXED32TO16:
        w, W = staged(_u32(class_corpus(ch, big).decode()))
        args = (w, W) if k in dict(FIXED32TO8) else (w, W, False)
        calls[k] = (lambda args=args, fn=getattr(k32, k): fn(*args), 4 * W + 4 * w.numel())
        if k == "bmp_narrow_utf16":
            casts["w.to(torch.int16) (#28, int16[n] of uint16[2n])"] = lambda w=w: w.to(torch.int16)
    for k, ch in FIXED16TO32:
        u, U = staged(_u16(class_corpus(ch, big).decode()))
        calls[k] = (lambda u=u, U=U, fn=getattr(k32, k): fn(u, U, False), 2 * U + 4 * u.numel())
        if k == "bmp_widen_utf32":
            casts["u.to(torch.int32) (#26)"] = lambda u=u: u.to(torch.int32)
    torch.cuda.synchronize()
    return calls, casts


def widen32_plan_text() -> str:
    """The launch plan of the widening kernel behind #24 and #26: grid,
    tile and stages for each element size."""
    from simdutf_tpu_torch.kernels import transcode32 as k32

    plan = getattr(k32, "widen32_plan", None)
    if plan is None:
        return "no widen32 plan (a grid-stride kernel)"
    return "; ".join(
        f"{src}-byte elements: grid {p['grid']} x {p['threads']} threads "
        f"({p['blocks_per_sm']} a SM), tile {p['tile_words']} words, "
        f"{p['stages']} stages, {p['smem_bytes']} B of shared memory a block"
        for src, p in ((s, plan(s)) for s in (1, 2)))


def narrow3_plan_text(units: int) -> str:
    """The launch plan of the tiled kernel behind #23 for ``units`` units
    of an aligned buffer: grid, tile, stages, shared memory, the split."""
    from simdutf_tpu_torch.kernels import transcode as ktr

    plan = getattr(ktr, "narrow3_plan", None)
    if plan is None:
        return "no narrow3 plan (a grid-stride kernel)"
    p = plan(0, units)
    return (f"uniform3_utf16_to_utf8 on {units} units: grid {p['grid']} x {p['threads']} "
            f"threads ({p['blocks_per_sm']} a SM), tile {p['tile_units']} units, "
            f"{p['stages']} stages, {p['smem_bytes']} B of shared memory a block, head "
            f"{p['head']}, {p['ntiles']} whole tiles")


def host_us(fn, iters: int = 20) -> float:
    """Host-clock µs per call of ``fn`` while its launches queue up: the
    host's cost of a call, where the device takes longer."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def fixed_rate_times_phase(card: str, big: int = CORPUS_BYTES) -> dict:
    """Each fixed-rate kernel's and cast's ms per call by CUDA events (the
    median of two ``cuda_ms`` runs), the device µs of its own row, with
    every device row of one call (a wrapper's flag fill among them), from
    torch.profiler, and the host's µs a call. Run once per tree, in one
    process each, the trees in turns: the A/B of a change to these
    kernels."""
    calls, casts = fixed_rate_inputs(big)
    out = {}
    for name, (call, nbytes) in {**calls, **{k: (c, 0) for k, c in casts.items()}}.items():
        ms = statistics.median([cuda_ms(call), cuda_ms(call)])
        _, rows = device_rows(call)
        check(bool(rows), f"torch.profiler saw no device row of {name}")
        host = host_us(call)
        out[name] = {"ms": ms, "device_us": rows[0][0], "host_us": host,
                     "rows": [[round(us, 3), count, key[:100]] for us, count, key in rows]}
        text = (f"time {name}: {ms:.4f} ms by events, {rows[0][0]:.2f} us device, "
                f"{host:.1f} us host")
        if nbytes:
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            out[name]["bound_ms"] = bound
            text += (f", bound {bound:.4f} ms ({100 * bound / ms:.1f}% by events, "
                     f"{100 * bound / (rows[0][0] / 1e3):.1f}% by the device row)")
        log(f"{text} [{card}]")
        for us, count, key in rows:
            log(f"  {us:9.2f} us/call  x{count:g}  {key[:90]}")
    log(f"plan: {widen32_plan_text()}")
    log(f"plan: {narrow3_plan_text(big)}")
    return out


def compact_times_phase(card: str, big: int = CORPUS_BYTES) -> dict:
    """compose16 (with and without its clamp) and compose32 on the 64 MiB
    mixed corpus and b64_compact (uint8 and char16) on the MIME corpus,
    and their routed calls (``ops.utf8.to_utf16``, ``ops.utf8.to_utf32``,
    ``ops.base64_ops.decode_bulk_routed``):
    ms per call by CUDA events (the median of two ``cuda_ms`` runs),
    every device row of one call from torch.profiler (the wrapper's own
    kernels apart from torch's), and the host's µs a call. Only names the
    parent tree also has, so one script times both trees in turns."""
    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import compact64 as kc64
    from simdutf_tpu_torch.kernels import compose16 as kc
    from simdutf_tpu_torch.kernels import compose32 as kc32
    from simdutf_tpu_torch.ops import base64_ops as ob
    from simdutf_tpu_torch.ops import utf8 as o8

    x, L = impl.to_device(*impl._pad(np.frombuffer(bench.mixed_corpus(big), np.uint8)), "cuda")
    _, mime = mime_corpus(big)
    m8, M = impl.to_device(*impl._pad(np.frombuffer(mime, np.uint8)), "cuda")
    m16 = m8.to(torch.int16).view(torch.uint16)
    torch.cuda.synchronize()
    calls = {
        "compose16 (clamp)": (lambda: kc.to_utf16_compose(x, L, False), L + 2 * x.numel()),
        "compose16 (no clamp)": (lambda: kc.to_utf16_compose(x, L, False, False),
                                 L + 2 * x.numel()),
        "to_utf16 (ops.utf8, routed)": (lambda: o8.to_utf16(x, L, False), 0),
        "compose32": (lambda: kc32.to_utf32_compose(x, L), L + 4 * x.numel()),
        "to_utf32 (ops.utf8, routed)": (lambda: o8.to_utf32(x, L), 0),
        "b64_compact (uint8)": (lambda: kc64.compact_codes(m8, M, False, False),
                                M + m8.numel()),
        "b64_compact (char16)": (lambda: kc64.compact_codes(m16, M, False, False),
                                 2 * M + m16.numel()),
        "decode_bulk_routed (uint8)": (lambda: ob.decode_bulk_routed(m8, M, False, False), 0),
        "decode_bulk_routed (char16)": (lambda: ob.decode_bulk_routed(m16, M, False, False), 0),
    }
    out = {}
    for name, (call, nbytes) in calls.items():
        ms = statistics.median([cuda_ms(call), cuda_ms(call)])
        _, rows = device_rows(call)
        check(bool(rows), f"torch.profiler saw no device row of {name}")
        busy = sum(r[0] for r in rows)
        own = sum(us for us, _, key in rows if not key.startswith(("void at::", "Memset", "Memcpy")))
        host = host_us(call)
        out[name] = {"ms": ms, "device_busy_us": busy, "own_us": own, "host_us": host,
                     "rows": [[round(us, 3), count, key[:100]] for us, count, key in rows]}
        text = (f"time {name}: {ms:.4f} ms by events, device busy {busy:.2f} us "
                f"(own kernels {own:.2f} us), {host:.1f} us host, {len(rows)} device rows")
        if nbytes:
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            out[name]["bound_ms"] = bound
            text += (f", bound {bound:.4f} ms ({100 * bound / ms:.1f}% by events, "
                     f"{100 * bound / (own / 1e3):.1f}% by the own rows)")
        log(f"{text} [{card}]")
        for us, count, key in rows:
            log(f"  {us:9.2f} us/call  x{count:g}  {key[:90]}")
    return out


def census_times_phase(card: str, big: int = CORPUS_BYTES) -> dict:
    """census_utf8 alone on the 64 MiB ASCII, mixed, é, 東 and 🙂 corpora:
    ms per call by CUDA events (the median of two ``cuda_ms`` runs), its
    device row from torch.profiler, its bound (the input read once), and,
    where the tree's census counts them, the chunks that ran a positional
    check. The bits must equal the plain census's. Only names the parent
    tree also has, so one script times both trees in turns."""
    import inspect

    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import census as kcen

    counted = "counted" in inspect.signature(kcen.census_bits).parameters
    corpora = {"ascii": class_corpus("a", big), "mixed": bench.mixed_corpus(big),
               "u2": class_corpus("é", big), "u3": class_corpus("東", big),
               "u4": class_corpus("\U0001f642", big)}
    out = {}
    for name, data in corpora.items():
        x, L = impl.to_device(*impl._pad(np.frombuffer(data, np.uint8)), "cuda")
        torch.cuda.synchronize()
        call = lambda x=x, L=L: kcen.census_bits(x, L)  # noqa: E731
        check(int(call()) == int(kcen.census_bits_ref(x, L)), f"census_utf8 bits on {name}")
        ms = statistics.median([cuda_ms(call), cuda_ms(call)])
        _, rows = device_rows(call)
        check(bool(rows), f"torch.profiler saw no device row of census_utf8 on {name}")
        row = max((r for r in rows if "census" in r[2]), default=rows[0])
        bound = L / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "device_us": row[0], "bound_ms": bound, "bytes": L,
                     "rows": [[round(us, 3), count, key[:100]] for us, count, key in rows]}
        text = (f"time census_utf8 on {name} ({L} B): {ms:.4f} ms by events, "
                f"{row[0]:.2f} us on its row, bound {bound:.4f} ms "
                f"({100 * bound / ms:.1f}% by events, {100 * bound / (row[0] / 1e3):.1f}% "
                f"by the row)")
        if counted:
            checked = int(kcen.census_bits(x, L, counted=True)) >> 32
            chunks = kcen.census_chunks(x, L)
            out[name].update(checked_chunks=checked, chunks=chunks)
            text += f", {checked} of {chunks} chunks checked ({100 * checked / chunks:.2f}%)"
        log(f"{text} [{card}]")
        del x
    return out


def _first_event_lib(tree: str, tag: str):
    """``tree``'s csrc/validate.cu built alone, with ``_build``'s flags,
    into build/first_event_times/<tag>/ and loaded: (library, ptxas's
    report of first_event_kernel, its SASS instruction count)."""
    import ctypes
    import re
    import shutil
    from pathlib import Path

    from simdutf_tpu_torch.kernels import _build

    src = Path(tree) / "simdutf_tpu_torch" / "csrc" / "validate.cu"
    out = Path(__file__).resolve().parent / "build" / "first_event_times" / tag
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    obj, so = out / "validate.o", out / "libvalidate.so"
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"nvcc {src}: {r.stderr[-2000:]}")
    lines = r.stderr.splitlines()
    at = next((i for i, ln in enumerate(lines)
               if "Compiling entry function" in ln and "first_event_kernel" in ln), None)
    ptxas = " | ".join(ln.split(":", 1)[-1].strip() for ln in lines[at + 1:at + 4]) \
        if at is not None else "not reported"
    r = subprocess.run([nvcc, *_build.LINK_FLAGS, str(obj), "-o", str(so)],
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"nvcc link {so}: {r.stderr[-2000:]}")
    sass = None
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cuobjdump):
        dump = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                              timeout=600).stdout
        for part in dump.split("Function : ")[1:]:
            if part.split()[0].find("first_event_kernel") >= 0:
                sass = len(re.findall(r"/\*[0-9a-f]{4,}\*/ ", part))
    lib = ctypes.CDLL(str(so))
    fn = lib.utf8_first_event
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, ptxas, sass


def first_event_times_phase(card: str, against: str | None, big: int = CORPUS_BYTES,
                            turns: int = 6, launches: int = 200) -> dict:
    """utf8_first_event alone, µs a launch by CUDA events, of this tree's
    csrc/validate.cu and, given ``against``, of that tree's, each built
    into a library of its own and loaded into this process, in turns
    (this, that, that, this, ...) on the same device buffers: the cell's
    text (validate_utf8.mixed_64m's generator), the smoke corpus (emoji
    and seven scripts), all-ASCII text, the card tests' small mixed text,
    uniformly random bytes, and the cell's text with a 0xFF in its last
    MiB. Each launch writes a key of its own (no fill in the window); the
    first must equal the plain version's (pos, code). Also the chunks each
    counts into a counter, ptxas's registers and spills, and the SASS
    instructions of first_event_kernel."""
    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch.kernels import validate as kv

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench_torch import harness

    gen = harness.load_module(harness.HERE / "traffic" / "text.py", "bench_torch.traffic.text")
    cell = gen.generate(harness.load_cell("validate_utf8.mixed_64m").traffic, 2500000001,
                        "cpu")[0]
    planted = cell.copy()
    k = len(planted) - 512 * 1024
    while planted[k] & 0xC0 == 0x80:
        k -= 1
    planted[k] = 0xFF
    rng = np.random.default_rng(24)
    small = "".join(rng.choice(list("abc  éЖ東🙂"), 300_000)).encode()
    inputs = {"cell": cell, "smoke": np.frombuffer(bench.mixed_corpus(big), np.uint8),
              "ascii": np.frombuffer(class_corpus("a", big), np.uint8),
              "small_mixed": np.frombuffer(small, np.uint8),
              "random": np.random.default_rng(25).integers(0, 256, big, dtype=np.uint8),
              "cell_error_last_mib": planted}
    trees = {"change": os.path.dirname(os.path.abspath(__file__))}
    if against:
        trees["parent"] = os.path.abspath(against)
    libs = {}
    for tag, tree in trees.items():
        fn, ptxas, sass = _first_event_lib(tree, tag)
        libs[tag] = fn
        log(f"first_event_kernel ({tag}, {tree}): ptxas {ptxas}; {sass} SASS instructions")
    order = list(libs) + list(libs)[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    out = {"build": {}, "inputs": {}}
    for name, data in inputs.items():
        x, L = impl.to_device(*impl._pad(np.ascontiguousarray(data)), "cuda")
        want = [t.item() for t in kv.utf8_first_event_len_ref(x, L)]
        keys = torch.full((launches,), kv.BIG << 8, dtype=torch.int64, device="cuda")
        counter = torch.zeros(1, dtype=torch.int64, device="cuda")
        us = {tag: [] for tag in libs}
        res = {}
        for tag, fn in libs.items():
            check(fn(x.data_ptr(), L, keys.data_ptr(), counter.data_ptr(), stream) == 0,
                  f"utf8_first_event ({tag}) launch on {name}")
            torch.cuda.synchronize()
            key = int(keys[0])
            check([key >> 8, key & 0xFF] == want,
                  f"utf8_first_event ({tag}) on {name}: {[key >> 8, key & 0xFF]} != {want}")
            res[tag] = int(counter[0])
            counter.zero_()
        for _ in range(turns // 2):
            for tag in order:
                keys.fill_(kv.BIG << 8)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(launches):
                    libs[tag](x.data_ptr(), L, keys.data_ptr() + 8 * i, None, stream)
                end.record()
                end.synchronize()
                us[tag].append(start.elapsed_time(end) * 1e3 / launches)
                check(int(keys[launches - 1]) == int(keys[0]), f"{tag} on {name}: keys differ")
        out["inputs"][name] = {
            "bytes": L, "want": want, "bound_us": L / PEAK_BYTES_PER_S * 1e6,
            "exact_chunks": res, "chunks": (L + 15) // 16,
            **{f"{tag}_us": sorted(v) for tag, v in us.items()},
            **{f"{tag}_median_us": statistics.median(v) for tag, v in us.items()}}
        log(f"time utf8_first_event on {name} ({L} B, first error {want}): " + ", ".join(
            f"{tag} {statistics.median(v):.2f} us (turns {min(v):.2f}-{max(v):.2f}; "
            f"{res[tag]} exact chunks)" for tag, v in us.items())
            + f"; bound {L / PEAK_BYTES_PER_S * 1e6:.2f} us [{card}]")
        del x, keys
    return out


def timesp_phase(card: str, big: int = CORPUS_BYTES) -> tuple[dict, dict, dict]:
    """ms of each pallas-tier kernel and of its plain version at its path's
    shapes, device-resident: the UTF-8 SWAR scan on the 64 MiB corpus (the
    exact event kernel on the same bytes beside it), the ASCII scan on the
    64 MiB ASCII buffer (``torch.amax`` over it as the library yardstick:
    the yes/no half), the UTF-16 scan on the corpus's units in their
    64 Mi-unit bucket, clean_decode on the clean base64 in its bucket,
    row_compact at (131072, 128) ((8, 128), the shape internal_tests gives
    it, logged), the probe on its tile; then the routed UTF-8 validation
    of the tier (SWAR, one sync, the host rewind when it flags) beside the
    torch tier's (the event kernel), clean and with 0xFF 60 MiB in, and
    a torch.profiler breakdown of each."""
    import base64

    import numpy as np
    import torch

    import bench
    from simdutf_tpu_torch import impl
    from simdutf_tpu_torch import validate_host as vh
    from simdutf_tpu_torch.kernels import base64_kernel as kb64
    from simdutf_tpu_torch.kernels import compaction as kcmp
    from simdutf_tpu_torch.kernels import swar as ksw
    from simdutf_tpu_torch.kernels import validate as kv
    from simdutf_tpu_torch.ops import utf8 as o8

    data = bench.mixed_corpus(big)
    x, L = impl.to_device(*impl._pad(np.frombuffer(data, np.uint8)), "cuda")
    a, A = impl.to_device(*impl._pad(np.frombuffer(class_corpus("a", big), np.uint8)), "cuda")
    w, U = impl.to_device(*impl._pad(np.frombuffer(data.decode("utf-8").encode("utf-16-le"),
                                                   np.uint16)), "cuda")
    raw = data[: big * 3 // 4]
    c, C = impl.to_device(*impl._pad(np.frombuffer(base64.b64encode(raw), np.uint8)), "cuda")
    rng = np.random.default_rng(SEED + 46)
    val = torch.from_numpy(rng.integers(-2**31, 2**31, (131_072, 128)).astype(np.int32)).cuda()
    keep = torch.from_numpy(rng.random((131_072, 128)) < 0.4).cuda()
    keep32 = keep.to(torch.int32)
    tile = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 512)).astype(np.int32)).cuda()
    torch.cuda.synchronize()
    ms = _time_pairs({
        "utf8_swar_first_bad_word": (lambda: ksw.utf8_swar_first_bad_word(x, L),
                                     lambda: ksw.utf8_swar_first_bad_word_ref(x, L)),
        "utf8_first_event (same bytes)": (lambda: kv.utf8_first_event_len(x, L),
                                          lambda: kv.utf8_first_event_len_ref(x, L)),
    }, L, card)
    ms.update(_time_pairs({
        "ascii_swar_first_bad_word": (lambda: ksw.ascii_swar_first_bad_word(a, A),
                                      lambda: ksw.ascii_swar_first_bad_word_ref(a, A)),
    }, A, card))
    note_call(lambda: torch.amax(a[:A]), f"torch.amax over the {A} B ASCII buffer (a yes/no, "
              f"not ascii_swar_first_bad_word's word)", card)
    library = {}
    ms.update(_time_pairs({
        "utf16_swar_first_bad_word": (lambda: ksw.utf16_swar_first_bad_word(w, U, False),
                                      lambda: ksw.utf16_swar_first_bad_word_ref(w, U, False)),
    }, 2 * U, card))
    ms.update(_time_pairs({
        "clean_decode": (lambda: kb64.clean_decode(c, C // 4),
                         lambda: kb64.clean_decode_ref(c, C // 4)),
    }, c.numel(), card))
    ms.update(_time_pairs({
        "row_compact": (lambda: kcmp.row_compact(val, keep32),
                        lambda: kcmp.row_compact_ref(val, keep32)),
    }, 8 * val.numel(), card))
    _time_pairs({
        "row_compact (8, 128)": (lambda: kcmp.row_compact(val[:8], keep32[:8]),
                                 lambda: kcmp.row_compact_ref(val[:8], keep32[:8])),
    }, 8 * 8 * 128, card)
    ms.update(_time_pairs({
        "lane_shapecast_probe": (lambda: kv.lane_shapecast_probe(tile, 1),
                                 lambda: kv.lane_shapecast_probe_ref(tile, 1)),
    }, 4 * tile.numel(), card))

    # the routed validation: the tier's SWAR scan + one sync (+ the host
    # rewind of a flagged word) beside the torch tier's event kernel + sync
    k8 = lead_at(data, min(60 * MIB, len(data) * 15 // 16))
    bad_np = np.frombuffer(data[:k8] + b"\xff" + data[k8 + 1:], np.uint8)
    xb, _ = impl.to_device(*impl._pad(bad_np), "cuda")
    torch.cuda.synchronize()

    def swar_route(buf, host):
        word = int(ksw.utf8_swar_first_bad_word(buf, L))
        if word == ksw.BIG:
            return None
        fb = word * 4
        start, back = max(fb - 8, 0), 0
        while start > 0 and back < 3 and (int(host[start]) & 0xC0) == 0x80:
            start, back = start - 1, back + 1
        return vh.validate_utf8_with_errors(host[start:min(fb + 16, L)])

    def event_route(buf):
        return torch.stack(o8.validate_with_errors(buf, L)).tolist()

    host = np.frombuffer(data, np.uint8)
    ms.update(_time_pairs({
        "validate_utf8_with_errors (pallas tier, SWAR + rewind)": (
            lambda: swar_route(x, host), lambda: event_route(x)),
        "validate_utf8_with_errors (pallas tier, 0xFF 60 MiB in)": (
            lambda: swar_route(xb, bad_np), lambda: event_route(xb)),
    }, L, card))
    log("(the routed rows' 'plain' column is the torch tier's event route, not a plain version)")
    from simdutf_tpu_torch.kernels.impl import TorchPallasImplementation

    tier, plain = TorchPallasImplementation("cuda"), impl.TorchImplementation("cuda")
    for what, arr in (("corpus", host), ("corpus, 0xFF 60 MiB in", bad_np)):
        for name, fn in (("pallas tier", tier.validate_utf8_with_errors),
                         ("torch tier", plain.validate_utf8_with_errors)):
            fn(arr)
            clock = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(arr)
                clock.append((time.perf_counter() - t0) * 1e3)
            log(f"host clock api validate_utf8_with_errors ({name}, {what}, staging copy "
                f"included): {statistics.median(clock):.3f} ms median of 5 [{card}]")
    breakdown(lambda: swar_route(x, host), f"pallas-tier validate_utf8 ({L} B corpus)", card)
    breakdown(lambda: event_route(x), f"torch-tier validate_utf8 ({L} B corpus)", card)
    breakdown(lambda: swar_route(xb, bad_np), f"pallas-tier validate_utf8, 0xFF at {k8}", card)
    breakdown(lambda: kb64.clean_decode(c, C // 4), f"clean_decode ({C} chars)", card)
    breakdown(lambda: kcmp.row_compact(val, keep32), "row_compact (131072, 128)", card)
    moved = {"utf8_swar_first_bad_word": L, "ascii_swar_first_bad_word": A,
             "utf16_swar_first_bad_word": 2 * U, "clean_decode": c.numel() // 4 * 7,
             "row_compact": 12 * val.numel() + 4 * val.shape[0],
             "lane_shapecast_probe": 8 * tile.numel()}
    log(f"bytes: {moved}")
    return ms, moved, library


def device_rows(fn, iters: int = 20):
    """(host-clock µs per call, [(device µs per call, launches per call,
    name), ...] largest first) of the device-side work ``fn`` starts, from
    torch.profiler over ``iters`` calls after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device rows
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / iters
        # device-side events only (kernels, copies, memsets): an aten op's
        # row repeats the time of the kernels it launched
        rows = sorted(((e.self_device_time_total / iters, e.count / iters, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        if rows:
            break
    return wall_us, rows


def breakdown(fn, what: str, card: str, iters: int = 20) -> None:
    """Device time per call of each kernel ``fn`` runs, and the device's
    busy share of the window, from torch.profiler."""
    wall_us, rows = device_rows(fn, iters)
    busy = sum(r[0] for r in rows)
    log(f"breakdown {what}: {wall_us:.1f} us/call on the host clock, device "
        f"busy {busy:.1f} us/call ({100 * busy / wall_us:.1f}%) [{card}]")
    for us, count, key in rows:
        log(f"  {us:9.2f} us/call  x{count:g}  {key[:90]}")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--fixed-rate-times", action="store_true",
                        help="only build and time the fixed-rate kernels and their casts "
                             "(fixed_rate_times_phase); print one JSON line")
    parser.add_argument("--compact-times", action="store_true",
                        help="only build and time compose16, compose32, b64_compact and their "
                             "routed calls (compact_times_phase); print one JSON line")
    parser.add_argument("--census-times", action="store_true",
                        help="only build and time census_utf8 on five 64 MiB corpora "
                             "(census_times_phase); print one JSON line")
    parser.add_argument("--first-event-times", action="store_true",
                        help="only build and time utf8_first_event on six inputs "
                             "(first_event_times_phase); print one JSON line")
    parser.add_argument("--against", default=None,
                        help="with --first-event-times: a parent tree unpacked beside this "
                             "one, whose csrc/validate.cu is timed in turns in this process")
    parser.add_argument("--root", default=None,
                        help="import simdutf_tpu_torch from this checkout (with "
                             "--fixed-rate-times, --compact-times or --census-times: a "
                             "parent tree unpacked beside this one)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    try:
        import bench  # noqa: F401
        import simdutf_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repo ({exc})",
              file=sys.stderr)
        return 2
    if args.first_event_times:
        try:
            name, card = device_phase()
            times = first_event_times_phase(card, args.against)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        print(json.dumps({"first_event_times": times, "against": args.against, "card": card}))
        return 0
    if args.fixed_rate_times or args.compact_times or args.census_times:
        what, phase = (("fixed_rate_times", fixed_rate_times_phase) if args.fixed_rate_times
                       else ("compact_times", compact_times_phase) if args.compact_times
                       else ("census_times", census_times_phase))
        try:
            name, card = device_phase()
            log(f"package: {os.path.dirname(simdutf_tpu_torch.__file__)}")
            build_phase()
            times = phase(card)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        print(json.dumps({what: times, "root": args.root or ".", "card": card}))
        return 0
    try:
        name, card = device_phase()
        build_phase()
        errs = parity_phase("cuda")
        errs.update(parity16_phase("cuda"))
        launches8 = slice_phase("cuda")
        launches16 = slice16_phase("cuda")
        errs.update(parity64_phase("cuda"))
        launches64 = slice64_phase("cuda")
        errs.update(parity32_phase("cuda"))
        launches32 = slice32_phase("cuda")
        errs.update(parityx_phase("cuda"))
        launchesx = slicex_phase("cuda")
        for k, e in parityu_phase("cuda").items():
            errs[k] = max(errs.get(k, 0), e)
        launchesu = sliceu_phase("cuda")
        errs.update(paritytr_phase("cuda"))
        launchest = slicetr_phase("cuda")
        errs.update(paritytr32_phase("cuda"))
        launchest32 = slicetr32_phase("cuda")
        errs.update(parityp_phase("cuda"))
        launchesp = slicep_phase("cuda")
        rate = copy_phase(card)
        ms, moved = times_phase(card)
        for phase in (times64_phase, times32_phase, timesx_phase):
            more_ms, more_moved = phase(card)
            ms.update(more_ms)
            moved.update(more_moved)
        more_ms, more_moved, library = timesu_phase(card)
        ms.update(more_ms)
        moved.update(more_moved)
        for phase in (timestr_phase, timestr32_phase, timesp_phase):
            more_ms, more_moved, more_library = phase(card)
            ms.update(more_ms)
            moved.update(more_moved)
            library.update(more_library)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "simdutf_tpu"))
        check(not loaded, f"jax or the JAX package was imported: {loaded}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    paths = ((launches8, PASSES), (launches16, PASSES16),
             (launches64, PASSES64), (launches32, PASSES32), (launchesx, PASSESX),
             (launchesu, PASSESU), (launchest, PASSEST), (launchest32, PASSEST32),
             (launchesp, PASSESP))
    launches = {k: kernel_launches(got, k) for got, path in paths for k in path}
    kernels = [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "also_replaces": KERNELS[k][2],
         "headers": HEADERS.get(k, []),
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": ms[k][0], "device_us": DEVICE_US.get(k), "plain_ms": ms[k][1],
         "bytes": moved[k], "bound_ms": moved[k] / PEAK_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "copy_bound_ms": moved[k] / rate * 1e3,
         "library_ms": library.get(k)}
        for _, path in paths for k in path
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
