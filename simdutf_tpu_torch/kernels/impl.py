"""TorchPallasImplementation: the port's counterpart of the JAX package's
``pallas`` tier (simdutf_tpu/kernels/impl.py, ``PallasImplementation``).

It subclasses :class:`~simdutf_tpu_torch.impl.TorchImplementation` and
overrides exactly the methods of ``PallasImplementation`` that reach the
kernels only that tier runs, with that tier's routing and host logic:

* UTF-8, ASCII and UTF-16LE/BE validation: one SWAR first-bad-word scan
  (kernels/swar.py) and, when it flags, an exact host rewind over a window
  of at most 24 bytes or 12 units (validate_host.py): the reference's
  vector pass then rescan (scalar/utf8.h:207-228). The JAX tier picks SWAR
  off a TPU (engine_probe.validate_kernel), and so does this one, always.
  A window whose rewind finds no error (a SWAR false positive) takes the
  exact first-error kernel over the whole buffer: the safety net, whose
  entries :attr:`safety_net` counts.
* UTF-8 -> Latin-1 of ASCII input: a strided host peek, the ASCII SWAR
  scan, and a copy.
* base64 decode of whitespace-free input: a strided host peek, the host
  strip and tail check, the fixed-rate ``clean_decode`` of the whole
  quads, and the inherited forgiving decode when its flag fires.
* ``internal_tests``: the JAX tier's four kernel checks on the port's
  kernels, and the lane shape-cast probe against its plain version.

Everything else is inherited: on the kernels the port runs on its census
routes, with the same results.
"""

from __future__ import annotations

import base64 as _pybase64

import numpy as np
import torch

from .. import base64_host as bh
from .. import trace
from .. import validate_host as vh
from ..errors import Result, error_code as ec
from ..impl import TorchImplementation, _cut8, _int, _scalars
from . import base64_kernel as kb64
from . import compaction as kc
from . import swar as ksw
from . import transcode as ktr
from . import utf16_kernels as k16
from . import validate as kv
from ..ops.common import BIG


def _bswap(u: int) -> int:
    return ((u << 8) | (u >> 8)) & 0xFFFF


class TorchPallasImplementation(TorchImplementation):
    """The ``pallas`` tier's own paths on the port's kernels; see the
    module docstring. ``safety_net`` counts the entries into the exact
    whole-buffer kernels after a SWAR flag the rewind did not confirm."""

    name = "pallas"
    description = "SWAR validation, clean base64 decode + the torch tier (CUDA sm_90a)"

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.safety_net = 0

    # -- kernel self-checks (PallasImplementation.internal_tests) -----------
    def internal_tests(self):
        """(name, check) pairs: private kernels held against tiny oracles
        (the reference's internal_tests, implementation.h:5019-5037)."""

        def swar_formula():
            for bad in (b"\x80abc", b"\xc2", b"\xe0\x80\x80", b"\xf5\x80\x80\x80",
                        b"\xed\xa0\x80", b"\xc0\xaf"):
                arr = np.frombuffer(b"ok " + bad + b" tail", np.uint8)
                x, n = self._stage(arr)
                flagged = _int(ksw.utf8_swar_first_bad_word(x, n)) != BIG
                assert flagged == vh.validate_utf8_with_errors(arr).is_err, bad

        def phase_planes():
            raw = bytes(range(256)) * 24
            chars = _pybase64.b64encode(raw)
            x, n = self._stage(np.frombuffer(chars, np.uint8))
            out, flag = kb64.clean_decode(x, n // 4)
            assert _int(flag) == 0
            assert _cut8(out, len(raw)).tobytes() == raw

        def widen_image():
            data = bytes(range(128)) * 8
            x, n = self._stage(np.frombuffer(data, np.uint8))
            out, flag = ktr.ascii_widen_utf16(x, n, False)
            assert _int(flag) == 0
            got = trace.sync("pallas.check", torch.Tensor.cpu,
                             out[:n].view(torch.int16)).numpy().tobytes()
            assert got == data.decode().encode("utf-16-le")

        def lane_compaction():
            rng = np.random.default_rng(5)
            val = rng.integers(1, 1000, (8, 128)).astype(np.int32)
            keep = rng.random((8, 128)) < 0.4
            out, cnt = kc.row_compact(torch.from_numpy(val).to(self.device),
                                      torch.from_numpy(keep).to(self.device))
            out, cnt = (trace.sync("pallas.check", torch.Tensor.cpu, t).numpy()
                        for t in (out, cnt))
            for r in range(8):
                want = val[r][keep[r]]
                assert int(cnt[r]) == want.shape[0]
                assert np.array_equal(out[r, : want.shape[0]], want), r

        def lane_shapecast():
            rng = np.random.default_rng(11)
            tile = rng.integers(-2**31, 2**31, (64, 512), dtype=np.int64).astype(np.int32)
            x = torch.from_numpy(tile).to(self.device)
            for salt in (1, 2, 3):
                got = kv.lane_shapecast_probe(x, salt)
                assert torch.equal(got, kv.lane_shapecast_probe_ref(x, salt)), salt

        return [("swar_formula", swar_formula),
                ("b64_phase_planes", phase_planes),
                ("ascii_widen_image", widen_image),
                ("lane_compaction", lane_compaction),
                ("lane_shapecast", lane_shapecast)]

    # -- UTF-8 validation ----------------------------------------------------
    def validate_utf8(self, b):
        x, n = self._stage(b)
        return _int(ksw.utf8_swar_first_bad_word(x, n)) == BIG

    def validate_utf8_with_errors(self, b):
        """The SWAR flag, then the exact (code, pos) from a host window
        around the flagged word: every SWAR predicate reads at most 4 bytes
        of context, so the scalar machine's first error lies in [fb - 8,
        fb + 16) with the start snapped back over at most 3 continuation
        bytes to a lead; truncation events at the window's end lie beyond
        it (simdutf_tpu/kernels/impl.py:137-194)."""
        x, n = self._stage(b)
        word = _int(ksw.utf8_swar_first_bad_word(x, n))
        if word == BIG:
            return Result(ec.SUCCESS, n)
        fb = word * 4
        start = max(fb - 8, 0)
        back = 0
        while start > 0 and back < 3 and (int(b[start]) & 0xC0) == 0x80:
            start -= 1
            back += 1
        res = vh.validate_utf8_with_errors(b[start: min(fb + 16, n)])
        if res.is_err:
            return Result(res.error, start + res.count)
        self.safety_net += 1
        pos, code = _scalars(*kv.utf8_first_event_len(x, n))
        if pos == BIG:
            return Result(ec.SUCCESS, n)
        return Result(ec(code), pos)

    # -- ASCII validation ----------------------------------------------------
    def validate_ascii_with_errors(self, b):
        x, n = self._stage(b)
        word = _int(ksw.ascii_swar_first_bad_word(x, n))
        if word != BIG:
            base = word * 4  # the exact byte within the flagged word
            for k in range(4):
                if base + k < n and int(b[base + k]) >= 0x80:
                    return Result(ec.TOO_LARGE, base + k)
        return Result(ec.SUCCESS, n)

    # -- UTF-16 validation ---------------------------------------------------
    def _validate16(self, w, be: bool):
        """Behind ``validate_utf16le/be[_with_errors]`` (the JAX tier's
        ``_v16``): the SWAR check (2 units a word), then the exact position
        from a host window: surrogate context is one unit, so the first
        error is in [fb - 4, fb + 8), its start moved back one unit where it
        would split a pair (simdutf_tpu/kernels/impl.py:267-312)."""
        x, n = self._stage(w)
        word = _int(ksw.utf16_swar_first_bad_word(x, n, be))
        if word == BIG:
            return Result(ec.SUCCESS, n)
        fb = word * 2
        start = max(fb - 4, 0)
        if start > 0:
            u, pu = int(w[start]), int(w[start - 1])
            if be:
                u, pu = _bswap(u), _bswap(pu)
            if (u & 0xFC00) == 0xDC00 and (pu & 0xFC00) == 0xD800:
                start -= 1
        res = vh.validate_utf16_with_errors(w[start: min(fb + 8, n)], be)
        if res.is_err:
            return Result(res.error, start + res.count)
        self.safety_net += 1
        pos = _int(k16.utf16_first_bad(x, n, be))
        if pos >= n:
            return Result(ec.SUCCESS, n)
        return Result(ec.SURROGATE, pos)

    # -- UTF-8 -> Latin-1 of ASCII input: a copy -----------------------------
    @staticmethod
    def _peek_ascii8(b) -> bool:
        n = b.shape[0]
        if n == 0:
            return True
        return int(b[:: max(1, n // 4096)].max()) < 0x80

    def _is_ascii_fast(self, b) -> bool:
        """The host peek, then one ASCII SWAR scan."""
        if not self._peek_ascii8(b):
            return False
        x, n = self._stage(b)
        return _int(ksw.ascii_swar_first_bad_word(x, n)) == BIG

    def convert_valid_utf8_to_latin1(self, b):
        if self._is_ascii_fast(b):
            return np.array(b, copy=True)
        return super().convert_valid_utf8_to_latin1(b)

    def convert_utf8_to_latin1_with_errors(self, b):
        if self._is_ascii_fast(b):
            return Result(ec.SUCCESS, int(b.shape[0])), np.array(b, copy=True)
        return super().convert_utf8_to_latin1_with_errors(b)

    # -- base64: the clean decode, the forgiving decode when it flags ---------
    def base64_to_binary_details(self, src, options=0, last_chunk=bh.LOOSE):
        """Whitespace-free input is a fixed-rate 4 -> 3 repack (the
        reference's block64 kernels with their whitespace escape hatch,
        generic/base64.h:103-141); everything else, and whatever the
        kernel's flag rejects, takes the inherited forgiving decode
        (simdutf_tpu/kernels/impl.py:724-763)."""
        garbage = bh.ignore_garbage(options)
        n = int(src.shape[0])
        if garbage or src.dtype == np.uint16 or n < 4:
            return super().base64_to_binary_details(src, options, last_chunk)
        tab = bh.value_table(options)
        # host peek: a strided sample of the body must be alphabet chars
        sample = np.asarray(src[: max(0, n - 4): max(1, n // 2048)])
        if len(sample) and int(tab[sample].max(initial=0)) > 63:
            return super().base64_to_binary_details(src, options, last_chunk)
        srclen, pad_count, pad_pos = bh.b64_strip(src, tab, garbage)
        nfull = srclen // 4 * 4
        tail_vals = [int(tab[int(c)]) for c in np.asarray(src[nfull:srclen])]
        if any(v > 63 for v in tail_vals):
            return super().base64_to_binary_details(src, options, last_chunk)
        x, _ = self._stage(src[:nfull])
        out, flag = kb64.clean_decode(x, nfull // 4, url=bool(options & bh.BASE64_URL),
                                      both=bool(options & bh.BASE64_DEFAULT_OR_URL))
        if _int(flag):
            return super().base64_to_binary_details(src, options, last_chunk)
        outlen = nfull // 4 * 3
        body = _cut8(out, outlen)
        full, extra = bh.b64_tail_epilogue(outlen, srclen - nfull, tail_vals, nfull,
                                           srclen, pad_count, pad_pos, garbage,
                                           last_chunk)
        if len(extra):
            body = np.concatenate([body, extra])
        return full, body

