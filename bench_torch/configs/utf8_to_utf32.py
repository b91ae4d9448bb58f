"""The ``utf8_to_utf32`` configuration's session: validating UTF-8 ->
UTF-32 with the first error (``utf8_to_utf32.json``).

The entry: ``simdutf_tpu_torch.ops.utf8.to_utf32(buf, length)`` on one
buffer staged once, as the port stages it (``impl._pad`` +
``impl.to_device``); a call ends when its ``(code, pos, out_len)`` are on
the host, read with one ``.tolist()`` as ``impl._converted`` reads them.
The output, int32[N] holding the uint32 words, stays on the device.

The control is the program's own Latin-1 path, ``ops.latin1.to_utf32``
on the same bytes: it takes every byte for a code point, breaking the
one-word-per-sequence guarantee. It returns only the buffer, so its
scalars are ``(SUCCESS, length, length)``, made on the device after the
widen so that its call too ends when the words are written.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.configs import utf8_to_utf32_ref as ref
from bench_torch.harness import Reservoir, Session

KEEP = 2  # output buffers a run keeps for the check


def needed_bytes(length: int, out_len: int) -> int:
    """The bytes a call needs at the least: its input read once, its
    ``out_len`` UTF-32 words written once."""
    return length + 4 * out_len


def latin1_control(x: torch.Tensor, n: int):
    """``ops.latin1.to_utf32`` in the entry's form: (code, pos, out,
    out_len) with the scalars ``(SUCCESS, n, n)``."""
    from simdutf_tpu_torch.ops import latin1 as ol1

    out = ol1.to_utf32(x, n)
    z = torch.zeros((), dtype=torch.int64, device=out.device)
    return z, z + n, out, z + n


class DeviceSession(Session):
    def __init__(self, data: np.ndarray, seed: int, device, control: bool):
        from simdutf_tpu_torch import impl
        from simdutf_tpu_torch.ops import utf8 as o8

        if data.shape[0] != 1:
            raise ValueError("the device entry drives one buffer")
        self.host = data[0]
        buf, length = impl._pad(self.host)
        self.x, self.n = impl.to_device(buf, length, device)
        self.entry = latin1_control if control else o8.to_utf32
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.scalars: list = []
        self.kept = Reservoir(KEEP, self.seed)
        self.needed_bytes = 0

    def call(self, i: int) -> int:
        code, pos, out, out_len = self.entry(self.x, self.n)
        vals = tuple(torch.stack([code, pos, out_len]).tolist())
        self.scalars.append(vals)
        self.kept.offer((i, out))
        self.needed_bytes += needed_bytes(self.n, vals[2])
        return self.n

    def release(self) -> None:
        del self.x

    def check(self):
        code, pos, words = ref.convert(self.host.tobytes())
        m = len(words)
        wrong = {i for i, v in enumerate(self.scalars) if v != (code, pos, m)}
        scalars_wrong = len(wrong)
        words_wrong = 0
        for i, out in self.kept.items:
            got = out.cpu().numpy().view(np.uint32)
            bad = (int(np.count_nonzero(got[:m] != words[: len(got)]))
                   + max(0, m - len(got)) + int(np.count_nonzero(got[m:])))
            words_wrong += bad
            if bad:
                wrong.add(i)
        notes = [f"reference: code {code}, pos {pos}, {m} words; "
                 f"{len(self.scalars)} calls' scalars and {len(self.kept.items)} "
                 f"sampled outputs compared"]
        return ({"scalars_wrong": (scalars_wrong, 0), "words_wrong": (words_wrong, 0)},
                len(wrong), notes)


def make(data: np.ndarray, seed: int, device, control: bool) -> Session:
    return DeviceSession(data, seed, device, control)
