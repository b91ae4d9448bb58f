"""Driver of the ``utf16_to_utf8`` configuration: validating UTF-16LE ->
UTF-8 with the first error (``utf16_to_utf8.json``).

The entry: ``simdutf_tpu_torch.ops.utf16.to_utf8(buf, length,
big_endian=False)`` on one buffer of units staged once, as the port stages
it (``impl._pad`` + ``impl.to_device``); a call ends when its ``(code,
pos, out_len)`` are on the host, read with one ``.tolist()`` as
``impl._converted`` reads them. The output stays on the device.

The control is the program's own big-endian path (``big_endian=True``):
it breaks the configuration's UTF-16LE guarantee.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.configs import utf16_to_utf8_ref as ref
from bench_torch.harness import Reservoir, Session

KEEP = 2  # output buffers a run keeps for the check


def needed_bytes(length: int, out_len: int) -> int:
    """The bytes a call needs at the least: its ``length`` units read
    once, its ``out_len`` UTF-8 bytes written once."""
    return 2 * length + out_len


class DeviceSession(Session):
    def __init__(self, data: np.ndarray, seed: int, device, control: bool):
        from simdutf_tpu_torch import impl
        from simdutf_tpu_torch.ops import utf16 as o16

        if data.shape[0] != 1:
            raise ValueError("the device entry drives one buffer")
        self.host = data[0].view(np.uint16)
        buf, length = impl._pad(self.host)
        self.x, self.n = impl.to_device(buf, length, device)
        self.big_endian = control
        self.entry = o16.to_utf8
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.scalars: list = []
        self.kept = Reservoir(KEEP, self.seed)
        self.needed_bytes = 0

    def call(self, i: int) -> int:
        code, pos, out, out_len = self.entry(self.x, self.n, self.big_endian)
        vals = tuple(torch.stack([code, pos, out_len]).tolist())
        self.scalars.append(vals)
        self.kept.offer((i, out))
        self.needed_bytes += needed_bytes(self.n, vals[2])
        return 2 * self.n

    def release(self) -> None:
        del self.x

    def check(self):
        code, pos, want = ref.convert(self.host.tobytes())
        m = len(want)
        wrong = {i for i, v in enumerate(self.scalars) if v != (code, pos, m)}
        scalars_wrong = len(wrong)
        bytes_wrong = 0
        for i, out in self.kept.items:
            got = out.cpu().numpy()
            bad = (int(np.count_nonzero(got[:m] != want[: len(got)]))
                   + max(0, m - len(got)) + int(np.count_nonzero(got[m:])))
            bytes_wrong += bad
            if bad:
                wrong.add(i)
        notes = [f"reference: code {code}, pos {pos}, {m} bytes; "
                 f"{len(self.scalars)} calls' scalars and {len(self.kept.items)} "
                 f"sampled outputs compared"]
        return ({"scalars_wrong": (scalars_wrong, 0), "bytes_wrong": (bytes_wrong, 0)},
                len(wrong), notes)


def make(data: np.ndarray, seed: int, device, control: bool) -> Session:
    return DeviceSession(data, seed, device, control)
