"""Driver of the ``utf8_to_utf16`` configuration: validating UTF-8 ->
UTF-16LE with the first error (``utf8_to_utf16.json``).

The entry: ``simdutf_tpu_torch.ops.utf8.to_utf16(buf, length,
big_endian=False)`` on one buffer staged once, as the port stages it
(``impl._pad`` + ``impl.to_device``); a call ends when its ``(code, pos,
out_len)`` are on the host, read with one ``.tolist()`` as
``impl._converted`` reads them. The output stays on the device.

The control is the program's own big-endian path (``big_endian=True``):
it breaks the configuration's UTF-16LE guarantee.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.configs import utf8_to_utf16_ref as ref
from bench_torch.harness import Reservoir, Session

KEEP = 2  # output buffers a run keeps for the check


def needed_bytes(length: int, out_len: int) -> int:
    """The bytes a call needs at the least: its input read once, its
    ``out_len`` UTF-16 units written once."""
    return length + 2 * out_len


class DeviceSession(Session):
    def __init__(self, data: np.ndarray, seed: int, device, control: bool):
        from simdutf_tpu_torch import impl
        from simdutf_tpu_torch.ops import utf8 as o8

        if data.shape[0] != 1:
            raise ValueError("the device entry drives one buffer")
        self.host = data[0]
        buf, length = impl._pad(self.host)
        self.x, self.n = impl.to_device(buf, length, device)
        self.big_endian = control
        self.entry = o8.to_utf16
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
        return self.n

    def release(self) -> None:
        del self.x

    def check(self):
        code, pos, units = ref.convert(self.host.tobytes())
        want = (code, pos, len(units))
        wrong = {i for i, v in enumerate(self.scalars) if v != want}
        scalars_wrong = len(wrong)
        units_wrong = 0
        for i, out in self.kept.items:
            got = out.view(torch.int16).cpu().numpy().view(np.uint16)
            m = len(units)
            bad = (int(np.count_nonzero(got[:m] != units[: len(got)]))
                   + max(0, m - len(got)) + int(np.count_nonzero(got[m:])))
            units_wrong += bad
            if bad:
                wrong.add(i)
        notes = [f"reference: code {code}, pos {pos}, {len(units)} units; "
                 f"{len(self.scalars)} calls' scalars and {len(self.kept.items)} "
                 f"sampled outputs compared"]
        return ({"scalars_wrong": (scalars_wrong, 0), "units_wrong": (units_wrong, 0)},
                len(wrong), notes)


def make(data: np.ndarray, seed: int, device, control: bool) -> Session:
    return DeviceSession(data, seed, device, control)
