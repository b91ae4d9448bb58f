"""Driver of the ``base64_mime`` configuration: WHATWG forgiving-base64
decode of MIME bodies with the default alphabet (``base64_mime.json``).

The entry: ``simdutf_tpu_torch.ops.base64_ops.decode_bulk_routed(
chars, length, url=False, both=False)`` on one buffer staged once, as the
port stages it (``impl._pad`` + ``impl.to_device``); a call ends when its
scalars and its tail are on the host, read in one ``.tolist()`` as
``impl.base64_to_binary_details`` reads them. The decoded bytes stay on the
device.

The control is the program's own URL-alphabet path (``url=True``): it
breaks the configuration's default-alphabet guarantee.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.configs import base64_mime_ref as ref
from bench_torch.harness import Reservoir, Session

KEEP = 2  # decoded buffers a run keeps for the check


def needed_bytes(length: int, nvalid: int) -> int:
    """The bytes a call needs at the least: its chars read once, the bytes
    of its whole quads written once."""
    return length + nvalid // 4 * 3


class DeviceSession(Session):
    def __init__(self, data: np.ndarray, seed: int, device, control: bool):
        from simdutf_tpu_torch import impl
        from simdutf_tpu_torch.ops import base64_ops as ob

        if data.shape[0] != 1:
            raise ValueError("the device entry drives one buffer")
        self.host = data[0]
        buf, length = impl._pad(self.host)
        self.x, self.n = impl.to_device(buf, length, device)
        self.size = len(buf)
        self.url = control
        self.entry = ob.decode_bulk_routed
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.scalars: list = []
        self.kept = Reservoir(KEEP, self.seed)
        self.needed_bytes = 0

    def call(self, i: int) -> int:
        first_bad, nvalid, nab, packed, tail_vals, tail_start = self.entry(
            self.x, self.n, url=self.url, both=False)
        vals = tuple(torch.cat([torch.stack([first_bad, nvalid, nab, tail_start]),
                                tail_vals.to(torch.int64)]).tolist())
        self.scalars.append(vals)
        self.kept.offer((i, packed))
        self.needed_bytes += needed_bytes(self.n, vals[1])
        return self.n

    def release(self) -> None:
        del self.x

    def check(self):
        r = ref.decode(self.host, self.size)
        want = (r["first_bad"], r["nvalid"], r["nvalid_at_bad"], r["tail_start"], *r["tail"])
        wrong = {i for i, v in enumerate(self.scalars) if v != want}
        scalars_wrong = len(wrong)
        bytes_wrong = 0
        exp = r["packed"]
        for i, packed in self.kept.items:
            got = packed[: len(exp)].cpu().numpy()
            bad = int(np.count_nonzero(got != exp[: len(got)])) + len(exp) - len(got)
            bytes_wrong += bad
            if bad:
                wrong.add(i)
        notes = [f"reference: first_bad {r['first_bad']}, nvalid {r['nvalid']}, "
                 f"{len(exp)} bytes; {len(self.scalars)} calls' scalars and "
                 f"{len(self.kept.items)} sampled outputs compared"]
        return ({"scalars_wrong": (scalars_wrong, 0), "bytes_wrong": (bytes_wrong, 0)},
                len(wrong), notes)


def make(data: np.ndarray, seed: int, device, control: bool) -> Session:
    return DeviceSession(data, seed, device, control)
