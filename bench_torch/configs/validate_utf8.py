"""The ``validate_utf8`` configuration's session: UTF-8 validation with the
exact first error (``validate_utf8.json``).

The entry: ``simdutf_tpu_torch.ops.utf8.validate_with_errors(buf, length)``
on one buffer staged once, as the port stages it (``impl._pad`` +
``impl.to_device``); a call ends when its ``(code, pos)`` are on the host,
read with ``impl._scalars``, the api's own single read. Nothing is written:
a call needs its input read once.

The traffic is valid text, so the window's calls show only the answer for
valid input. After the window the session plants one bad sequence, of a
kind and at a character start drawn from the seed, in its staged buffer,
makes one call of the entry on it at full size, compares that call with
the reference on the planted bytes, and restores the buffer: the exact
first error, code and position, is checked in every run. The position
never opens a 16-byte chunk, so a position rounded to its chunk shows.

The control is the program's own ASCII check,
``ops.utf8.validate_ascii_with_errors`` on the same bytes: it reports
``TOO_LARGE`` at the first byte >= 0x80, breaking the first-error
guarantee on text that holds any.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from bench_torch.configs import validate_utf8_ref as ref
from bench_torch.harness import Session


#: the bad sequences planted after the window, one of each error code;
#: each is invalid whatever follows it, written over a character start
PLANTS = (
    b"\xff",              # HEADER_BITS
    b"\x80",              # TOO_LONG
    b"\xe6\x9d ",         # TOO_SHORT
    b"\xc0\xaf",          # OVERLONG
    b"\xf4\x90\x80\x80",  # TOO_LARGE
    b"\xed\xa0\x80",      # SURROGATE
)


def plant_site(host: np.ndarray, seed: int) -> tuple[int, bytes]:
    """(position, bad sequence) drawn from ``seed``: a character start of
    ``host`` that does not open a 16-byte chunk, and one of :data:`PLANTS`
    that fits before its end."""
    rng = random.Random(seed)
    bad = rng.choice(PLANTS)
    k = rng.randrange(1, len(host) - len(bad) + 1)
    while k > 1 and (host[k] & 0xC0 == 0x80 or k % 16 == 0):
        k -= 1
    return k, bad


def needed_bytes(length: int) -> int:
    """The bytes a call needs at the least: its input read once."""
    return length


class DeviceSession(Session):
    def __init__(self, data: np.ndarray, seed: int, device, control: bool):
        from simdutf_tpu_torch import impl
        from simdutf_tpu_torch.ops import utf8 as o8

        if data.shape[0] != 1:
            raise ValueError("the device entry drives one buffer")
        self.host = data[0]
        buf, length = impl._pad(self.host)
        self.x, self.n = impl.to_device(buf, length, device)
        self.entry = o8.validate_ascii_with_errors if control else o8.validate_with_errors
        self.read = impl._scalars
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.scalars: list = []
        self.needed_bytes = 0

    def call(self, i: int) -> int:
        self.scalars.append(tuple(self.read(*self.entry(self.x, self.n))))
        self.needed_bytes += needed_bytes(self.n)
        return self.n

    def release(self) -> None:
        """One call on the staged buffer with a bad sequence planted (then
        taken out again), before the buffer is freed."""
        k, bad = self.site = plant_site(self.host, self.seed)
        was = self.x[k:k + len(bad)].clone()
        self.x[k:k + len(bad)] = torch.frombuffer(bytearray(bad), dtype=torch.uint8)
        self.planted = tuple(self.read(*self.entry(self.x, self.n)))
        self.x[k:k + len(bad)] = was
        del self.x

    def check(self):
        want = ref.validate(self.host.tobytes())
        wrong = sum(1 for v in self.scalars if v != want)
        k, bad = self.site
        host = self.host.copy()
        host[k:k + len(bad)] = np.frombuffer(bad, np.uint8)
        planted = ref.validate(host.tobytes())
        notes = [f"reference: code {want[0]}, pos {want[1]}; "
                 f"{len(self.scalars)} calls' scalars compared",
                 f"planted {bad.hex()} at {k}: reference code {planted[0]}, pos {planted[1]}; "
                 f"the entry's {self.planted}"]
        return ({"scalars_wrong": (wrong, 0), "planted_wrong": (int(self.planted != planted), 0)},
                wrong, notes)


def make(data: np.ndarray, seed: int, device, control: bool) -> Session:
    return DeviceSession(data, seed, device, control)
