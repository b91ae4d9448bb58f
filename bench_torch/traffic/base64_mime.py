"""Seeded binary attachments as MIME base64 bodies.

Parameters (the ``traffic`` object of a workload file):

* ``raw_bytes``: bytes of the attachment, drawn uniformly from the seed
  with a ``torch.Generator`` on the device (binary attachments are close to
  random bytes);
* ``line``: chars a line (RFC 2045 section 6.8: at most 76).

The body is the attachment's base64 in the standard alphabet, with ``=``
padding when ``raw_bytes`` is not a multiple of 3, and CRLF after every
full line but the last, as a MIME encoder writes it.
"""

from __future__ import annotations

import base64

import numpy as np
import torch


def mime_lines(raw: bytes, line: int) -> np.ndarray:
    """uint8 chars of ``raw``'s base64, CRLF after every full line of
    ``line`` chars but the last."""
    enc = np.frombuffer(base64.b64encode(raw), np.uint8)
    full = (len(enc) - 1) // line if len(enc) else 0
    body = np.empty((full, line + 2), np.uint8)
    body[:, :line] = enc[: full * line].reshape(full, line)
    body[:, line:] = np.frombuffer(b"\r\n", np.uint8)
    return np.concatenate([body.reshape(-1), enc[full * line:]])


def generate(params: dict, seed: int, device) -> np.ndarray:
    """uint8[1, chars] on the host; see the module docstring."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    raw = torch.randint(0, 256, (int(params["raw_bytes"]),), generator=g,
                        device=dev, dtype=torch.uint8)
    return mime_lines(raw.cpu().numpy().tobytes(), int(params["line"]))[None, :]
