"""Host-to-device staging (port of simdutf_tpu/runtime.py's staging side).

:func:`to_device` moves a padded host buffer onto an explicit device. For a
CUDA device the bytes go through a pinned host buffer, pooled per thread,
and a non-blocking copy on the current stream; the pooled buffer is reused
only after an event recorded behind that copy has completed.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_tls = threading.local()


def _pinned(nbytes: int) -> tuple[torch.Tensor, torch.cuda.Event]:
    """This thread's pinned staging buffer of at least ``nbytes`` and the
    event of its last copy."""
    entry = getattr(_tls, "pinned", None)
    if entry is None or entry[0].shape[0] < nbytes:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        entry = _tls.pinned = (buf, torch.cuda.Event())
    else:
        entry[1].synchronize()  # the previous copy out of it has finished
    return entry


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A 1-D uint8 tensor on ``device`` holding a copy of the 1-D uint8
    array ``host``."""
    if host.dtype != np.uint8 or host.ndim != 1:
        raise TypeError(f"expected a 1-D uint8 array, got {host.dtype}{host.shape}")
    src = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return src.clone()
    n = src.shape[0]
    buf, done = _pinned(n)
    buf[:n].copy_(src)
    dev = torch.empty(n, dtype=torch.uint8, device=device)
    dev.copy_(buf[:n], non_blocking=True)
    done.record()
    return dev
