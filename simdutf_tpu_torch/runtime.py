"""Host runtime: allocator tuning, padded staging buffers and host-to-device
copies (the port's own copy of simdutf_tpu/runtime.py, with the copy to the
device added).

* :func:`tune_host_allocator`: glibc ``mallopt(M_MMAP_MAX, 0)`` and
  ``mallopt(M_TRIM_THRESHOLD, -1)``, so large blocks live on the heap and
  are not returned to the kernel: on virtualized hosts first-touch page
  faults are slow, and a call's tens of MB of host temporaries would
  fault afresh every call.
* :func:`staging_buffer`: a zeroed padding buffer, pooled per thread and
  reused across calls.
* :func:`to_device` moves a padded host buffer onto an explicit device. For
  a CUDA device the bytes go through a pinned host buffer, pooled per
  thread, and a non-blocking copy on the current stream; the pooled buffer
  is reused only after an event recorded behind that copy has completed.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import trace

_tls = threading.local()
_lock = threading.Lock()
_tuned: bool | None = None
_M_MMAP_MAX = -4
_M_TRIM_THRESHOLD = -1
_MAX_POOLED_BYTES = 1 << 31


def tune_host_allocator() -> bool:
    """Idempotent; returns True if the tuning was applied (glibc only)."""
    global _tuned
    with _lock:
        if _tuned is None:
            try:
                libc = ctypes.CDLL("libc.so.6", use_errno=True)
                _tuned = bool(libc.mallopt(_M_MMAP_MAX, 0)
                              and libc.mallopt(_M_TRIM_THRESHOLD, -1))
            except OSError:  # not glibc: nothing to tune
                _tuned = False
        return _tuned


def staging_buffer(size: int, dtype, fill_len: int) -> np.ndarray:
    """A 1-D buffer of ``size`` elements of ``dtype`` whose elements from
    ``fill_len`` on are zero; the caller writes ``[:fill_len]``. Pooled per
    thread and shape: the buffer is borrowed until the next call with the
    same shape on this thread, and only the region the last borrower wrote
    past ``fill_len`` is zeroed again."""
    pool = getattr(_tls, "staging", None)
    if pool is None:
        pool = _tls.staging = {}
    key = (int(size), np.dtype(dtype).str)
    entry = pool.get(key)
    if entry is None:
        buf = np.zeros(size, dtype)
        if buf.nbytes <= _MAX_POOLED_BYTES:
            pool[key] = [buf, fill_len]
        return buf
    buf, dirty = entry
    if dirty > fill_len:
        buf[fill_len:dirty] = 0
    entry[1] = fill_len
    return buf


def _pinned(nbytes: int) -> tuple[torch.Tensor, torch.cuda.Event]:
    """This thread's pinned staging buffer of at least ``nbytes`` and the
    event of its last copy."""
    entry = getattr(_tls, "pinned", None)
    if entry is None or entry[0].shape[0] < nbytes:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        entry = _tls.pinned = (buf, torch.cuda.Event())
    else:
        # the previous copy out of it has finished
        trace.sync("runtime.pinned", torch.cuda.Event.synchronize, entry[1])
    return entry


#: host dtype -> device dtype; UTF-32 words arrive as int32 (this torch
#: build has no CPU kernels for uint32 arithmetic)
_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
           np.dtype(np.uint32): torch.int32}


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A 1-D tensor on ``device`` holding a copy of the 1-D uint8, uint16
    or uint32 array ``host``: uint8, uint16, or int32 for uint32 words (the
    same bits). The bytes travel as uint8 and are viewed as the device
    dtype on arrival."""
    if host.dtype not in _DTYPES or host.ndim != 1:
        raise TypeError(
            f"expected a 1-D uint8, uint16 or uint32 array, got {host.dtype}{host.shape}")
    dtype = _DTYPES[host.dtype]
    src = torch.from_numpy(np.ascontiguousarray(host).view(np.uint8))
    if device.type != "cuda":
        return src.clone().view(dtype)
    n = src.shape[0]
    buf, done = _pinned(n)
    buf[:n].copy_(src)
    dev = torch.empty(n, dtype=torch.uint8, device=device)
    dev.copy_(buf[:n], non_blocking=True)
    done.record()
    return dev.view(dtype)
