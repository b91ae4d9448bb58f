"""TorchImplementation: host glue around the torch ops (port of
simdutf_tpu/ops/impl.py for the UTF-8 -> UTF-16 slice).

Inputs are padded to the JAX package's buckets (power of two >= 1 KiB with
8 slack bytes, 16 MiB steps above 64 MiB), so both packages see the same
padded buffer and their full outputs compare bit for bit. The logical
length travels beside the buffer. Methods take and return numpy arrays,
as the public api expects; methods not overridden here fall back to the
golden tier of :class:`simdutf_tpu.implementation.Implementation`.
"""

from __future__ import annotations

import numpy as np
import torch

from simdutf_tpu.errors import Result, error_code as ec
from simdutf_tpu.implementation import Implementation
from simdutf_tpu.runtime import staging_buffer

from . import runtime
from .kernels import validate as kv
from .ops import utf8 as o8

_MIN_BUCKET = 1024
_POW2_CAP = 64 << 20
_BIG_STEP = 16 << 20


def _bucket(n: int, multiple: int = 4) -> int:
    """simdutf_tpu/ops/impl._bucket, value for value."""
    need = max(n + 8, _MIN_BUCKET)
    if need > _POW2_CAP:
        cap = -(-need // _BIG_STEP) * _BIG_STEP
    else:
        cap = 1 << (need - 1).bit_length()
    if cap % multiple:
        cap += multiple - cap % multiple
    return cap


def _pad(arr: np.ndarray, multiple: int = 4):
    """(zero-padded np buffer of _bucket(len) elements, np.int32 length),
    as simdutf_tpu/ops/impl._pad builds it."""
    n = int(arr.shape[0])
    out = staging_buffer((_bucket(n, multiple),), arr.dtype, fill_len=n,
                         tag="torch_pad1d")
    out[:n] = arr
    return out, np.int32(n)


def to_device(buf: np.ndarray, length, device) -> tuple[torch.Tensor, int]:
    """The staging state both packages share, ``(np.uint8[cap], length)``
    from :func:`_pad`, as ``(torch.uint8[cap] on device, int length)``."""
    return runtime.to_device(buf, torch.device(device)), int(length)


def _res(code, pos) -> Result:
    return Result(ec(int(code)), int(pos))


def _cut(out: torch.Tensor, out_len: int) -> np.ndarray:
    """The first ``out_len`` uint16 units as a numpy array."""
    return out[:out_len].view(torch.int16).cpu().numpy().view(np.uint16)


class TorchImplementation(Implementation):
    """The UTF-8 -> UTF-16 slice on torch tensors on one explicit device:
    Hopper kernels on a CUDA device of compute capability 9.0, their plain
    torch versions on the CPU."""

    name = "torch"
    description = "PyTorch ops + hand-written Hopper kernels (CUDA sm_90a)"

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchImplementation('cuda'): CUDA is not available")
            cap = torch.cuda.get_device_capability(self.device)
            if cap != (9, 0):
                raise RuntimeError(
                    f"TorchImplementation('cuda'): needs compute capability "
                    f"(9, 0) (Hopper), found {cap}")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.description = f"{self.description} on {self.device}"

    def _stage(self, b: np.ndarray):
        return to_device(*_pad(b), self.device)

    # -- validation ----------------------------------------------------------
    def validate_utf8(self, b):
        return self.validate_utf8_with_errors(b).is_ok

    def validate_utf8_with_errors(self, b):
        code, pos = o8.validate_with_errors(*self._stage(b))
        return _res(*torch.stack([code, pos]).tolist())

    # -- counts / lengths ----------------------------------------------------
    def count_utf8(self, b):
        return int(o8.count_code_points(*self._stage(b)))

    def utf16_length_from_utf8(self, b):
        return int(o8.utf16_length(*self._stage(b)))

    def utf32_length_from_utf8(self, b):
        return self.count_utf8(b)

    def latin1_length_from_utf8(self, b):
        return self.count_utf8(b)

    def utf8_length_from_latin1(self, b):
        return int(kv.latin1_utf8_length(*self._stage(b)))

    # -- conversions ---------------------------------------------------------
    def _convert(self, b, big_endian: bool):
        code, pos, out, out_len = o8.to_utf16(*self._stage(b), big_endian)
        code, pos, out_len = torch.stack([code, pos, out_len]).tolist()
        if code == 0:
            # success count = code units written (error.h:36-38)
            return Result(ec.SUCCESS, out_len), _cut(out, out_len)
        return Result(ec(code), pos), _cut(out, out_len)

    def convert_utf8_to_utf16le_with_errors(self, b):
        return self._convert(b, False)

    def convert_utf8_to_utf16be_with_errors(self, b):
        return self._convert(b, True)

    def convert_valid_utf8_to_utf16le(self, b):
        out, total = o8.to_utf16_valid(*self._stage(b), False)
        return _cut(out, int(total))

    def convert_valid_utf8_to_utf16be(self, b):
        out, total = o8.to_utf16_valid(*self._stage(b), True)
        return _cut(out, int(total))
