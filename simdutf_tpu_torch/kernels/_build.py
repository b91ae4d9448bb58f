"""Build, load and bind the Hopper kernels in ``simdutf_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, ``build/simdutf_tpu_torch/libsimdutf_torch.so``
under the checkout root, and ``ctypes`` loads it. A stamp file holds a
digest of the sources and flags, so a changed source rebuilds and an
unchanged one is loaded as built. Nothing here runs at import.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "simdutf_tpu_torch"
LIB_NAME = "libsimdutf_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
#: C signature of every entry point (all return int: a cudaError_t)
SIGNATURES = {
    "census_utf8": (_P, _I64, _I64, _P, _P),
    "utf8_first_event": (_P, _I64, _P, _P),
    "utf8_count": (_P, _I64, _I32, _P, _P),
    "compose16_count": (_P, _I64, _I64, _I32, _P, _P, _P, _P),
    "compose16_emit": (_P, _I64, _I64, _I32, _I32, _P, _P, _P, _P),
}

#: kernel launches per wrapper name since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Compile the library unless the stamp matches the sources; returns
    its path. A file lock serialises concurrent builds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib_path
        tmp = BUILD_DIR / (LIB_NAME + ".tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def call(name: str, *args) -> None:
    """Launch C entry point ``name`` on the current stream of the
    current device; raise if the launch failed."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")


def check_bytes(b: torch.Tensor, length: int) -> str:
    """Validate a kernel input: a contiguous 1-D uint8 tensor with
    0 <= length <= its size, on the CPU or the current CUDA device.
    Returns the device type ("cpu" or "cuda")."""
    if not isinstance(b, torch.Tensor) or b.dtype != torch.uint8:
        raise TypeError(f"expected a torch.uint8 tensor, got {getattr(b, 'dtype', type(b))}")
    if b.dim() != 1 or not b.is_contiguous():
        raise ValueError("expected a contiguous 1-D tensor")
    n = b.shape[0]
    if not 0 <= length <= n or n >= 2**31 - 1:
        raise ValueError(f"length {length} outside [0, {n}] or buffer too large")
    kind = b.device.type
    if kind == "cuda":
        if b.device.index != torch.cuda.current_device():
            raise ValueError(f"{b.device} is not the current CUDA device")
        return kind
    if kind == "cpu":
        return kind
    raise ValueError(f"unsupported device {b.device}")
