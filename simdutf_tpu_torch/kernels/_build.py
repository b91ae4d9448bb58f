"""Build, load and bind the Hopper kernels in ``simdutf_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` (one process per source,
in parallel) and links them into one shared library with a plain C
interface, ``build/simdutf_tpu_torch/libsimdutf_torch.so``
under the checkout root, and ``ctypes`` loads it. A stamp file holds a
digest of the sources and flags, so a changed source rebuilds and an
unchanged one is loaded as built. Nothing here runs at import.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0, and counts
the launch (``trace.launch``).
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

from .. import trace
from ..ops.common import BIG

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "simdutf_tpu_torch"
LIB_NAME = "libsimdutf_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
#: C signature of every entry point, the stream last (all return int: a
#: cudaError_t)
SIGNATURES = {
    "census_utf8": (_P, _I64, _I64, _P, _P),
    "utf8_first_event": (_P, _I64, _P, _P),
    "utf8_count": (_P, _I64, _I32, _P, _P),
    "ascii_first_bad": (_P, _I64, _P, _P),
    "compose16": (_P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _P, _P),
    "compose16_grid": (_P, _I64, _I64, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P),
    "census_utf16": (_P, _I64, _I32, _P, _P),
    "utf16_first_bad": (_P, _I64, _I32, _P, _P),
    "utf16_count": (_P, _I64, _I32, _I32, _P, _P),
    "utf16_to_well_formed": (_P, _I64, _I64, _I32, _P, _P),
    "compose8": (_P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _P, _P),
    "b64_compact8": (_P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _P),
    "b64_compact16": (_P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _P),
    "b64_pack": (_P, _I64, _P, _P),
    "b64_encode": (_P, _I64, _I32, _P, _P),
    "utf32_first_bad": (_P, _I64, _P, _P),
    "utf32_count": (_P, _I64, _I32, _P, _P),
    "compose32": (_P, _I64, _I64, _I32, _P, _P, _P, _P, _P),
    "composex_count": (_P, _I64, _I32, _P, _P, _P, _P),
    "composex_emit": (_P, _I64, _I32, _P, _P, _P),
    "latin1_utf8_count": (_P, _I64, _I32, _P, _P),
    "latin1_utf8_emit": (_P, _I64, _I32, _P, _P, _P),
    "u16_to_u32_count": (_P, _I64, _I32, _I32, _P, _P, _P, _P),
    "u16_to_u32_emit": (_P, _I64, _I32, _I32, _P, _P, _P),
    "u32_to_u16_count": (_P, _I64, _I32, _P, _P, _P, _P),
    "u32_to_u16_emit": (_P, _I64, _I32, _I32, _P, _P, _P),
    "detect_encodings": (_P, _I64, _P, _P, _P),
    "ascii_widen_utf16": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform2_utf8_to_utf16": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform3_utf8_to_utf16": (_P, _I64, _I64, _I32, _P, _P, _P),
    "astral_utf8_to_utf16": (_P, _I64, _I64, _I32, _P, _P, _P),
    "ascii_narrow_utf8": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform2_utf16_to_utf8": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform3_utf16_to_utf8": (_P, _I64, _I64, _I32, _P, _P, _P),
    "latin1_widen_utf32": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform2_utf8_to_utf32": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform3_utf8_to_utf32": (_P, _I64, _I64, _I32, _P, _P, _P),
    "astral_utf8_to_utf32": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform2_utf32_to_utf8": (_P, _I64, _I64, _I32, _P, _P, _P),
    "uniform3_utf32_to_utf8": (_P, _I64, _I64, _I32, _P, _P, _P),
    "astral_utf32_to_utf8": (_P, _I64, _I64, _I32, _P, _P, _P),
    "bmp_widen_utf32": (_P, _I64, _I64, _I32, _P, _P, _P),
    "astral_utf16_to_utf32": (_P, _I64, _I64, _I32, _P, _P, _P),
    "bmp_narrow_utf16": (_P, _I64, _I64, _I32, _P, _P, _P),
    "astral_utf32_to_utf16": (_P, _I64, _I64, _I32, _P, _P, _P),
    "widen32_plan": (_I32, _P),
    "narrow3_plan": (_P, _I64, _P, _P),
    "utf8_swar_first_bad_word": (_P, _I64, _P, _P),
    "ascii_swar_first_bad_word": (_P, _I64, _P, _P),
    "utf16_swar_first_bad_word": (_P, _I64, _I32, _P, _P),
    "clean_decode": (_P, _I64, _I64, _I32, _I32, _P, _P, _P),
    "row_compact": (_P, _P, _I64, _I32, _P, _P, _P),
    "lane_shapecast_probe": (_P, _I64, _I32, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Compile the library unless the stamp matches the sources; returns
    its path. Each ``.cu`` compiles to an object in its own ``nvcc``
    process, all started together; one more links them. A file lock
    serialises concurrent builds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib_path
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for obj, proc in jobs:  # wait for every process, failed or not
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{obj.stem}.cu ({proc.returncode}):\n{err[-3000:]}")
            elif verbose:
                print(err, end="")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = BUILD_DIR / (LIB_NAME + ".tmp")
        proc = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *[str(o) for o, _ in jobs]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
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
    current device; raise if the launch failed. Every launch of the port
    passes here, and is counted in :mod:`..trace`'s ``launches[name]``
    while a profiler records."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
    trace.launch(name)


def lookback_scratch(nt: int, device) -> torch.Tensor:
    """Scratch of a look-back kernel over ``nt`` tiles (csrc/lookback.cuh's
    ``Lookback`` layout): a 16-byte counter, then 16 bytes a tile for its
    aggregate slot, 16 for its inclusive slot and 16 for extra words.
    Uncleared: the entry point clears the counter and the slots on the
    stream."""
    return torch.empty(16 + 48 * nt, dtype=torch.uint8, device=device)


def lookback_compose(name: str, nt: int, out: torch.Tensor, *args):
    """Launch look-back compose entry point ``name`` (compose8, compose16,
    compose32) over ``nt`` tiles: its C arguments ``args``, then a
    :func:`lookback_scratch`, ``out``, ``res`` int64[4] (total, err_pos,
    err_code, err_len) and ``err_any`` bool[1], which the kernel writes.
    Returns the compose result (out, total, err_any, err_pos, err_code,
    err_len), the scalars 0-d tensors on ``out``'s device, and the
    scratch, whose published slots the tests read."""
    dev = out.device
    res = torch.empty(4, dtype=torch.int64, device=dev)
    err_any = torch.empty(1, dtype=torch.bool, device=dev)
    scratch = lookback_scratch(nt, dev)
    call(name, *args, scratch.data_ptr(), out.data_ptr(), res.data_ptr(),
         err_any.data_ptr())
    return (out, res[0], err_any[0], res[1], res[2], res[3]), scratch


def nothing_in_range(out: torch.Tensor):
    """The compose result where no element is in range and nothing
    launches: ``out`` (zeroed by the caller), a total of 0 and no error."""
    z = torch.zeros((), dtype=torch.int64, device=out.device)
    return out, z, z != 0, z + BIG, z, z


def check_bytes(b: torch.Tensor, length: int) -> str:
    """Validate a kernel input: a contiguous 1-D uint8 tensor with
    0 <= length <= its size, on the CPU or the current CUDA device.
    Returns the device type ("cpu" or "cuda")."""
    return _check(b, length, torch.uint8)


def check_units(w: torch.Tensor, length: int) -> str:
    """:func:`check_bytes` for a buffer of UTF-16 code units: a contiguous
    1-D uint16 tensor, ``length`` counted in units."""
    return _check(w, length, torch.uint16)


def check_words(w: torch.Tensor, length: int) -> str:
    """:func:`check_bytes` for a buffer of UTF-32 words: a contiguous 1-D
    int32 tensor holding the uint32 words' bits, ``length`` in words."""
    return _check(w, length, torch.int32)


def _check(b: torch.Tensor, length: int, dtype: torch.dtype) -> str:
    if not isinstance(b, torch.Tensor) or b.dtype != dtype:
        raise TypeError(f"expected a {dtype} tensor, got {getattr(b, 'dtype', type(b))}")
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
