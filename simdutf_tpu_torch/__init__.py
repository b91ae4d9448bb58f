"""simdutf_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of simdutf_tpu.

It serves four slices: the validating UTF-8 -> UTF-16LE/BE path with exact
first-error validation and the UTF-8 counts, the validating UTF-16LE/BE ->
UTF-8 path with the UTF-16 validation and counts, the validating UTF-8 <->
UTF-32 paths with the UTF-32 validation and lengths, and forgiving base64
decode (uint8 and char16 input) and encode. Its kernels are hand-written
CUDA C++ for sm_90a (``csrc/``), built with nvcc at first use; every
kernel has a plain torch version beside it, which is what runs for a
tensor on the CPU. The package stands alone: it imports neither jax nor
the JAX package it was ported from.

Its public entry points are in :mod:`simdutf_tpu_torch.api`, with the
names and contracts of the JAX package's api::

    from simdutf_tpu_torch import api
    res, utf16 = api.convert_utf8_to_utf16le_with_errors(data)  # on "cuda"
    api.use_device("cpu")  # the plain torch versions, no card needed
"""

from __future__ import annotations

from . import api
from .impl import TorchImplementation

__all__ = ["TorchImplementation", "api"]
