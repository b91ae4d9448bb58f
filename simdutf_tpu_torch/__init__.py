"""simdutf_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of simdutf_tpu.

It serves every function of the JAX package's api: ASCII, UTF-8, UTF-16
and UTF-32 validation with the exact first error, counts and lengths, the
validating and valid transcode matrix over UTF-8, UTF-16LE/BE, UTF-32 and
Latin-1, the UTF-16 utilities (endianness swap, ``to_well_formed``),
``trim_partial``, encoding detection, and forgiving base64 decode (uint8
and char16 input, capacity-limited too) and encode. Its kernels are hand-written
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
from .encodings import (bom_byte_size, check_bom, encoding_type, endianness,
                        match_system, to_string)
from .errors import FullResult, Result, error_code
from .impl import TorchImplementation

__all__ = ["FullResult", "Result", "TorchImplementation", "api", "bom_byte_size",
           "check_bom", "encoding_type", "endianness", "error_code", "match_system",
           "to_string"]
