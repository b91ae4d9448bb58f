"""simdutf_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of simdutf_tpu.

It serves three slices: the validating UTF-8 -> UTF-16LE/BE main path
with exact first-error validation and the UTF-8 counts, the validating
UTF-16LE/BE -> UTF-8 path with exact first-error UTF-16 validation and
the UTF-16 counts, and forgiving base64 decode (uint8 and char16 input)
and encode. Its kernels are hand-written CUDA C++ for sm_90a
(``csrc/``), built with nvcc at first use; every
kernel has a plain torch version beside it, which is what runs for a
tensor on the CPU. The JAX package stays the reference; this package
imports no jax.

Install it as the active tier of the public ``simdutf_tpu`` api::

    import simdutf_tpu as su
    import simdutf_tpu_torch
    su.set_active_implementation(simdutf_tpu_torch.TorchImplementation("cuda"))

Importing the package registers nothing.
"""

from __future__ import annotations

from .impl import TorchImplementation


def activate(device="cuda") -> TorchImplementation:
    """Install ``TorchImplementation(device)`` as the active implementation
    of the public ``simdutf_tpu`` api and return it."""
    from simdutf_tpu.registry import set_active_implementation

    impl = TorchImplementation(device)
    set_active_implementation(impl)
    return impl


__all__ = ["TorchImplementation", "activate"]
