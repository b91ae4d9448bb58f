"""Torch ops of the port (counterparts of simdutf_tpu/ops)."""
