"""Hopper kernels of the port, each with its plain torch version."""
