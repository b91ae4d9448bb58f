"""kernel_host_us: host time a call in the kernel wrappers, in us: the
self time of the program's ``simdutf.kernel.*`` spans (argument checks,
output and scratch allocation, the ctypes launch), in the traced
window."""

from bench_torch import progtrace


def read(ctx):
    return progtrace.self_us(ctx, "kernel")
