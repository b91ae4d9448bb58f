"""setup_s: seconds from the start of the process to the start of the
window: imports, the CUDA context, the kernels' library (and its build in a
fresh checkout), the data from the seed, its staging and the warm-up."""


def read(ctx):
    return ctx.setup_s
