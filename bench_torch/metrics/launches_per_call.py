"""launches_per_call: the program's kernel launches a call (its
``launches`` counter, every C entry point, over the traced window's
calls)."""

from bench_torch import progtrace


def read(ctx):
    return progtrace.per_call(ctx, "launches")
