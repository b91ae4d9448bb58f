"""route_host_us: host time a call in the routing layer, in us: the self
time of the program's ``simdutf.route.*`` spans (an ``ops`` function's
Python and torch glue, such as the census route's branch closures or the
base64 ``_finish``'s torch ops), less the kernel wrappers and host syncs
inside them, in the traced window."""

from bench_torch import progtrace


def read(ctx):
    return progtrace.self_us(ctx, "route")
