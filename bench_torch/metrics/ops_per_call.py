"""ops_per_call: device operations (kernels, memsets, copies) in the traced
window per call."""


def read(ctx):
    t = ctx.trace
    if t is None or t.calls == 0 or t.device_ops == 0:
        return None
    return t.device_ops / t.calls
