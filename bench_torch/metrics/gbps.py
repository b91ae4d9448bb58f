"""gbps: input bytes of every call completed in the window over the
window's seconds, in GB/s (host clock)."""


def read(ctx):
    return ctx.input_bytes / ctx.window_s / 1e9
