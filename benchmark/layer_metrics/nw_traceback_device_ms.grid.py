"""Device milliseconds a grid of the NW traceback kernel (``ta_nw_traceback``); its byte bound means nothing, as the walk is a chain of dependent steps."""

from benchmark import trace


def read(ctx):
    us, n = trace.kernel_us(ctx.dev, "ta_nw_traceback")
    return us * 1e-3 / len(ctx.traced) if n else None
