"""Share of its roofline of the line normalizer's center tail (``ta_tail_row_mean``, ``ta_tail_col_mean``, ``ta_tail_center``; ``models.lineest_kernel``) over the traced folios: the least time of the bytes and operations the strips need (``work/ocr.py``) over the three kernels' device time."""

from benchmark import trace

KERNELS = ("ta_tail_row_mean", "ta_tail_col_mean", "ta_tail_center")


def read(ctx):
    least = ctx.work.least_seconds("lineest_tail")
    us = n = 0
    for match in KERNELS:
        a, b = trace.kernel_us(ctx.dev, match)
        us, n = us + a, n + b
    if least is None or n == 0 or us <= 0:
        return None
    return 100.0 * least / (us * 1e-6)
