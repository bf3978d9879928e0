"""Readers shared by the per-layer metrics (``layer_metrics/<name>.py``
binds one of these, or its own, as ``read``). A reader takes the traced
run's context and returns a number, or None where it finds nothing to
read: it never returns 0 for a share of a roofline or of a peak."""

from __future__ import annotations

from . import trace, work


def device_idle_pct(ctx):
    if ctx.window_s <= 0 or not ctx.dev:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu(work_name):
    """100 x the traced work's operations over the traced window's time x
    the float32 peak."""
    def read(ctx):
        if work_name not in ctx.work.totals or ctx.window_s <= 0:
            return None
        ops = ctx.work.totals[work_name][1]
        if ops <= 0:
            return None
        return 100.0 * ops / (ctx.window_s * work.PEAK_FP32_FLOPS)
    return read


def nw_fill_batched_roofline(ctx):
    """The batched NW fill's kernels (the group route, or the segmented
    fill where a pair takes several CTAs) against the fill's work."""
    least = ctx.work.least_seconds("nw_fill")
    us = n = 0
    for match in ("ta_nw_group_kernel", "ta_nw_fill_kernel"):
        a, b = trace.kernel_us(ctx.dev, match)
        us, n = us + a, n + b
    if least is None or n == 0 or us <= 0:
        return None
    return 100.0 * least / (us * 1e-6)
