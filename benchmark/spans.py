"""Readers of the program's spans: the ``ta.`` host ranges that the port
opens while a profiler records (``text_alignment_tpu_torch/utils/
timing.py``'s ``span``), found among the traced run's host events. A
stage's host milliseconds a traced item, and the share of the device's
idle time that no span explains. Each returns None where the trace holds
no span it reads."""

from __future__ import annotations

from . import trace

PREFIX = "ta."


def span_ms(*names):
    """A reader: the milliseconds a traced item of the spans named
    ``names``, summed over the traced items and divided by their count."""
    def read(ctx):
        hits = [e - s for name, s, e in ctx.host if name in names]
        if not hits or not ctx.traced:
            return None
        return sum(hits) * 1e-3 / len(ctx.traced)
    return read


def covered_us(intervals, t0, t1):
    """Microseconds of [t0, t1] inside the union of ``intervals``, each
    (start, end)."""
    clipped = sorted((max(s, t0), min(e, t1)) for s, e in intervals)
    return trace.busy_us([(None, s, e) for s, e in clipped if e > s])


def idle_unspanned_pct(ctx):
    """100 x the device-idle time in which no ``ta.`` span is open over the
    device-idle time, both within the traced stretch: from the first host
    event's start to the last one's end, as the run's breakdown takes
    it."""
    spans = [(s, e) for name, s, e in ctx.host if name.startswith(PREFIX)]
    if not spans:
        return None
    t0 = min(s for _, s, _ in ctx.host)
    t1 = max(e for _, _, e in ctx.host)
    dev = [(s, e) for _, s, e in ctx.dev]
    idle = (t1 - t0) - covered_us(dev, t0, t1)
    if idle <= 0:
        return None
    return 100.0 * ((t1 - t0) - covered_us(dev + spans, t0, t1)) / idle
