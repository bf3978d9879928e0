"""Statistics of a run's window: all its work over its whole time,
never a best-of or a median of chunks."""

from __future__ import annotations


def rate(units, t_start, t_end):
    """Units of all the work in the window over the window's time."""
    if t_end <= t_start or units <= 0:
        raise ValueError("no work completed in the window")
    return float(units) / (t_end - t_start)
