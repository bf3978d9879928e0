"""Share of the traced training steps in which no device operation ran."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
