"""Share of the traced grids in which no device operation ran."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
