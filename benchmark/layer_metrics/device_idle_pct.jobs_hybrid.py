"""Share of the traced folios in which no device operation ran."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
