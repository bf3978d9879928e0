"""Share of the device's idle time over the traced grids in which no program span (``ta.``) is open: the idle that the program's spans do not explain."""

from benchmark.spans import idle_unspanned_pct as read  # noqa: F401
