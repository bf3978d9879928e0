"""The NW cell operations of the traced grids over the traced window's time and the card's float32 operation rate."""

from benchmark.readers import mfu

read = mfu("nw_fill")
