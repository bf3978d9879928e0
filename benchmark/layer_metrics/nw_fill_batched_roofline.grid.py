"""Share of its roofline of the batched NW fill (``ta_nw_fill_batched``) over the traced grids: valid pointer bytes and cell operations over the kernels' device time."""

from benchmark.readers import nw_fill_batched_roofline as read  # noqa: F401
