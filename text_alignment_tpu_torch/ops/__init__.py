"""Raster operations of the port: the host oracle and native engine
(copies of the JAX package's), the connected-components kernels
(:mod:`.cc`, :mod:`.cc_kernel`), the device skew search and the raster on
a device (:mod:`.device`), the port's one raster on the card."""

from . import oracle
from . import device
from .projections import (
    moving_avg_filter,
    calculate_peak_prominence,
    find_peak_locations,
)

__all__ = [
    "oracle",
    "device",
    "moving_avg_filter",
    "calculate_peak_prominence",
    "find_peak_locations",
]
