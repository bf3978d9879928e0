"""Raster operations of the port: the host oracle and native engine
(copies of the JAX package's), the device skew search, the connected-
components kernels (:mod:`.cc`, :mod:`.cc_kernel`) and the device raster
programs (:mod:`.raster_device`)."""

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
