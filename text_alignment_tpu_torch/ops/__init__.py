"""Raster operations of the port: the host oracle and native engine
(copies of the JAX package's), the device skew search, the connected-
components kernels (:mod:`.cc`, :mod:`.cc_kernel`) and the device raster
programs (:mod:`.raster_device`)."""
