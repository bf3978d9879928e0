"""Orchestration of the port: ``process()`` and ``to_JSON_dict``; the
raster and line segmentation (``preprocess``), the device raster stream
(``device_raster``), assembly (``assemble``) and overlays (``render``)."""

from .process import process, to_JSON_dict

__all__ = ["process", "to_JSON_dict"]
