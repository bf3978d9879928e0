"""Orchestration of the port: ``process()`` and ``to_JSON_dict``; the
raster and line segmentation (``preprocess``, which picks the raster
engine for every caller), assembly (``assemble``) and overlays
(``render``)."""

from .preprocess import (
    preprocess_images,
    identify_text_lines,
    LineStrip,
    PreprocParams,
)
from .process import process, to_JSON_dict
from .assemble import rotate_bbox

__all__ = [
    "preprocess_images",
    "identify_text_lines",
    "LineStrip",
    "PreprocParams",
    "process",
    "to_JSON_dict",
    "rotate_bbox",
]
