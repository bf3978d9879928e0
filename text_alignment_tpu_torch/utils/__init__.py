"""Utilities of the port: stage timing, the content-addressed stage cache
and the reference OCR-pickle loader."""

from .timing import stage_timer, StageTimer
