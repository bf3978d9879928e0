"""Utilities of the port: stage timing and the reference OCR-pickle loader."""

from .timing import stage_timer, StageTimer
