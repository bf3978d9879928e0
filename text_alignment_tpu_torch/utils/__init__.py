"""Utilities of the port: stage timing and profiler spans, the
content-addressed stage cache and the reference OCR-pickle loader."""

from .timing import stage_timer, StageTimer
