"""The few names the benchmark takes from the program
(``text_alignment_tpu_torch``) beyond its entry points: its build timer.
Imported only once a run has found its card, or by a test."""

from __future__ import annotations


def build_seconds():
    """Seconds of the kernels' nvcc build in this process, or None where
    the library was already built."""
    from text_alignment_tpu_torch import _kernels

    return _kernels.build_seconds
