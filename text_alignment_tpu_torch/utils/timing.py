"""Per-stage timing and tracing — first-class observability the reference
lacked (SURVEY.md §5: bare prints only).

``span(name)`` is the port's one span primitive: while a ``torch.profiler``
records, a host range named ``name`` among the profiler's host events, on
the clock of its kernels and copies; otherwise a shared no-op. A running
profiler is the only switch. The range is a plain record function, not a
user annotation (``torch.profiler.record_function``), which the profiler
would also copy onto the device track as a ``gpu_user_annotation`` event.
The profiler keeps the ranges in memory and hands them out when it stops;
a span's parent is the span that encloses it on the same thread.

``StageTimer`` opens a ``ta.stage.<name>`` span for every stage and, when
enabled, keeps per-stage totals on ``perf_counter`` (the CLI's
``--timing``).

The port's counterpart of ``text_alignment_tpu/utils/timing.py``, whose
JAX device barrier and JAX profiler trace the span replaces; the XLA
compile log has no counterpart (PyTorch runs eagerly and compiles
nothing).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast as _range

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager: a host range named ``name`` while a profiler
    records, else a shared no-op (one check, nothing allocated)."""
    if not _recording():
        return _OFF
    return _range(name)


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span("ta.stage." + name):
            if not self.enabled:
                yield
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for k in self.totals:
            lines.append(
                f"{k:>16s}: {self.totals[k]*1e3:9.2f} ms  x{self.counts[k]}"
            )
        return "\n".join(lines)


def stage_timer(enabled: bool = True) -> StageTimer:
    return StageTimer(enabled=enabled)
