"""Per-stage timing/tracing — first-class observability the reference lacked
(SURVEY.md §5: bare prints only). Wraps stages in context managers and can
emit a torch profiler trace for the card's work.

The port's copy of ``text_alignment_tpu/utils/timing.py``: the JAX device
barrier becomes ``torch.cuda.synchronize`` and the JAX profiler trace
``torch.profiler``; the JAX package's XLA compile log has no counterpart
(PyTorch runs eagerly and compiles nothing).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


def _sync_cuda() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimer:
    def __init__(self, enabled: bool = True, sync_cuda: bool = False):
        self.enabled = enabled
        self.sync_cuda = sync_cuda
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_cuda:
                _sync_cuda()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for k in self.totals:
            lines.append(
                f"{k:>16s}: {self.totals[k]*1e3:9.2f} ms  x{self.counts[k]}"
            )
        return "\n".join(lines)


def stage_timer(enabled: bool = True, sync_cuda: bool = False) -> StageTimer:
    return StageTimer(enabled=enabled, sync_cuda=sync_cuda)


@contextlib.contextmanager
def torch_profile_trace(path: str):
    """Capture a torch profiler trace of the host and the card (a Chrome
    trace JSON at ``path``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    _sync_cuda()
    prof.export_chrome_trace(path)
