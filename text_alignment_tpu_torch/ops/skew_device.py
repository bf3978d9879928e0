"""The coarse-to-fine skew search on a torch device.

Counterpart of ``text_alignment_tpu/ops/skew_device.py`` (Gamera
``rotation_angle_projections`` semantics, reference
textAlignPreprocessing.py:183). Rounds 2 and 3 depend on the previous
round's winner, so every reachable candidate angle is precomputed on the
host in float64 as a Q16 tangent *decision tree* (:func:`_tan_tree`); the
device walks it with gathers and returns three winner indices, which
the host maps back to the float angle with the host search's own grid
arithmetic (:func:`angle_from_indices`). The whole search queues on the
device without a host synchronisation.

Exactness: the shifts are the shared Q16 integer formula
(``fixedpoint.shear_shifts``); each round's sheared row projections are
integer counts taken from the page's prefix sums along x (a column's shift
is monotone in x, so the columns of one shift are a contiguous range) and
realigned by a gather; the criterion (the sum of the squared derivative,
``oracle.criterion_from_projections``) is one int64 sum; the first maximum
wins. This is the JAX package's XLA search,
not a Pallas kernel, so it stays plain PyTorch. It runs inside the card
raster's chain (:func:`..pipeline.preprocess.preprocess_device_packed`,
:func:`.device.rotation_angle_projections`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import fixedpoint as fxp

_A23 = 19  # rounds 2/3 grid size: int(round(2*0.9/0.1)) + 1, fixed by recipe


def _qtan(angle_deg: float) -> int:
    """The Q16 tangent ``fxp.shear_shifts`` uses (host float64 + python
    round — the device never evaluates trig)."""
    return int(round(-math.tan(math.radians(angle_deg)) * fxp.SCALE))


@functools.lru_cache(maxsize=None)
def _tan_tree(minangle: float, maxangle: float):
    """(t1 (A1,), t2 (A1, 19), t3 (A1, 19, 19)) int32 Q16 tangents of every
    candidate angle reachable by the coarse-to-fine recipe (step 1.0 over
    [minangle, maxangle], then best +- 0.9 step 0.1, then best +- 0.09 step
    0.01 — oracle.rotation_angle_projections)."""
    c1 = fxp.angle_grid(minangle, maxangle, 1.0)
    a1 = len(c1)
    t1 = np.array([_qtan(a) for a in c1], np.int32)
    t2 = np.empty((a1, _A23), np.int32)
    t3 = np.empty((a1, _A23, _A23), np.int32)
    for i, b1 in enumerate(c1):
        c2 = fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1)
        assert len(c2) == _A23
        t2[i] = [_qtan(a) for a in c2]
        for j, b2 in enumerate(c2):
            c3 = fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01)
            assert len(c3) == _A23
            t3[i, j] = [_qtan(a) for a in c3]
    return t1, t2, t3


def angle_from_indices(i1: int, i2: int, i3: int,
                       minangle: float = -6.0,
                       maxangle: float = 6.0) -> float:
    """Map the device's per-round winner indices back to the float angle —
    the same float64 grid arithmetic as the host search, so the result is
    bit-identical to oracle/host_native.rotation_angle_projections."""
    c1 = fxp.angle_grid(minangle, maxangle, 1.0)
    b1 = c1[int(i1)]
    c2 = fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1)
    b2 = c2[int(i2)]
    c3 = fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01)
    return float(c3[int(i3)])


@functools.lru_cache(maxsize=None)
def _tree_on(device: torch.device, minangle: float, maxangle: float):
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device)
                 for t in _tan_tree(minangle, maxangle))


def _max_t(minangle: float, maxangle: float) -> int:
    return int(max(np.abs(t).max() for t in _tan_tree(minangle, maxangle)))


def _first_max(scores):
    """Index of the first maximum (sync-free)."""
    idx = torch.arange(scores.numel(), device=scores.device)
    return torch.where(scores == scores.max(), idx, scores.numel()).min()


def _projections(C, ts, span: int, pad: int):
    """Sheared row projections (A, H) int64 of every angle of ``ts``:
    proj[a, y] = sum_x img[y + shift_a[x], x] over rows inside the page.
    ``C`` (H, W + 1) int64 is the page's prefix sum along x. A column's
    shift is monotone in x, so the columns of one shift are a contiguous
    range, whose ink per row is a difference of two prefix sums; each
    shift's column sums are then realigned by a row gather. Integer
    arithmetic throughout: exact."""
    H, W = C.shape[0], C.shape[1] - 1
    dev = C.device
    A = ts.shape[0]
    x = torch.arange(W, device=dev)
    shift = (ts[:, None] * (x - W // 2)[None, :]
             + fxp.SCALE // 2) >> fxp.SCALE_BITS                   # (A, W)
    smin = shift.min(dim=1).values
    key = (shift - smin[:, None]
           + span * torch.arange(A, device=dev)[:, None]).reshape(-1)
    start = torch.full((A * span,), W, device=dev).scatter_reduce_(
        0, key, x.repeat(A), reduce="amin")
    count = torch.zeros(A * span, dtype=torch.int64, device=dev).scatter_add_(
        0, key, torch.ones_like(key))
    G = C[:, start + count] - C[:, start]        # (H, A*span) column sums
    Gp = torch.nn.functional.pad(G, (0, 0, pad, pad))
    v = torch.arange(span, device=dev)
    rows = (torch.arange(H, device=dev)[:, None]
            + (smin[:, None] + v[None, :]).reshape(1, A * span) + pad)
    return torch.gather(Gp, 0, rows).reshape(H, A, span).sum(dim=2).t()


def search(img, minangle: float = -6.0, maxangle: float = 6.0):
    """The three-round search on ``img`` ((H, W) bool or {0, 1} tensor) on
    its device: the winner indices (3,) int64, still on the device."""
    H, W = img.shape
    C = torch.nn.functional.pad(img.to(torch.int64).cumsum(dim=1), (1, 0))
    t1, t2, t3 = _tree_on(img.device, minangle, maxangle)
    max_t = _max_t(minangle, maxangle)
    span = (max_t * W >> fxp.SCALE_BITS) + 2   # shift spread within an angle
    pad = (max_t * W >> fxp.SCALE_BITS) + 2    # |shift| bound
    picks = []
    ts = t1
    for level in range(3):
        proj = _projections(C, ts, span, pad)
        d = proj[:, 1:] - proj[:, :-1]
        picks.append(_first_max((d * d).sum(dim=1)))
        # gathers with device indices: no host round trip between rounds
        if level == 0:
            ts = t2.index_select(0, picks[0].reshape(1))[0]
        elif level == 1:
            ts = t3.reshape(-1, _A23).index_select(
                0, (picks[0] * _A23 + picks[1]).reshape(1))[0]
    return torch.stack(picks)
