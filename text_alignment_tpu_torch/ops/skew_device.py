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
not a Pallas kernel, so it stays plain PyTorch.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from ..align.api import resolve_device
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


def enabled(device=None) -> bool:
    """Whether the pipelined batched raster should use the device skew
    path (TEXT_ALIGNMENT_TPU_SKEW=host|device|auto): auto means a CUDA
    device (``device``'s type when given, else whether a card is
    present); on the CPU the search is correct but slower than the native
    host engine, so only tests force it there."""
    mode = os.environ.get("TEXT_ALIGNMENT_TPU_SKEW", "auto")
    if mode == "host":
        return False
    if mode == "device":
        return True
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()


def dispatch(img_u8: np.ndarray, minangle: float = -6.0,
             maxangle: float = 6.0, device=None):
    """Upload one 0/1 uint8 page and queue the full skew search on
    ``device`` (None: the card). Returns an opaque handle; redeem with
    :func:`collect`."""
    page = torch.from_numpy(np.ascontiguousarray(img_u8, np.uint8))
    return (PendingCopy(search(page.to(resolve_device(device)), minangle,
                               maxangle)), (minangle, maxangle))


def collect(handle) -> float:
    """Block on a :func:`dispatch` handle and return the detected angle
    (bit-identical to the host search's float)."""
    pending, (mn, mx) = handle
    i1, i2, i3 = pending.get().tolist()
    return angle_from_indices(i1, i2, i3, mn, mx)


def rotation_angle_projections(img, minangle: float = -6.0,
                               maxangle: float = 6.0, device=None) -> float:
    """Synchronous convenience wrapper (oracle signature)."""
    return collect(dispatch(np.asarray(img), minangle, maxangle, device))


class PendingCopy:
    """A small device result copied to the host without blocking the
    caller: a ``non_blocking`` copy into pinned memory, redeemed by
    :meth:`get`, which waits for that copy alone. CPU tensors are taken as
    they are."""

    __slots__ = ("_host", "_event")

    def __init__(self, t):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class GroupedSkewWorker:
    """Queued skew searches for the stage-major batched raster.

    The JAX package's worker groups pages into one transfer and pulls the
    winners on a collector thread to amortise a remote tunnel's latency.
    On a local card each page is one upload and one queued search whose
    three winner indices come back by a ``non_blocking`` copy into pinned
    memory, so the search of page i overlaps the host raster of the pages
    after it. Protocol as the JAX package's: ``put(img)`` or
    ``put_runs(...)`` per page (returns a slot id), ``finish()`` after the
    last put (idempotent), then ``angle(slot)`` per page (waits for that
    page's copy)."""

    def __init__(self, minangle: float = -6.0, maxangle: float = 6.0,
                 device=None):
        self._mn, self._mx = minangle, maxangle
        self._device = resolve_device(device)
        self._pending: dict = {}
        self._n = 0

    def _submit(self, bits8: np.ndarray, H: int, W: int) -> int:
        from .cc import unpack_bits

        packed = torch.from_numpy(bits8.view(np.int32)).to(self._device)
        slot = self._n
        self._n += 1
        self._pending[slot] = PendingCopy(search(unpack_bits(packed, W)[:H],
                                              self._mn, self._mx))
        return slot

    def put(self, img_u8: np.ndarray) -> int:
        H, W = img_u8.shape
        bits8 = np.zeros((H, -(-W // 32) * 4), np.uint8)
        bits8[:, : (W + 7) // 8] = np.packbits(img_u8, axis=1,
                                               bitorder="little")
        return self._submit(bits8, H, W)

    def put_runs(self, runs: np.ndarray, n: int, H: int, W: int) -> int:
        """put() without the page re-read: OR the phase-1 run list's ink
        bits straight into a zeroed buffer (native engine only)."""
        from . import host_native as hn

        bits8 = np.zeros((H, -(-W // 32) * 4), np.uint8)
        hn.pack_runs_into(runs, n, bits8)
        return self._submit(bits8, H, W)

    def finish(self):
        pass

    def angle(self, slot: int) -> float:
        i1, i2, i3 = self._pending.pop(slot).get().tolist()
        return angle_from_indices(i1, i2, i3, self._mn, self._mx)
