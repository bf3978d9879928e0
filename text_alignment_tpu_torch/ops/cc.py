"""Scan-line connected components over a bit-packed page: the CC filter
(despeckle, despeckle_white, remove_tall_ccs), the three-pass cleanup chain
and the separator-masked CC stats table.

Counterpart of ``text_alignment_tpu/ops/cc_pallas.py``, with its public
surface and capacities (``MAX_RUNS``, ``TABLE_MAX_RUNS``), so that the
``ok`` flags agree with the JAX package's at the same capacity. Every
function takes the page as (H, Wq) int32 little-endian bit rows (bit b of
word k is column 32 k + b) on a torch device: on a CUDA tensor it launches
the hand-written kernels of ``csrc/cc_filter.cu`` (:mod:`.cc_kernel`), on a
CPU tensor it runs the plain PyTorch version below.

Semantics (the Pallas kernel's, bit for bit):

- runs are the maximal horizontal runs of the working polarity (black, or
  white for despeckle_white) inside the page (columns < W, rows < H),
  numbered in scan order (row, then column);
- two runs of adjacent rows are connected when their column spans,
  widened by one, overlap (8-connectivity); a component's root is its
  smallest run index, so components come in scan order of their roots;
- at most ``max_runs`` runs are kept: past that ``ok`` is 0 and the
  components are those of the first ``max_runs`` runs (the caller then
  takes its host fallback);
- the filter keeps a black component whose area is > t (BLACK), paints a
  white one whose area is <= t and ORs the result with the input (WHITE),
  or keeps a black one whose measure is <= t, the measure being its row
  count (the reference's nrows-as-area quirk) or its area with
  ``by_area`` (TALL);
- the table lists (rmin, rmax, cmin, cmax, area) of every component whose
  area is > thresh, in scan order of roots, at most ``max_ccs`` rows; a
  larger count sets ``ok`` to 0.

The plain version takes the runs from the packed page and runs min-label
propagation with pointer jumping over run adjacency until a fixpoint:
exact, with no iteration budget.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..align.api import resolve_device
from . import cc_kernel

# the JAX package's capacities (ops/cc_pallas.py): runs of one filter pass
# and of the table kernel
MAX_RUNS = 45056
TABLE_MAX_RUNS = 30720

MODE_BLACK = 0   # remove black CCs with area <= thresh (despeckle)
MODE_WHITE = 1   # fill white CCs with area <= thresh (despeckle_white)
MODE_TALL = 2    # remove black CCs with measure > thresh


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_page(img: np.ndarray) -> np.ndarray:
    """bool (H, W) -> (H, ceil(W/32)) int32, bit b = column 32k + b."""
    H, W = img.shape
    Wq = -(-W // 32)
    padded = np.zeros((H, Wq * 32), np.uint8)
    padded[:, :W] = img
    u = np.packbits(padded.reshape(H, Wq, 4, 8), axis=-1,
                    bitorder="little")
    return u.reshape(H, Wq * 4).view(np.uint32).astype(np.int32).reshape(
        H, Wq)


def unpack_page(packed: np.ndarray, H: int, W: int) -> np.ndarray:
    u = np.ascontiguousarray(
        np.asarray(packed).astype(np.uint32)).view(np.uint8)
    bits = np.unpackbits(u.reshape(H, -1), axis=1, bitorder="little")
    return bits[:H, :W] != 0


def pack_bool(img, words: int | None = None):
    """(..., W) bool tensor -> (..., words) int32 little-endian bit words
    (``words`` defaults to ceil(W/32)). The words are summed in int64 and
    wrapped to int32 explicitly: bit 31 is the sign bit."""
    W = img.shape[-1]
    Wq = -(-W // 32) if words is None else words
    x = F.pad(img.to(torch.int64), (0, Wq * 32 - W))
    x = x.reshape(*img.shape[:-1], Wq, 32)
    w = (x << torch.arange(32, device=img.device)).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_bits(packed, W: int):
    """(..., Wq) int32 bit words -> (..., W) bool tensor."""
    u = packed.to(torch.int64) & 0xFFFFFFFF
    bits = (u[..., None] >> torch.arange(32, device=packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :W] != 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _runs(page, H: int, W: int, white: bool, R: int):
    """Runs of the working polarity in scan order, cut to the first R:
    (ry, x0, x1) int64 tensors, and the total run count n."""
    bits = unpack_bits(page[:H], W)
    if white:
        bits = ~bits
    z = torch.zeros((H, 1), dtype=torch.bool, device=page.device)
    starts = bits & ~torch.cat([z, bits[:, :-1]], dim=1)
    ends = bits & ~torch.cat([bits[:, 1:], z], dim=1)
    ry, x0 = starts.nonzero(as_tuple=True)  # row-major: scan order
    _, x1 = ends.nonzero(as_tuple=True)
    n = int(ry.numel())
    return ry[:R], x0[:R], x1[:R], n


def _labels(ry, x0, x1, W: int):
    """Each run's component root, the smallest run index of its
    component: min-label propagation over the 8-connected run adjacency
    of adjacent rows, with pointer jumping, to a fixpoint."""
    n = ry.numel()
    dev = ry.device
    label = torch.arange(n, device=dev)
    if n == 0:
        return label
    stride = W + 2  # keys of distinct rows never collide
    key_end = ry * stride + x1
    key_start = ry * stride + x0
    # previous-row runs j overlapping [x0 - 1, x1 + 1]: x1_j >= x0 - 1 and
    # x0_j <= x1 + 1, a contiguous range of the scan order
    lo = torch.searchsorted(key_end, (ry - 1) * stride + x0 - 1)
    hi = torch.searchsorted(key_start, (ry - 1) * stride + x1 + 1,
                            right=True)
    cnt = (hi - lo).clamp(min=0)
    src = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    dst = lo[src] + torch.arange(src.numel(), device=dev) - first[src]
    if src.numel() == 0:
        return label
    while True:
        m = torch.minimum(label[src], label[dst])
        new = label.clone()
        for idx in (src, dst, label[src], label[dst]):
            new.scatter_reduce_(0, idx, m, reduce="amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            return label
        label = new


def run_labels(page, H: int, W: int):
    """Every black run of the page and its component's root, plain
    PyTorch on the page's device: (ry, x0, x1, root) int64 tensors in scan
    order, ``root`` the smallest run index of the run's component."""
    ry, x0, x1, _ = _runs(page, H, W, False, H * W)
    return ry, x0, x1, _labels(ry, x0, x1, W)


def _component_stats(ry, x0, x1, label, want_x: bool):
    n = ry.numel()
    dev = ry.device
    big = torch.iinfo(torch.int64).max
    area = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(
        0, label, x1 - x0 + 1)
    ymin = torch.full((n,), big, device=dev).scatter_reduce_(
        0, label, ry, reduce="amin")
    ymax = torch.full((n,), -1, device=dev).scatter_reduce_(
        0, label, ry, reduce="amax")
    if not want_x:
        return area, ymin, ymax, None, None
    xmin = torch.full((n,), big, device=dev).scatter_reduce_(
        0, label, x0, reduce="amin")
    xmax = torch.full((n,), -1, device=dev).scatter_reduce_(
        0, label, x1, reduce="amax")
    return area, ymin, ymax, xmin, xmax


def _ok(n: int, R: int, device):
    return torch.tensor([int(n <= R), n], dtype=torch.int32, device=device)


def filter_reference(page, H: int, W: int, thresh: int, mode: int,
                     by_area: bool, max_runs: int):
    """One filter pass, plain PyTorch: (H, Wq) int32 page -> (painted page
    (H, Wq) int32, ok (2,) int32 [n <= max_runs, n])."""
    Wq = page.shape[1]
    ry, x0, x1, n = _runs(page, H, W, mode == MODE_WHITE, max_runs)
    label = _labels(ry, x0, x1, W)
    area, ymin, ymax, _, _ = _component_stats(ry, x0, x1, label, False)
    a = area[label]
    if mode == MODE_BLACK:
        keep = a > thresh
    elif mode == MODE_WHITE:
        keep = a <= thresh
    else:
        meas = a if by_area else ymax[label] - ymin[label] + 1
        keep = meas <= thresh
    diff = torch.zeros((H, Wq * 32 + 1), dtype=torch.int32,
                       device=page.device)
    one = torch.ones_like(ry[keep], dtype=torch.int32)
    diff.index_put_((ry[keep], x0[keep]), one, accumulate=True)
    diff.index_put_((ry[keep], x1[keep] + 1), -one, accumulate=True)
    out = pack_bool(torch.cumsum(diff, 1)[:, :Wq * 32] > 0, Wq)
    if mode == MODE_WHITE:
        out = out | page
    return out, _ok(n, max_runs, page.device)


def table_reference(page, H: int, W: int, thresh: int, max_ccs: int,
                    max_runs: int):
    """The CC stats table, plain PyTorch: (max_ccs, 5) int32 rows
    (rmin, rmax, cmin, cmax, area) of the components with area > thresh in
    scan order of roots (zero rows after them), and ok (2,) int32
    [run and count capacity held, min(count, max_ccs)]."""
    ry, x0, x1, n = _runs(page, H, W, False, max_runs)
    label = _labels(ry, x0, x1, W)
    area, ymin, ymax, xmin, xmax = _component_stats(ry, x0, x1, label, True)
    roots = torch.arange(ry.numel(), device=page.device)
    roots = roots[(label == roots) & (area > thresh)]
    count = int(roots.numel())
    rows = torch.stack([ymin[roots], ymax[roots], xmin[roots], xmax[roots],
                        area[roots]], dim=1)[:max_ccs]
    table = torch.zeros((max_ccs, 5), dtype=torch.int32, device=page.device)
    table[:rows.shape[0]] = rows.to(torch.int32)
    ok = torch.tensor([int(n <= max_runs and count <= max_ccs),
                       min(count, max_ccs)], dtype=torch.int32,
                      device=page.device)
    return table, ok


def clean_reference(page, H: int, W: int, despeckle_amt: int,
                    sat_area_thresh: int, by_area: bool, max_runs: int):
    """The three-pass cleanup chain, plain PyTorch: despeckle ->
    despeckle_white (ORed with its input) -> remove_tall; ok (1,) int32 is
    the AND of the three passes' ok."""
    p1, ok1 = filter_reference(page, H, W, despeckle_amt, MODE_BLACK, False,
                               max_runs)
    p2, ok2 = filter_reference(p1, H, W, despeckle_amt, MODE_WHITE, False,
                               max_runs)
    p3, ok3 = filter_reference(p2, H, W, sat_area_thresh, MODE_TALL,
                               by_area, max_runs)
    return p3, (ok1[:1] & ok2[:1] & ok3[:1])


# ---------------------------------------------------------------------------
# dispatch: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

def _check(what, page, H: int, W: int):
    if page.dim() != 2 or page.dtype != torch.int32:
        raise ValueError(f"{what}: page must be a 2-D int32 tensor, got "
                         f"{page.dtype} {tuple(page.shape)}")
    Hq, Wq = page.shape
    if Hq != H or not 0 < W <= Wq * 32 or W >= 1 << 15 or H < 1:
        raise ValueError(f"{what}: page {tuple(page.shape)} does not hold "
                         f"an H={H} x W={W} page (W < 2^15)")
    kind = page.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no version for device {page.device}")
    return kind == "cuda"


def cc_filter(page, H: int, W: int, thresh: int, mode: int,
              by_area: bool = False, max_runs: int = MAX_RUNS):
    """One CC filter pass: (painted page, ok (2,) int32)."""
    if _check("cc_filter", page, H, W):
        return cc_kernel.filter_cuda(page.contiguous(), H, W, thresh, mode,
                                     by_area, max_runs)
    return filter_reference(page, H, W, thresh, mode, by_area, max_runs)


def cc_table(page, H: int, W: int, thresh: int, max_ccs: int,
             max_runs: int = TABLE_MAX_RUNS):
    """The CC stats table: ((max_ccs, 5) int32, ok (2,) int32)."""
    if _check("cc_table", page, H, W):
        return cc_kernel.table_cuda(page.contiguous(), H, W, thresh, max_ccs,
                                    max_runs)
    return table_reference(page, H, W, thresh, max_ccs, max_runs)


def cc_clean(page, H: int, W: int, despeckle_amt: int, sat_area_thresh: int,
             by_area: bool = False, max_runs: int = MAX_RUNS):
    """The cleanup chain: (page, ok (1,) int32)."""
    if _check("cc_clean", page, H, W):
        return cc_kernel.clean_cuda(page.contiguous(), H, W, despeckle_amt,
                                    sat_area_thresh, by_area, max_runs)
    return clean_reference(page, H, W, despeckle_amt, sat_area_thresh,
                           by_area, max_runs)


# ---------------------------------------------------------------------------
# the JAX module's surface
# ---------------------------------------------------------------------------

def _run_filter(page_packed, H: int, W: int, thresh, mode: int,
                by_area: bool = False, max_runs: int = MAX_RUNS):
    """Packed (H, Wq) int32 page on a device -> (filtered packed page,
    ok bool tensor, n_runs int tensor)."""
    out, ok = cc_filter(page_packed, H, W, int(thresh), mode, by_area,
                        max_runs)
    return out, ok[0] == 1, ok[1]


def _upload(img, device):
    """A host bool page packed onto ``device`` (None: the card)."""
    return torch.from_numpy(pack_page(np.asarray(img))).to(
        resolve_device(device))


def _filter_host(img, k, mode, by_area, max_runs, device):
    H, W = img.shape
    out, ok, _ = _run_filter(_upload(img, device), H, W, k, mode, by_area,
                             max_runs)
    return unpack_page(out.cpu().numpy(), H, W), bool(ok)


def despeckle(img, k, max_runs: int = MAX_RUNS, device=None):
    """Remove black CCs with area <= k. Returns (page bool, ok)."""
    return _filter_host(img, k, MODE_BLACK, False, max_runs, device)


def despeckle_white(img, k, max_runs: int = MAX_RUNS, device=None):
    return _filter_host(img, k, MODE_WHITE, False, max_runs, device)


def remove_tall_ccs(img, max_nrows, max_runs: int = MAX_RUNS,
                    by_area: bool = False, device=None):
    return _filter_host(img, max_nrows, MODE_TALL, by_area, max_runs, device)


def preproc_clean_packed(page_packed, H: int, W: int, despeckle_amt,
                         sat_area_thresh, sat_by_area: bool = False,
                         max_runs: int = MAX_RUNS):
    """The three-pass cleanup chain (textAlignPreprocessing.py:166-178) on
    a device-resident packed page. Returns (packed page, ok bool
    tensor)."""
    out, ok = cc_clean(page_packed, H, W, int(despeckle_amt),
                       int(sat_area_thresh), sat_by_area, max_runs)
    return out, ok[0] == 1


def preproc_clean(img, despeckle_amt, sat_area_thresh,
                  sat_by_area: bool = False, max_runs: int = MAX_RUNS,
                  device=None):
    """Host-convenience form of :func:`preproc_clean_packed`."""
    H, W = img.shape
    out, ok = preproc_clean_packed(_upload(img, device), H, W, despeckle_amt,
                                   sat_area_thresh, sat_by_area, max_runs)
    return unpack_page(out.cpu().numpy(), H, W), bool(ok)


def cc_table_packed(page_packed, H: int, W: int, min_area_keep=None,
                    max_ccs: int = 2048, max_runs: int = TABLE_MAX_RUNS):
    """Program-B stats table from a device-resident packed page (already
    separator-masked by the caller): (table (max_ccs, 5) int32 rows
    (rmin, rmax, cmin, cmax, area) in scan order, count, ok bool tensor)
    (textAlignPreprocessing.py:217-235). ok is False on run-table or
    component-count overflow."""
    thresh = -1 if min_area_keep is None else int(min_area_keep)
    table, ok = cc_table(page_packed, H, W, thresh, max_ccs, max_runs)
    return table, ok[1], ok[0] == 1


def cc_table_compact(img, min_area_keep=None, max_ccs: int = 2048,
                     max_runs: int = TABLE_MAX_RUNS, device=None):
    """Host-convenience form of :func:`cc_table_packed` (bool page in)."""
    H, W = img.shape
    return cc_table_packed(_upload(img, device), H, W, min_area_keep,
                           max_ccs, max_runs)
