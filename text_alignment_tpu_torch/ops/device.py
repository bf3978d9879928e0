"""The all-device raster on a torch device: ``backend="device"``, and
``"hybrid"`` on a CUDA device, for every caller (the rule is
:func:`..pipeline.preprocess.raster_backend`). It is the port's one raster
on the card.

Counterpart of ``text_alignment_tpu/ops/device.py``, with its public names
and an explicit ``device`` on every function that takes a page (None: the
card, through :func:`..align.api.resolve_device`, which raises when there
is none). Pages are (H, W) bool tensors that stay on the device between
stages; only the histogram, the skew winners, the compact CC tables and
the final bit-packed pages come back to the host. Every function is
bit-identical to the JAX module and to the host oracle.

- **Connected components** run on the CUDA CC kernels of
  ``csrc/cc_filter.cu`` through :mod:`.cc` (on a CPU tensor, its exact
  plain versions): ``despeckle(k)`` keeps black components of area > k,
  ``remove_small_ccs(a)`` those of area > a - 1, ``despeckle_white`` fills
  white components of area <= k, ``remove_tall_ccs`` and
  ``remove_big_ccs`` drop black components of more than t rows or pixels,
  ``preproc_stage1`` is one three-pass cleanup chain, and the stats tables
  come from the table kernel. The run capacity is the most runs a page of
  that shape can hold, H * ceil(W / 2), so a kernel's ``ok`` of 0 is a
  fault and raises: there is no iteration budget and no host fallback.
  (The JAX module's label propagation stops after 192 rounds without a
  flag and splits a long serpentine component; these kernels do not.)
- **cc_label** (tests only) paints each black pixel with its component's
  smallest flat index, the start ``y * W + x0`` of the component's root
  run, from :func:`.cc.run_labels`; white pixels hold H * W.
- **Rotate + erode + project** of the packed page
  (:func:`rotate_erode_project_packed`): on a CUDA tensor at the
  pipeline's one k = 2 erosion, the kernel of ``csrc/raster.cu``
  (:mod:`.raster_kernel`), which keeps the page bit-packed from the
  cleanup chain's output to the eroded page and its row projection; its
  plain version (:func:`rotate_erode_project_reference`) is the torch chain
  below.
- **Everything else** is torch integer ops: the run filters are
  :func:`filter_runs_impl`, the rotation is the shared Q16 inverse map
  (:mod:`.fixedpoint`, :func:`_rotate`) onto the exact canvas
  ``fixedpoint.rotated_canvas``, and the skew search is
  :func:`.skew_device.search` (the squared-derivative criterion, which
  overflows int32, reduced in int64). :func:`shear_projections` keeps the
  JAX module's per-angle projections for parity.

Reference semantics: textAlignPreprocessing.py:160-285.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.api import resolve_device
from . import cc
from . import fixedpoint as fxp
from . import oracle
from . import raster_kernel
from . import skew_device as sd

MAX_CCS = 4096
# projections of at most this many gathered pixels at once (a 2000 x 1600
# page: five angles a chunk)
_SHEAR_CHUNK = 1 << 24


def on_device(x, device=None):
    """``x`` (array or tensor) as a tensor on ``device`` (None: the
    card); a tensor already there is returned as it is."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.asarray(x)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")  # torch refuses read-only arrays
    return torch.from_numpy(a).to(dev)


def _capacity(H: int, W: int) -> int:
    """The most runs of one polarity an H x W page can hold."""
    return H * ((W + 1) // 2)


def _raise_unless(ok, what: str) -> None:
    if not bool(ok[0]):
        raise RuntimeError(f"{what}: the CC kernel reported ok = 0 at a run "
                           "capacity no page of this shape can exceed")


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------

def cc_label(img, device=None):
    """8-connected labeling: int32 (H, W) where each black pixel holds its
    component's min flat index and white pixels hold H*W."""
    img = on_device(img, device)
    H, W = img.shape
    ry, x0, x1, root = cc.run_labels(cc.pack_bool(img), H, W)
    lengths = x1 - x0 + 1
    run = torch.repeat_interleave(torch.arange(ry.numel(),
                                               device=img.device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    offs = torch.arange(run.numel(), device=img.device) - first[run]
    out = torch.full((H * W,), H * W, dtype=torch.int32, device=img.device)
    out[ry[run] * W + x0[run] + offs] = (ry[root] * W + x0[root])[run].to(
        torch.int32)
    return out.reshape(H, W)


def _table(img, max_ccs: int):
    """The stats table of a bool page on its device: see
    :func:`_table_packed`."""
    H, W = img.shape
    return _table_packed(cc.pack_bool(img), H, W, max_ccs)


def _table_packed(packed, H: int, W: int, max_ccs: int):
    """The stats table of a bit-packed (H, ceil(W/32)) page on its device:
    ((max_ccs, 5) int32 rows (rmin, rmax, cmin, cmax, area) in scan order
    of roots, the true component count). Past ``max_ccs`` the table kernel
    reports max_ccs, so the count is taken again at a capacity of one row a
    run."""
    R = _capacity(H, W)
    table, ok = cc.cc_table(packed, H, W, -1, max_ccs, R)
    ok = ok.tolist()
    if not ok[0]:
        if ok[1] < max_ccs:  # the count fits: only a fault leaves ok = 0
            _raise_unless(ok, "cc_table")
        _, ok = cc.cc_table(packed, H, W, -1, R, R)
        ok = ok.tolist()
        _raise_unless(ok, "cc_table")
    return table, ok[1]


def cc_stats_compact(img, max_ccs: int = MAX_CCS, device=None):
    """Compact per-CC stats table, ordered by min flat index (the oracle's
    scan order). Returns (table int32 (max_ccs, 5) with columns (uly, lry,
    ulx, lrx, area), count); rows past ``count`` are zero. ``count`` is
    the true count, which may exceed ``max_ccs``."""
    return _table(on_device(img, device).to(torch.bool), max_ccs)


def _filter(img, thresh, mode: int, by_area: bool, device):
    img = on_device(img, device)
    H, W = img.shape
    out, ok = cc.cc_filter(cc.pack_bool(img), H, W, int(thresh), mode,
                           by_area, _capacity(H, W))
    _raise_unless(ok, "cc_filter")
    return cc.unpack_bits(out, W)


def despeckle(img, k, device=None):
    """Remove black CCs with area <= k (oracle.despeckle parity)."""
    return _filter(img, k, cc.MODE_BLACK, False, device)


def remove_small_ccs(img, min_area, device=None):
    """fill_white CCs with area < min_area."""
    return _filter(img, int(min_area) - 1, cc.MODE_BLACK, False, device)


def remove_tall_ccs(img, max_nrows, device=None):
    """fill_white CCs whose row count exceeds max_nrows (the reference's
    nrows-as-area quirk, textAlignPreprocessing.py:174-178)."""
    return _filter(img, max_nrows, cc.MODE_TALL, False, device)


def remove_big_ccs(img, max_area, device=None):
    """fill_white CCs whose true pixel AREA exceeds max_area (the
    strict=False corrected form of :func:`remove_tall_ccs`)."""
    return _filter(img, max_area, cc.MODE_TALL, True, device)


def despeckle_white(img, k, device=None):
    """Remove white CCs with area <= k (the reference's
    invert-despeckle-invert, textAlignPreprocessing.py:169-171)."""
    return _filter(img, k, cc.MODE_WHITE, False, device)


# ---------------------------------------------------------------------------
# run filters
# ---------------------------------------------------------------------------

def _run_length_map_axis0(img):
    """Length of the vertical run through each pixel, via last-white /
    next-white cumulative extrema."""
    H, W = img.shape
    idx = torch.arange(H, device=img.device)[:, None].expand(H, W)
    white = ~img
    lz = torch.cummax(torch.where(white, idx, -1), dim=0).values
    nz = torch.cummin(torch.where(white, idx, H).flip(0), dim=0).values
    return nz.flip(0) - lz - 1


def filter_runs_impl(img, k: int, color: str, axis: int):
    """Remove runs of ``color`` along ``axis`` shorter than k (axis 0:
    Gamera filter_short_runs, axis 1: filter_narrow_runs)."""
    target = img if color == "black" else ~img
    t = target if axis == 0 else target.t()
    keep = t & (_run_length_map_axis0(t) >= k)
    keep = keep if axis == 0 else keep.t()
    return keep if color == "black" else ~keep


def filter_runs(img, k, color="black", axis=0, device=None):
    """Remove runs of ``color`` along ``axis`` with length < k.
    axis=0 == Gamera filter_short_runs; axis=1 == filter_narrow_runs."""
    return filter_runs_impl(on_device(img, device), int(k), color, axis)


def filter_short_runs(img, k, color="black", device=None):
    return filter_runs(img, k, color=color, axis=0, device=device)


def filter_narrow_runs(img, k, color="black", device=None):
    return filter_runs(img, k, color=color, axis=1, device=device)


# ---------------------------------------------------------------------------
# binarization / projections / drawing
# ---------------------------------------------------------------------------

def grey_histogram(grey, device=None):
    grey = on_device(grey, device)
    return torch.bincount(grey.reshape(-1).to(torch.int64),
                          minlength=256).to(torch.int32)


def to_greyscale(rgb, device=None):
    """Integer luminance identical to oracle.to_greyscale."""
    if np.ndim(rgb) == 3 and rgb.shape[2] not in (3, 4):
        raise ValueError(
            f"expected RGB/RGBA/grey image, got {rgb.shape[2]} channels")
    rgb = on_device(rgb, device).to(torch.int32)
    if rgb.ndim == 2:
        return rgb.to(torch.uint8)
    if rgb.shape[2] == 4:
        a = rgb[..., 3:]
        rgb = (rgb[..., :3] * a + 255 * (255 - a) + 127) // 255
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return ((299 * r + 587 * g + 114 * b + 500) // 1000).to(torch.uint8)


_otsu_from_hist = oracle.otsu_from_hist


def to_onebit(img, device=None):
    """Greyscale + Otsu: the 256-bin histogram is reduced on the device,
    the float64 threshold criterion runs on the host."""
    grey = to_greyscale(img, device)
    t = _otsu_from_hist(grey_histogram(grey, grey.device).cpu().numpy())
    return grey <= t


def binarize(grey, thresh, device=None):
    return on_device(grey, device) <= int(thresh)


def projection_rows(img, device=None):
    return on_device(img, device).sum(dim=1, dtype=torch.int32)


def erase_rows(img, row_mask, device=None):
    """White-out the rows where row_mask (H,) is True (separator lines)."""
    return on_device(img, device) & ~on_device(row_mask, device)[:, None]


# ---------------------------------------------------------------------------
# bit packing (device -> host page transfers)
# ---------------------------------------------------------------------------

def pack_bool(img, device=None):
    """(H, W) bool -> (H, ceil(W/32)) int32 bitmask (little-endian
    bits)."""
    return cc.pack_bool(on_device(img, device))


def unpack_bool(packed: np.ndarray, W: int) -> np.ndarray:
    """Host-side inverse of pack_bool."""
    return cc.unpack_page(packed, np.shape(packed)[0], W)


def get_bool(img_dev) -> np.ndarray:
    """Download a device bool image via the packed path."""
    W = int(img_dev.shape[1])
    return unpack_bool(cc.pack_bool(img_dev).cpu().numpy(), W)


# ---------------------------------------------------------------------------
# fused preprocessing stages (pages stay on the device)
# ---------------------------------------------------------------------------

def preproc_stage1_packed(grey, thresh, despeckle_amt, sat_area_thresh,
                          sat_by_area: bool = False, device=None):
    """:func:`preproc_stage1` on the bit-packed page: (cleaned (H,
    ceil(W/32)) int32 page, ok (1,) int32), both on the device and queued
    without a host synchronisation (the caller checks ``ok``)."""
    img = binarize(grey, thresh, device)
    H, W = img.shape
    return cc.cc_clean(cc.pack_bool(img), H, W, int(despeckle_amt),
                       int(sat_area_thresh), sat_by_area, _capacity(H, W))


def preproc_stage1(grey, thresh, despeckle_amt, sat_area_thresh,
                   sat_by_area: bool = False, device=None):
    """binarize -> despeckle(black) -> despeckle(white) -> remove tall CCs
    (textAlignPreprocessing.py:166-178): one cleanup chain on the
    bit-packed page. ``sat_by_area=True`` = the strict=False corrected
    area filter."""
    out, ok = preproc_stage1_packed(grey, thresh, despeckle_amt,
                                    sat_area_thresh, sat_by_area, device)
    _raise_unless(ok, "cc_clean")
    return cc.unpack_bits(out, int(grey.shape[1]))


def rotate_erode_project_reference(packed, H: int, W: int, cfix, sfix, H2,
                                   W2, filter_runs: int = 1,
                                   filter_runs_amt: int = 2):
    """The plain version of :func:`rotate_erode_project_packed`: the
    rotation gather, the run-length erosion and the row sum in torch ops on
    the page's device."""
    rot = _rotate(cc.unpack_bits(packed, W), int(cfix), int(sfix), int(H2),
                  int(W2))
    eroded = rot
    for _ in range(filter_runs):
        eroded = filter_runs_impl(eroded, filter_runs_amt, "black", 0)
        eroded = filter_runs_impl(eroded, filter_runs_amt, "black", 1)
    proj = eroded.sum(dim=1, dtype=torch.int32)
    return cc.pack_bool(rot), cc.pack_bool(eroded), proj


def rotate_erode_project_packed(packed, H: int, W: int, cfix, sfix, H2, W2,
                                filter_runs: int = 1,
                                filter_runs_amt: int = 2):
    """rotate -> run-filter erosion -> row projection of the bit-packed
    (H, ceil(W/32)) int32 page ``packed`` onto the (H2, W2) canvas
    (textAlignPreprocessing.py:185-193, :211). Returns (packed binarized
    page, packed eroded page, projection (H2,) int32), all on the page's
    device. On a CUDA tensor one k = 2 erosion (the pipeline's) is the
    ``csrc/raster.cu`` kernel; any other erosion, and a CPU tensor, the
    plain version."""
    if packed.device.type == "cuda" and filter_runs == 1 \
            and filter_runs_amt == 2:
        return raster_kernel.rotate_erode_cuda(
            packed.contiguous(), H, W, int(cfix), int(sfix), int(H2),
            int(W2))
    return rotate_erode_project_reference(packed, H, W, cfix, sfix, H2, W2,
                                          filter_runs, filter_runs_amt)


def rotate_erode_project(img, cfix, sfix, H2, W2, filter_runs,
                         filter_runs_amt, device=None):
    """:func:`rotate_erode_project_packed` of the bool page ``img``.
    Returns (packed binarized page, packed eroded page, projection), all on
    the device."""
    img = on_device(img, device)
    H, W = int(img.shape[0]), int(img.shape[1])
    return rotate_erode_project_packed(cc.pack_bool(img), H, W, cfix, sfix,
                                       H2, W2, filter_runs, filter_runs_amt)


def erase_and_ccstats(eroded, row_mask, max_ccs: int = MAX_CCS,
                      device=None):
    """Separator erase + CC stats table: (table, true count)."""
    return _table(erase_rows(eroded, row_mask, device), max_ccs)


def erase_and_ccstats_packed(packed, W: int, row_mask,
                             max_ccs: int = MAX_CCS):
    """:func:`erase_and_ccstats` of a bit-packed (H, ceil(W/32)) page on
    its device: the separator rows are cleared on the words."""
    H = int(packed.shape[0])
    rows = on_device(np.flatnonzero(row_mask), packed.device)
    return _table_packed(packed.index_fill(0, rows, 0), H, W, max_ccs)


# ---------------------------------------------------------------------------
# skew detection + rotation
# ---------------------------------------------------------------------------

def shear_projections(img, shifts, device=None):
    """Row projections of the column-sheared image for each candidate
    angle. shifts: (A, W) int from fixedpoint.shear_shifts. Returns (A, H)
    int32; the (overflow-prone) squared-derivative criterion is reduced on
    the host."""
    img = on_device(img, device)
    H, W = img.shape
    shifts = on_device(np.asarray(shifts, np.int64), img.device)
    flat = img.reshape(-1)
    rows = torch.arange(H, device=img.device)[None, :, None]
    cols = torch.arange(W, device=img.device)[None, None, :]
    out = []
    step = max(1, _SHEAR_CHUNK // max(1, H * W))
    for a0 in range(0, shifts.shape[0], step):
        ys = rows + shifts[a0:a0 + step, None, :]
        valid = (ys >= 0) & (ys < H)
        g = flat[ys.clamp(0, H - 1) * W + cols] & valid
        out.append(g.sum(dim=2, dtype=torch.int32))
    return torch.cat(out)


criterion_from_projections = oracle.criterion_from_projections


def rotation_angle_projections(img, minangle=-6.0, maxangle=6.0,
                               device=None):
    """Coarse-to-fine skew estimate (same grid and criterion as the
    oracle): the three rounds of :func:`.skew_device.search`, queued on the
    page's device with one host read of the winners at the end."""
    idx = sd.search(on_device(img, device), minangle, maxangle).tolist()
    return sd.angle_from_indices(*idx, minangle, maxangle)


def _rotate(img, cfix, sfix, H2: int, W2: int):
    """Nearest-neighbor rotation onto the (H2, W2) canvas via the shared
    Q16 inverse map (fxp.inverse_rotation_map's formula, arithmetic shifts
    of negative values as in numpy), white where the source is outside the
    page."""
    H, W = img.shape
    dev = img.device
    x2 = torch.arange(W2, device=dev)[None, :]
    y2 = torch.arange(H2, device=dev)[:, None]
    dx2 = 2 * x2 - (W2 - 1)
    dy2 = 2 * y2 - (H2 - 1)
    sx2 = cfix * dx2 + sfix * dy2
    sy2 = -sfix * dx2 + cfix * dy2
    src_x = (sx2 + (W - 1) * fxp.SCALE + fxp.SCALE) >> (fxp.SCALE_BITS + 1)
    src_y = (sy2 + (H - 1) * fxp.SCALE + fxp.SCALE) >> (fxp.SCALE_BITS + 1)
    valid = (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
    sy = src_y.clamp(0, H - 1)
    sx = src_x.clamp(0, W - 1)
    return img.reshape(-1)[sy * W + sx] & valid


def rotate_onebit(img, angle_deg: float, device=None):
    """Rotate about the center onto an expanded white canvas;
    bit-identical to oracle.rotate_onebit."""
    img = on_device(img, device)
    H, W = int(img.shape[0]), int(img.shape[1])
    H2, W2 = fxp.rotated_canvas(H, W, angle_deg)
    cfix, sfix = fxp.rotation_coeffs(angle_deg)
    return _rotate(img, cfix, sfix, H2, W2)
