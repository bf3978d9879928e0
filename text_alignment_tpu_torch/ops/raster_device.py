"""The device raster: programs A, B and C on a torch device; the page never
comes back to the host.

Counterpart of ``text_alignment_tpu/ops/raster_device.py``:

- **Program A** (:func:`raster_program_a`): bit-packed binarized page in
  (the host keeps greyscale + Otsu + binarize + packbits) -> the cleanup
  chain (the ``cc_clean`` kernel: despeckle, white despeckle, tall-CC
  removal) -> the three-round skew search (:mod:`.skew_device`) ->
  rotation about the center into a **fixed worst-case canvas** with the
  content at the origin (the per-leaf exact canvas (H2, W2) and Q16
  coefficients ride in as constant tables indexed by the winners, so one
  program covers every reachable angle with no host round trip) -> erode
  (k = 2 run filters) -> row projection. One small wire comes back:
  ``[proj (H2max) | i1 i2 i3 | ok]``.
- **Program B** (:func:`masked_cc_table_impl`): separator rows (host peak
  logic) erased on the device-resident eroded page -> the ``cc_table``
  kernel -> the compact noise-filtered table.
- **Program C** (:func:`extract_strips_packed_impl`): line-strip crops cut
  from the device-resident binarized page straight into the recognizer's
  bit-packed ``(B, Hp+1, Wp//32)`` wire tensor (``models/recognizer.py``
  ``_pack_strips`` layout, byte for byte).

Every stage is bit-exact against the host oracle (the rotated max-canvas
page equals the exact-canvas page padded with white; run filters, row
projections and CC stats are padding-invariant). The ``ok`` flag of the CC
kernels (run-table or component-count overflow) gates a host fallback per
page — never silently wrong.

Bit words are unsigned 32-bit arithmetic on int32 storage: shifts and
masks run in int64 under ``& 0xFFFFFFFF`` and wrap back explicitly.

Reference semantics: textAlignPreprocessing.py:160-285 (preprocess_images
+ identify_text_lines); rotation padding contract alignToOCR.py:93-96.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..align.api import resolve_device
from . import cc
from . import fixedpoint as fxp
from . import skew_device as sd
from .cc import pack_bool, unpack_bits

_A23 = 19  # rounds 2/3 grid size (skew_device recipe)
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------

def pack_page(img) -> np.ndarray:
    """Host: bool/0-1 uint8 (H, W) page -> (H, ceil(W/32)) int32
    little-endian bit rows (np.packbits bitorder='little' + int32 view)."""
    img = np.asarray(img)
    H, W = img.shape
    Wq = -(-W // 32)
    bits = np.zeros((H, Wq * 4), np.uint8)
    bits[:, : (W + 7) // 8] = np.packbits(
        img.astype(bool), axis=1, bitorder="little")
    return bits.view(np.int32)


@functools.lru_cache(maxsize=None)
def leaf_tables(H: int, W: int, minangle: float = -6.0,
                maxangle: float = 6.0):
    """Per-leaf rotation constants for every angle reachable by the
    coarse-to-fine recipe: (cfix, sfix, H2, W2) int32 arrays of length
    A1*19*19, flat-indexed by (i1*19 + i2)*19 + i3, plus the worst-case
    canvas (H2max, W2max). All trig in float64 on host (fxp contract)."""
    c1 = fxp.angle_grid(minangle, maxangle, 1.0)
    angles = []
    for b1 in c1:
        for b2 in fxp.angle_grid(b1 - 0.9, b1 + 0.9, 0.1):
            angles.extend(fxp.angle_grid(b2 - 0.09, b2 + 0.09, 0.01))
    cf = np.empty(len(angles), np.int32)
    sf = np.empty(len(angles), np.int32)
    h2 = np.empty(len(angles), np.int32)
    w2 = np.empty(len(angles), np.int32)
    for i, a in enumerate(angles):
        cf[i], sf[i] = fxp.rotation_coeffs(a)
        h2[i], w2[i] = fxp.rotated_canvas(H, W, a)
    return (cf, sf, h2, w2), (int(h2.max()), int(w2.max()))


@functools.lru_cache(maxsize=None)
def _leaf_tables_on(device: torch.device, H: int, W: int, minangle: float,
                    maxangle: float):
    tables, canvas = leaf_tables(H, W, minangle, maxangle)
    return torch.from_numpy(np.stack(tables).astype(np.int64)).to(device), \
        canvas


def exact_canvas(H: int, W: int, angle: float) -> tuple[int, int]:
    """The exact rotated-canvas shape for a detected angle — what the
    host-raster path's ``image_bin.shape`` would be (rotate_bboxes needs
    it; the device page lives on the max canvas with content at origin)."""
    return fxp.rotated_canvas(H, W, angle)


# ---------------------------------------------------------------------------
# device programs
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


def _rotate_max_canvas(img, cfix, sfix, H2, W2, H2max: int, W2max: int):
    """Nearest-neighbor rotation via the shared Q16 inverse map
    (fxp.inverse_rotation_map's formula with device scalars, arithmetic
    shifts of negative values as in numpy), rendered into the fixed
    (H2max, W2max) canvas with the exact-canvas content at the origin and
    white beyond it."""
    H, W = img.shape
    dev = img.device
    x2 = torch.arange(W2max, device=dev)[None, :]
    y2 = torch.arange(H2max, device=dev)[:, None]
    dx2 = 2 * x2 - (W2 - 1)
    dy2 = 2 * y2 - (H2 - 1)
    sx2 = cfix * dx2 + sfix * dy2
    sy2 = -sfix * dx2 + cfix * dy2
    src_x = (sx2 + (W - 1) * fxp.SCALE + fxp.SCALE) >> (fxp.SCALE_BITS + 1)
    src_y = (sy2 + (H - 1) * fxp.SCALE + fxp.SCALE) >> (fxp.SCALE_BITS + 1)
    valid = ((src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
             & (y2 < H2) & (x2 < W2))
    sy = src_y.clamp(0, H - 1)
    sx = src_x.clamp(0, W - 1)
    return img.reshape(-1)[sy * W + sx] & valid


def raster_program_a(packed, H: int, W: int, despeckle_amt: int,
                     sat_area_thresh: int, minangle: float = -6.0,
                     maxangle: float = 6.0, max_runs: int = cc.MAX_RUNS,
                     sat_by_area: bool = False):
    """Program A on ``packed`` ((H, ceil(W/32)) int32 on a device):
    (bin_rot (H2max, W2max) bool, eroded (H2max, W2max) bool, wire
    (H2max + 4,) int32 ``[proj | i1 i2 i3 | ok]``), all on the device and
    queued without a host synchronisation."""
    cleaned, ok = cc.cc_clean(packed, H, W, despeckle_amt, sat_area_thresh,
                              sat_by_area, max_runs)
    img = unpack_bits(cleaned, W)
    idx = sd.search(img, minangle, maxangle)
    leaf = (idx[0] * _A23 + idx[1]) * _A23 + idx[2]
    tables, (H2max, W2max) = _leaf_tables_on(packed.device, H, W, minangle,
                                             maxangle)
    cfix, sfix, H2, W2 = tables.index_select(1, leaf.reshape(1))
    bin_rot = _rotate_max_canvas(img, cfix, sfix, H2, W2, H2max, W2max)
    eroded = filter_runs_impl(bin_rot, 2, "black", 0)
    eroded = filter_runs_impl(eroded, 2, "black", 1)
    proj = eroded.sum(dim=1)
    wire = torch.cat([proj, idx, ok.to(proj.dtype)]).to(torch.int32)
    return bin_rot, eroded, wire


def masked_cc_table_impl(eroded, row_mask, noise_thresh: int, max_ccs: int,
                         max_runs: int = cc.TABLE_MAX_RUNS):
    """Program B: separator-erased CC table of the eroded page
    (textAlignPreprocessing.py:217-235 semantics; the noise filter
    ``area > noise_thresh`` runs on device so the download shrinks).
    Returns the wire ``[count | ok | table.flat]`` ((2 + max_ccs*5,)
    int32)."""
    er = eroded & ~row_mask[:, None]
    H, W = er.shape
    table, ok = cc.cc_table(pack_bool(er), H, W, int(noise_thresh), max_ccs,
                            max_runs)
    return torch.cat([ok[1:], ok[:1], table.reshape(-1)])


def extract_strips_packed_impl(page_packed, bbox, Hp: int, Wp: int):
    """Program C: cut (B,) line strips from a bit-packed page into the
    recognizer's wire tensor.

    page_packed: (Hpage, ceil(Wpage/32)) int32 little-endian bit rows
    (``pack_bool`` / host ``pack_page`` layout). bbox: (B, 4) int32 rows
    (uly, ulx, h, w); zero-area rows produce blank strips. Output:
    (B, Hp + 1, Wp // 32) int32 — byte-identical to models/recognizer.py
    ``_pack_strips`` on the same crops (last row carries (h, w) in lanes
    0, 1)."""
    Hpage, Wq = page_packed.shape
    Wqs = Wp // 32
    dev = page_packed.device
    # padded so no window is clipped (the JAX program's dynamic_slice
    # clamps its start into the padded page: so do the min() below)
    pg = F.pad(page_packed, (0, Wqs + 1, 0, Hp)).to(torch.int64) & _U32
    bbox = bbox.to(torch.int64)
    uly = bbox[:, 0].clamp(min=0).clamp(max=Hpage)
    ulx = bbox[:, 1].clamp(min=0)
    s = (ulx & 31)[:, None, None]
    k0 = (ulx >> 5).clamp(max=Wq)
    rows = uly[:, None] + torch.arange(Hp, device=dev)
    cols = k0[:, None] + torch.arange(Wqs + 1, device=dev)
    win = pg[rows[:, :, None], cols[:, None, :]]          # (B, Hp, Wqs+1)
    lo = win[..., :Wqs] >> s
    hi = torch.where(s == 0, 0, (win[..., 1:] << ((32 - s) & 31)) & _U32)
    strips = lo | hi
    hs, ws = bbox[:, 2], bbox[:, 3]
    row_ok = torch.arange(Hp, device=dev)[None, :] < hs[:, None]
    keep = (ws[:, None] - 32 * torch.arange(Wqs, device=dev)[None, :]).clamp(
        0, 32)
    mask = torch.where(keep >= 32, _U32,
                       (torch.ones_like(keep) << (keep & 31)) - 1)
    strips = torch.where(row_ok[:, :, None], strips & mask[:, None, :], 0)
    strips = torch.where(strips >= 1 << 31, strips - (1 << 32), strips)
    meta = torch.zeros((bbox.shape[0], 1, Wqs), dtype=torch.int64,
                       device=dev)
    meta[:, 0, 0] = hs
    meta[:, 0, 1] = ws
    return torch.cat([strips, meta], dim=1).to(torch.int32)


def enabled() -> bool:
    """Whether the batched pipeline runs the raster on the device
    (TEXT_ALIGNMENT_TPU_RASTER=device|host; default host, as in the JAX
    package)."""
    return os.environ.get("TEXT_ALIGNMENT_TPU_RASTER", "host") == "device"


# ---------------------------------------------------------------------------
# synchronous single-page wrappers (tests / sequential callers)
# ---------------------------------------------------------------------------

def raster_page(bin_img, despeckle_amt: int, sat_area_thresh: int,
                minangle: float = -6.0, maxangle: float = 6.0,
                max_runs: int = cc.MAX_RUNS, sat_by_area: bool = False,
                device=None):
    """Run program A for one host binarized page on ``device`` (None: the
    card). Returns (bin_rot, eroded, proj np, angle float, ok bool,
    (H2, W2)); the two page tensors stay on the device (they feed programs
    B and C)."""
    bin_img = np.asarray(bin_img)
    H, W = bin_img.shape
    packed = torch.from_numpy(pack_page(bin_img)).to(resolve_device(device))
    bin_rot, eroded, wire = raster_program_a(
        packed, H, W, despeckle_amt, sat_area_thresh, minangle, maxangle,
        max_runs, sat_by_area)
    wire = wire.cpu().numpy()
    angle = sd.angle_from_indices(*wire[-4:-1].tolist(), minangle, maxangle)
    return (bin_rot, eroded, wire[:-4], angle, bool(wire[-1]),
            exact_canvas(H, W, angle))


def masked_cc_table(eroded_dev, sep_rows, H2: int, noise_thresh: int,
                    max_ccs: int = 4096, max_runs: int = cc.TABLE_MAX_RUNS):
    """Run program B: separator-masked noise-filtered CC table. sep_rows
    are the host's separator row indices (2-px each); H2 bounds the mask
    build. Returns (table np (count, 5) int64, ok)."""
    H2max = int(eroded_dev.shape[0])
    mask = np.zeros(H2max, bool)
    for idx in sep_rows:
        mask[idx: idx + 2] = True
    w = masked_cc_table_impl(
        eroded_dev, torch.from_numpy(mask).to(eroded_dev.device),
        noise_thresh, max_ccs, max_runs).cpu().numpy()
    count = int(w[0])
    return w[2:].reshape(max_ccs, 5)[:count].astype(np.int64), bool(w[1])


def extract_strips_packed(page_packed_dev, bboxes, Hp: int, Wp: int):
    """Run program C: (uly, ulx, h, w) rows -> recognizer packed_meta
    (device tensor). ``page_packed_dev``: (H, ceil(W/32)) int32 bit rows
    (``pack_bool`` / ``pack_page`` layout)."""
    bb = torch.from_numpy(np.asarray(bboxes, np.int32))
    return extract_strips_packed_impl(page_packed_dev,
                                      bb.to(page_packed_dev.device), Hp, Wp)
