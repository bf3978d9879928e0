"""Page preprocessing and text-line segmentation.

Reference semantics: textAlignPreprocessing.py:160-285 (`preprocess_images`,
`identify_text_lines`), re-expressed over the framework's raster engines.
All engines produce identical pixels/strips:

- ``backend="host"``  — numpy oracle ops (the CPU baseline path);
- ``backend="hybrid"``— the native C++ raster engine (:mod:`..ops.
  host_native`, union-find CC / run filters) with numpy for the rest. The
  JAX package made it the production default because connected-component
  labelling at page shape is a compile-time pathology on remote-compile
  TPU runtimes; on a CUDA device, where the port has CC kernels,
  ``"hybrid"`` rasters with ``"device"`` instead (:func:`raster_backend`;
  bit-identical). A CPU device, or no device, keeps the native engine.
- ``backend="device"``— :mod:`..ops.device` on a torch device (the CC
  kernels of ``csrc/cc_filter.cu``, the rotate + erode + project kernel of
  ``csrc/raster.cu`` and torch ops); the page stays on the device, packed,
  from the cleanup chain to the line finder's CC table
  (:func:`preprocess_device_packed`, :class:`PackedPage`), with only the
  histogram, the skew winners, the row projection, the compact CC tables
  and the binarized page coming back to the host. Its functions take
  ``device`` (None: the card).

:func:`raster_backend` is the one place that picks the engine: every
function here applies it to the ``device`` it is given, so ``process()``,
``process_batch`` and the other callers pass their ``backend`` through.

Projection smoothing, peak prominence, and all per-CC list logic are
host-side float64/python on *all* paths (they are O(H) / O(#CCs)), so every
data-dependent decision (peaks, separators, strip bboxes) is bit-identical
across backends by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import oracle
from ..ops.projections import (
    moving_avg_filter,
    find_peak_locations,
    FILTER_SIZE,
)

# PARAMETERS (reference: textAlignPreprocessing.py:12-26; the unused
# saturation_thresh / cc_group_gap_min / max_distance_to_staff are dropped)
SAT_AREA_THRESH = 150       # CCs taller than this many rows are removed
# strict=False corrected-mode default: the reference's comment promises an
# AREA filter but 150 px of area would remove every glyph (area >= nrows
# always). The corrected default targets the same artifacts the row filter
# was tuned for — blobs as tall AND wide as its 150-row target.
SAT_AREA_THRESH_AREA = 150 * 150
DESPECKLE_AMT = 100
NOISE_AREA_THRESH = 100
COLLISION_STRIP_SCALE = 1
REMOVE_CAPITALS_SCALE = 10000


@dataclass
class PreprocParams:
    sat_area_thresh: int = SAT_AREA_THRESH
    despeckle_amt: int = DESPECKLE_AMT
    noise_area_thresh: int = NOISE_AREA_THRESH
    filter_size: int = FILTER_SIZE
    collision_strip_scale: float = COLLISION_STRIP_SCALE
    remove_capitals_scale: float = REMOVE_CAPITALS_SCALE
    # strict=False corrected mode: filter the stage-1 "saturated" CCs by
    # true pixel area instead of the reference's nrows-as-area quirk
    # (textAlignPreprocessing.py:174-178). NB the default threshold (150)
    # was tuned for the nrows semantics — area mode usually wants a much
    # larger sat_area_thresh.
    sat_filter_area: bool = False


@dataclass
class LineStrip:
    """A text-line crop of the binarized page. Coordinate contract matches
    the Gamera subimages the reference passes to OCR (alignToOCR.py:160-162):
    ``height`` is nrows - 1, so offset_y + height = the strip's last row."""

    img: np.ndarray  # bool (nrows, ncols)
    offset_x: int
    offset_y: int

    @property
    def height(self) -> int:
        return self.img.shape[0] - 1

    @property
    def width(self) -> int:
        return self.img.shape[1] - 1


@dataclass
class PackedPage:
    """The eroded page of the device raster, kept on its device for the
    line finder: ``words`` (H, ceil(width/32)) int32 little-endian bit rows
    (bit b of word k is column 32 k + b), and its row projection ``proj``
    (H,) on the host."""

    words: object  # torch.Tensor
    width: int
    proj: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return int(self.words.shape[0]), self.width


def raster_backend(backend: str, device=None) -> str:
    """The raster engine that runs ``backend`` on ``device``: on a CUDA
    device ``"hybrid"`` rasters on the card as ``"device"`` does
    (:mod:`..ops.device`, bit-identical to the native engine), by the rule
    that ``process()`` applies to the OCR stage's normalizer; on a CPU
    device, or with no device, it keeps the native engine. ``"host"`` and
    ``"device"`` are their own."""
    if backend == "hybrid" and device is not None:
        import torch

        if torch.device(device).type == "cuda":
            return "device"
    return backend


def rasters_on_card(backend: str, device) -> bool:
    """Whether ``backend`` rasters on a CUDA card when given ``device``."""
    if device is None:
        return False
    import torch

    return (torch.device(device).type == "cuda"
            and raster_backend(backend, device) == "device")


def _raster_engine(backend: str):
    """Host raster op namespace for the given backend: the native C++
    engine for ``hybrid`` (falling back to the oracle when no toolchain is
    present), the pure-numpy oracle otherwise."""
    if backend == "hybrid":
        from ..ops import host_native

        if host_native.available():
            return host_native
    return oracle


def vertically_coincide(hline_position, comp_offset, comp_nrows, collision,
                        collision_scale=COLLISION_STRIP_SCALE):
    """True if any part of the component lies within the strip around the
    line position (textAlignPreprocessing.py:38-56)."""
    collision *= collision_scale
    component_top = comp_offset
    component_bottom = comp_offset + comp_nrows
    strip_top = hline_position - int(collision / 2)
    strip_bottom = hline_position + int(collision / 2)
    both_above = component_top < strip_top and component_bottom < strip_top
    both_below = component_top > strip_bottom and component_bottom > strip_bottom
    return not both_above and not both_below


def preprocess_images(input_image, despeckle_amt: int = DESPECKLE_AMT,
                      filter_runs: int = 1, filter_runs_amt: int = 2,
                      correct_rotation: bool = True, backend: str = "host",
                      params: PreprocParams | None = None, device=None):
    """Binarize + denoise + deskew (textAlignPreprocessing.py:160-195).

    Returns (image_bin, image_eroded, angle) as numpy bool arrays.
    ``device``: the torch device of ``backend="device"`` (None: the card),
    which also decides the engine of ``"hybrid"`` (:func:`raster_backend`).
    """
    p = params or PreprocParams()
    input_image = np.asarray(input_image)
    backend = raster_backend(backend, device)

    if backend == "device":
        from ..ops import device as eng

        image_bin, eroded, angle = preprocess_device_packed(
            input_image, despeckle_amt, filter_runs, filter_runs_amt,
            correct_rotation, p, device)
        image_eroded = eng.unpack_bool(eroded.words.cpu().numpy(),
                                       eroded.width)
        return image_bin, image_eroded, angle

    eng = _raster_engine(backend)
    if hasattr(eng, "preprocess_page"):
        # native engine: the whole raster chain stays on uint8 buffers
        return eng.preprocess_page(input_image, despeckle_amt,
                                   p.sat_area_thresh, filter_runs,
                                   filter_runs_amt, correct_rotation,
                                   sat_area=p.sat_filter_area)
    img = eng.to_onebit(input_image)
    img = eng.despeckle(img, despeckle_amt)
    img = ~eng.despeckle(~img, despeckle_amt)
    if p.sat_filter_area:
        img = oracle.remove_big_ccs(img, p.sat_area_thresh)
    else:
        img = eng.remove_tall_ccs(img, p.sat_area_thresh)
    angle = eng.rotation_angle_projections(img, -6, 6)
    if correct_rotation:
        img = eng.rotate_onebit(img, angle)
    eroded = img.copy()
    for _ in range(filter_runs):
        eroded = eng.filter_short_runs(eroded, filter_runs_amt, "black")
        eroded = eng.filter_narrow_runs(eroded, filter_runs_amt, "black")
    return img, eroded, angle


def preprocess_device_packed(input_image, despeckle_amt: int = DESPECKLE_AMT,
                             filter_runs: int = 1, filter_runs_amt: int = 2,
                             correct_rotation: bool = True,
                             params: PreprocParams | None = None,
                             device=None):
    """:func:`preprocess_images` on ``backend="device"`` with the eroded
    page left on the device: (image_bin numpy, :class:`PackedPage`, angle).
    One queued chain on ``device`` (None: the card): greyscale and
    histogram, the cleanup chain, the skew search, then rotate + erode +
    project on the packed page (:func:`..ops.device.
    rotate_erode_project_packed`). The host reads the histogram (Otsu),
    the skew winners with the chain's ``ok``, and in one wait the
    binarized page, unpacked on the device, with the eroded page's row
    projection (into pinned memory from a card)."""
    import torch

    from ..ops import cc
    from ..ops import device as eng
    from ..ops import fixedpoint as fxp
    from ..ops import skew_device as sd

    p = params or PreprocParams()
    # stage 0: greyscale + histogram on the device; Otsu on the host
    grey = eng.to_greyscale(input_image, device)
    thresh = eng._otsu_from_hist(
        eng.grey_histogram(grey, grey.device).cpu().numpy())

    # stage 1: binarize + despeckle x2 + tall/big-CC removal, packed
    H, W = int(grey.shape[0]), int(grey.shape[1])
    cleaned, ok = eng.preproc_stage1_packed(
        grey, thresh, despeckle_amt, p.sat_area_thresh,
        sat_by_area=p.sat_filter_area, device=grey.device)
    # the skew winners and the chain's ok in one read
    idx = sd.search(cc.unpack_bits(cleaned, W), -6, 6)
    *idx, ok = torch.cat([idx, ok.to(idx.dtype)]).tolist()
    eng._raise_unless([ok], "cc_clean")
    angle = sd.angle_from_indices(*idx, -6, 6)

    if correct_rotation:
        H2, W2 = fxp.rotated_canvas(H, W, angle)
        cfix, sfix = fxp.rotation_coeffs(angle)
    else:
        H2, W2, cfix, sfix = H, W, fxp.SCALE, 0
    packed_bin, packed_eroded, proj = eng.rotate_erode_project_packed(
        cleaned, H, W, cfix, sfix, H2, W2, filter_runs, filter_runs_amt)
    # the binarized page leaves unpacked, into pinned memory: a host unpack
    # writes a fresh page-sized array a folio (page faults), while the
    # caching host allocator hands the same pinned blocks back folio after
    # folio
    bits = cc.unpack_bits(packed_bin, W2)
    if bits.is_cuda:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (bits, proj)]
        for h, t in zip(host, (bits, proj)):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(bits.device).synchronize()
    else:
        host = [bits, proj]
    image_bin, proj = (h.numpy() for h in host)
    return image_bin, PackedPage(packed_eroded, W2, proj), angle


def raster_page(input_image, backend: str = "host",
                despeckle_amt: int = DESPECKLE_AMT,
                params: PreprocParams | None = None, device=None):
    """:func:`preprocess_images` with the eroded page left where its
    engine keeps it, for :func:`identify_text_lines`: on the card
    (:func:`raster_backend` gives ``"device"``) a :class:`PackedPage` on
    ``device`` (:func:`preprocess_device_packed`), else a numpy page.
    Returns (image_bin numpy, eroded, angle)."""
    if raster_backend(backend, device) == "device":
        return preprocess_device_packed(input_image, despeckle_amt,
                                        params=params, device=device)
    return preprocess_images(input_image, despeckle_amt=despeckle_amt,
                             backend=backend, params=params, device=device)


def raster_stream(images, backend: str = "host",
                  despeckle_amt: int = DESPECKLE_AMT,
                  params: PreprocParams | None = None, device=None):
    """Yield the whole per-folio raster — ``(image_bin, angle, strips,
    peaks)`` — for a stream of pages: the batched pipeline's stage-1 loop
    (parallel/batch.py), on the engine :func:`raster_backend` picks for
    ``device``.

    On the card each page runs :func:`raster_page`, its eroded page staying
    packed on the device for the line finder. On the native engine
    (``"hybrid"`` on a CPU device) the page lives in the RUN domain end to
    end: stage 1 exports runs, rotation emits rotated runs alongside the
    pixel page, the erode + row projection + separator-masked CC stats all
    run on runs — the eroded pixel page is never materialized, saving ~3
    full-page passes on the one-core host. Results are bit-identical to
    preprocess_images + identify_text_lines on every engine (tested)."""
    p = params or PreprocParams()
    backend = raster_backend(backend, device)
    if backend == "hybrid":
        from ..ops import host_native as hn

        if hn.available():
            for raw in images:
                img, runs, n_runs = hn.preprocess_page_phase1(
                    np.asarray(raw), despeckle_amt, p.sat_area_thresh,
                    sat_area=p.sat_filter_area)
                angle = hn.rotation_angle_projections(
                    img, -6, 6, runs_n=(runs, n_runs))
                image_bin, eruns, en, proj = hn.preprocess_page_phase2_runs(
                    img, runs, n_runs, angle, correct_rotation=True)
                strips, peaks, _ = identify_text_lines_runs(
                    image_bin, eruns, en, proj, params=p, verbose=False)
                yield image_bin, float(angle), strips, peaks
            return
    for raw in images:
        image_bin, eroded, angle = raster_page(raw, backend, despeckle_amt,
                                               p, device)
        strips, peaks, _ = identify_text_lines(
            image_bin, eroded, backend=backend, params=p, verbose=False,
            device=device)
        yield image_bin, angle, strips, peaks


def _device_table(table, count) -> np.ndarray:
    """The first ``count`` rows of a device CC table as host int64; more
    components than the table holds raise, as in the JAX package."""
    if count > table.shape[0]:
        raise RuntimeError(
            f"page has {count} CCs > MAX_CCS={table.shape[0]}")
    return table[:count].cpu().numpy().astype(np.int64)


def _cc_table(img, backend, device=None):
    """(uly, lry, ulx, lrx, area) int rows for every CC, scan order."""
    if backend == "device":
        from ..ops import device as eng

        return _device_table(*eng.cc_stats_compact(img, device=device))
    eng = _raster_engine(backend)
    if eng is not oracle:
        return eng.cc_stats(np.asarray(img))
    _, table = oracle.cc_stats(np.asarray(img))
    return table


def identify_text_lines(image_bin, image_eroded, backend: str = "host",
                        params: PreprocParams | None = None,
                        verbose: bool = False, device=None):
    """Find text lines (textAlignPreprocessing.py:198-285).

    Returns (line_strips, peak_locations, smoothed_projection).
    ``device``: the torch device of ``backend="device"`` (None: the card),
    which also decides the engine of ``"hybrid"`` (:func:`raster_backend`).
    """
    p = params or PreprocParams()
    backend = raster_backend(backend, device)

    if isinstance(image_eroded, PackedPage):
        project = image_eroded.proj
    elif backend == "device":
        from ..ops import device as eng

        # one upload; a page already on the device stays where it is
        image_eroded = eng.on_device(image_eroded, device)
        project = eng.projection_rows(image_eroded,
                                      image_eroded.device).cpu().numpy()
    else:
        project = _raster_engine(backend).projection_rows(
            np.asarray(image_eroded)
        )

    def table_fn(sep_rows):
        return _sep_masked_cc_table(image_eroded, sep_rows, backend, device)

    return _lines_from_projection(image_bin, project, table_fn, p, verbose)


def identify_text_lines_runs(image_bin, eroded_runs, n_eruns, proj,
                             params: PreprocParams | None = None,
                             verbose: bool = False):
    """identify_text_lines over a run-encoded eroded page (native engine's
    fused phase-2 output, host_native.preprocess_page_phase2_runs): the
    row projection arrives precomputed and the separator-masked CC stats
    come straight off the run list, so the eroded pixel page never exists.
    Bit-identical results (tested)."""
    from ..ops import host_native as hn

    p = params or PreprocParams()
    H = len(proj)

    def table_fn(sep_rows):
        mask = np.zeros(H, dtype=bool)
        for idx in sep_rows:
            mask[idx : idx + 2] = True
        return hn.cc_stats_from_runs(eroded_runs, n_eruns, H, mask)

    return _lines_from_projection(image_bin, proj, table_fn, p, verbose)


def _sep_masked_cc_table(image_eroded, sep_rows, backend, device=None):
    """CC table of the eroded page with 2-px separator rows erased
    (textAlignPreprocessing.py:217-235), per backend."""
    if isinstance(image_eroded, PackedPage) or backend == "device":
        from ..ops import device as eng

        H = int(image_eroded.shape[0])
        mask = np.zeros(H, dtype=bool)
        for idx in sep_rows:
            mask[idx : idx + 2] = True
        if isinstance(image_eroded, PackedPage):
            return _device_table(*eng.erase_and_ccstats_packed(
                image_eroded.words, image_eroded.width, mask))
        return _device_table(*eng.erase_and_ccstats(
            image_eroded, mask, device=device))
    eng = _raster_engine(backend)
    if hasattr(eng, "cc_stats_masked"):
        # native path: masked rows are treated as white during run
        # extraction — no page copy at all
        H = int(np.asarray(image_eroded).shape[0])
        mask = np.zeros(H, dtype=bool)
        for idx in sep_rows:
            mask[idx : idx + 2] = True
        return eng.cc_stats_masked(np.asarray(image_eroded), mask)
    # one copy, then in-place separator erasure (draw_hline_white
    # copies the whole page per call — 10 lines would be 10 copies)
    eroded_cut = np.array(image_eroded, copy=True)
    for idx in sep_rows:
        eroded_cut[idx : idx + 2, :] = False
    return _cc_table(eroded_cut, backend)


def _peaks_and_separators(project, p: PreprocParams):
    """Peaks of the smoothed row projection + the 2-px separator rows at
    inter-peak minima (textAlignPreprocessing.py:211-224)."""
    smoothed_projection = moving_avg_filter(project, p.filter_size)
    peak_locations = find_peak_locations(smoothed_projection)
    sep_rows = []
    for i in range(len(peak_locations) - 1):
        start = peak_locations[i]
        end = peak_locations[i + 1]
        idx = int(np.argmin(smoothed_projection[start:end])) + start
        sep_rows.append(idx)
    return peak_locations, sep_rows, smoothed_projection


def _strip_bboxes_from_table(table, peak_locations, p: PreprocParams):
    """CC filtering + per-peak collision strips -> inclusive strip bboxes
    [(ulx, uly, lrx, lry)] (textAlignPreprocessing.py:229-257).

    Drops small CCs (strictly greater than the threshold survives —
    textAlignPreprocessing.py:235), then the (inert) capitals filter.
    Vectorized over the CC table; the arithmetic (incl. the truncating
    int() of the half-strip in vertically_coincide) matches the scalar
    reference logic value for value."""
    t = np.asarray(table).reshape(-1, 5)
    t = t[t[:, 4] > p.noise_area_thresh]
    if len(t) == 0:
        return []

    nrows_v = t[:, 1] - t[:, 0] + 1
    med_comp_height = np.median(nrows_v)
    keep = nrows_v < med_comp_height * p.remove_capitals_scale
    t = t[keep]
    nrows_v = nrows_v[keep]

    cc_median_height = np.median(nrows_v)
    # vertically_coincide's half-strip: int(collision/2) truncates toward 0
    half = int((cc_median_height * p.collision_strip_scale) / 2)

    comp_top = t[:, 0]
    comp_bottom = t[:, 0] + nrows_v
    bboxes = []
    for line_loc in peak_locations:
        strip_top = line_loc - half
        strip_bottom = line_loc + half
        both_above = (comp_top < strip_top) & (comp_bottom < strip_top)
        both_below = (comp_top > strip_bottom) & (comp_bottom > strip_bottom)
        res = t[~both_above & ~both_below]
        if len(res) == 0:
            # the reference would crash on min() of an empty list
            # (textAlignPreprocessing.py:251); we skip the empty line
            continue
        bboxes.append((int(res[:, 2].min()), int(res[:, 0].min()),
                       int(res[:, 3].max()), int(res[:, 1].max())))
    return bboxes


def _lines_from_projection(image_bin, project, table_fn, p: PreprocParams,
                           verbose: bool = False):
    """Shared tail of identify_text_lines: peaks from the (eroded-page)
    row projection, separator rows at inter-peak minima, then the CC
    filtering + per-peak collision strips (textAlignPreprocessing.py:
    198-285). ``table_fn(sep_rows)`` supplies the separator-masked CC
    table — pixel- or run-domain."""
    if verbose:
        print("finding projection peaks...")
    peak_locations, sep_rows, smoothed_projection = _peaks_and_separators(
        project, p)

    if verbose:
        print("connected component analysis...")

    table = table_fn(sep_rows)
    image_bin_np = np.asarray(image_bin)
    line_strips = []
    for ulx, uly, lrx, lry in _strip_bboxes_from_table(
            table, peak_locations, p):
        strip = oracle.subimage(image_bin_np, (ulx, uly), (lrx, lry))
        line_strips.append(LineStrip(strip, ulx, uly))

    return line_strips, peak_locations, smoothed_projection
