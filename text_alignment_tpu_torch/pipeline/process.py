"""End-to-end page alignment on one torch device: ``process()``.

Counterpart of ``text_alignment_tpu/pipeline/process.py``, with the same
arguments and return contract plus ``device``: given a text layer image and
a transcript, returns ``(syl_boxes, image, lines_peak_locs, all_chars)``
(or None when OCR yields nothing alignable); ``to_JSON_dict`` serializes
the canonical output, including the reference's 75th-percentile-as-"median"
line spacing quirk.

Stages:
- raster and line segmentation: :mod:`.preprocess`, the port's copy of the
  JAX package's code, which picks the engine from ``backend`` and
  ``device`` (:func:`.preprocess.raster_backend`): the numpy oracle on
  "host", and on "device", or "hybrid" on a CUDA card, :mod:`..ops.device`
  on ``device`` (the CC kernels, the rotate + erode + project kernel and
  torch ops), the eroded page staying packed on the device for the line
  finder; "hybrid" on a CPU device takes the native C++ engine (the pages
  are bit-identical). A ``ta.raster.card`` span marks a folio rastered on
  the card;
- OCR: the port's :class:`..models.recognizer.SeqRecognizer` on ``device``,
  normalizing lines on the device when that device is a CUDA card;
- NW alignment: the port's ``perform_alignment``. ``backend="hybrid"``
  routes the pair as the JAX package's hybrid does ("auto"): to the CUDA
  fill and traceback kernels on ``device`` when that device is a card and
  the pair has at least ``auto_device_min_cells()`` cells, to the host fill
  otherwise (a chant page, or any page on a CPU device); ``"device"``
  always takes the device fill and traceback on ``device`` (their plain
  versions on a CPU device); ``"host"`` always takes the host fill;
- assembly: the port's copy of the JAX package's host code
  (:mod:`.assemble`).

``stage_cache`` memoizes the preprocess and OCR stages under content keys
(:mod:`..utils.cache`), as the JAX package does, in a namespace of the
port's own: an entry the JAX package wrote into the same directory is a
miss here and is never unpickled.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from ..align.api import perform_alignment, resolve_device
from ..lang.syllabify import syllabify_text
from ..models.lineest import center_route
from ..models.lstm import pin_float32
from ..utils.cache import StageCache, content_key
from ..utils.ref_pickle import load_charboxes
from ..utils.timing import span, stage_timer
from .assemble import (
    expand_abbreviations,
    group_syllables,
    llocs_to_charboxes,
    rotate_bboxes,
)
from .preprocess import (
    SAT_AREA_THRESH_AREA,
    PreprocParams,
    identify_text_lines,
    preprocess_images,
    raster_page,
    rasters_on_card,
)

MEDIAN_LINE_MULT = 2  # threaded but unused, as in the reference

# the stage-cache namespace: every key of the port's entries hashes it, so
# the port and the JAX package can share a cache directory without either
# reading (unpickling) the other's entries
CACHE_NAMESPACE = "text_alignment_tpu_torch"


BACKENDS = ("host", "hybrid", "device")


def _normalizes_on_device(ocropus_model, backend, device) -> bool:
    """Whether the OCR stage normalizes lines on the device. A model path
    loaded here does so on a card with ``backend="hybrid"`` or
    ``"device"``: the whole OCR
    stage is then one device program per batch, while host/parity runs and
    CPU devices keep the scipy normalizer, as the reference does on a
    CPU-only runtime. A ready recognizer keeps its own setting."""
    if isinstance(ocropus_model, str):
        return backend in ("hybrid", "device") and device.type == "cuda"
    return bool(getattr(ocropus_model, "normalize_on_device", False))


def _resolve_recognizer(ocropus_model, backend, device):
    if ocropus_model is None:
        return None
    if isinstance(ocropus_model, str):
        from ..models.recognizer import SeqRecognizer

        load = (SeqRecognizer.from_vgsl
                if ocropus_model.endswith(".vgsl.npz")
                else SeqRecognizer.from_pyrnn)
        rec = load(ocropus_model, device=device)
        rec.normalize_on_device = _normalizes_on_device(ocropus_model,
                                                        backend, rec.device)
        return rec
    return ocropus_model  # already a SeqRecognizer


def _model_cache_id(ocropus_model) -> str:
    """Cache identity of the OCR model: path + mtime + size for files, a
    hash of the weights and the decoding setup for a ready recognizer
    (ocropy's BiLSTM or kraken's VGSL network)."""
    if isinstance(ocropus_model, str):
        try:
            st = os.stat(ocropus_model)
            return f"{ocropus_model}:{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            return ocropus_model
    params = getattr(ocropus_model, "params", None)
    if params is not None:
        leaves = [t.detach().cpu().numpy() for t in params.leaves()]
        charset = getattr(getattr(ocropus_model, "codec", None),
                          "charset", ())
        cfg = (tuple(charset),
               getattr(ocropus_model, "target_height", None),
               getattr(ocropus_model, "pad", None),
               getattr(ocropus_model, "normalize_on_device", None),
               getattr(ocropus_model, "decode", "region"))
        return content_key("model", repr(cfg), *leaves)
    return repr(type(ocropus_model))


def _normalizer_id(ocropus_model, backend, device) -> str:
    """The line normalizer the OCR stage takes, which decides the centers
    at the float32 knife edges: scipy's on the host, or the device chain's
    route (:func:`..models.lineest.center_route`; the pipeline's strips
    are onebit)."""
    if not _normalizes_on_device(ocropus_model, backend, device):
        return "host"
    return center_route(onebit=True)


def process(raw_image, transcript, ocropus_model=None, seq_align_params=None,
            wkdir_name=None, parallel=None, median_line_mult=MEDIAN_LINE_MULT,
            existing_ocr_pickle=None, existing_preproc_images=None,
            verbose=True, backend="host", existing_ocr=None, timer=None,
            preproc_params=None, stage_cache=None, existing_lines=None,
            existing_alignment=None, strict=True, device=None):
    """Align ``transcript`` to the text-layer ``raw_image``.

    raw_image: (H, W[, C]) uint8/bool numpy array. ``ocropus_model``: a
    ``.pyrnn(.gz)`` or ``.vgsl.npz`` path (loaded onto ``device``), or a
    ready ``SeqRecognizer``. ``device``: torch device of the OCR stage, of the
    device raster and of the device NW fill (None: the card; it raises
    when there is none). ``backend``: "hybrid" (the raster of
    :mod:`..ops.device` on a CUDA card, the native C++ raster on a CPU
    device; NW routed "auto"), "device" (the raster of :mod:`..ops.device`
    and NW on ``device``) or "host" (numpy raster, host NW fill); another
    name raises ``ValueError``. ``strict=False`` fixes the documented reference
    defects (stage-1 CC area filter, NW boundary extends).
    ``median_line_mult``, ``wkdir_name`` and ``parallel`` are accepted and
    inert, as in the reference. ``stage_cache``: a
    :class:`..utils.cache.StageCache` (or a directory path) that memoizes
    the preprocess and OCR stages under content-derived keys; the OCR key
    names the model, the backend, the normalizer route and the device type.
    """
    del wkdir_name, parallel, median_line_mult
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    pin_float32()
    device = resolve_device(device)
    raw_image = np.asarray(raw_image)
    timer = timer or stage_timer(enabled=False)
    if isinstance(stage_cache, str):
        stage_cache = StageCache(stage_cache)
    if not strict:
        from dataclasses import replace

        pp = preproc_params or PreprocParams()
        if pp.sat_area_thresh == PreprocParams.sat_area_thresh:
            pp = replace(pp, sat_area_thresh=SAT_AREA_THRESH_AREA)
        preproc_params = replace(pp, sat_filter_area=True)

    # -- PRE-PROCESSING --
    on_card = rasters_on_card(backend, device) and (
        existing_preproc_images is None or existing_lines is None)
    with span("ta.raster.card") if on_card else contextlib.nullcontext():
        if existing_preproc_images is not None:
            image, eroded, angle = existing_preproc_images
        else:
            with timer("preprocess"):
                if stage_cache is not None:
                    image, eroded, angle = stage_cache.cached(
                        "preproc",
                        content_key(CACHE_NAMESPACE, "preproc", raw_image,
                                    repr(preproc_params), backend),
                        lambda: preprocess_images(
                            raw_image, backend=backend,
                            params=preproc_params, device=device))
                else:
                    # on the card the eroded page stays packed there for
                    # the line finder
                    image, eroded, angle = raster_page(
                        raw_image, backend, params=preproc_params,
                        device=device)
        if existing_lines is not None:
            cc_strips, lines_peak_locs = existing_lines
        else:
            with timer("identify_lines"):
                cc_strips, lines_peak_locs, _ = identify_text_lines(
                    image, eroded, backend=backend, verbose=verbose,
                    params=preproc_params, device=device)

    # -- OCR --
    all_chars = []
    if existing_ocr is not None:
        all_chars = list(existing_ocr)
    elif existing_ocr_pickle:
        try:
            with open(existing_ocr_pickle, "rb") as f:
                all_chars = load_charboxes(f)
            if verbose:
                print("using pickled ocr results in {}...".format(
                    existing_ocr_pickle))
        except IOError:
            if verbose:
                print("Pickle file {} not found - performing ocr "
                      "instead".format(existing_ocr_pickle))
        except AttributeError:
            if verbose:
                print("Pickle error: re-performing ocr")

    if not all_chars and existing_ocr is None:
        if ocropus_model is None:
            raise ValueError(
                "no OCR source: pass ocropus_model, existing_ocr, or a "
                "readable existing_ocr_pickle")
        with timer("ocr"):
            def _run_ocr():
                # resolved lazily: a cache hit never pays the model load
                recognizer = _resolve_recognizer(ocropus_model, backend,
                                                 device)
                rows = recognizer.recognize_batch([s.img for s in cc_strips])
                return llocs_to_charboxes(cc_strips, rows)

            if stage_cache is not None:
                # the key covers everything that decides the OCR output: the
                # strips (from image, eroded and the params), the model, and
                # the normalizer actually taken (scipy, or the device's
                # default or full chain, which differ at the float32 knife
                # edges) with the device type
                all_chars, _other = stage_cache.cached(
                    "ocr",
                    content_key(CACHE_NAMESPACE, "ocr", image, eroded,
                                repr(preproc_params),
                                _model_cache_id(ocropus_model), backend,
                                _normalizer_id(ocropus_model, backend,
                                               device),
                                device.type),
                    _run_ocr)
            else:
                all_chars, _other = _run_ocr()

    if not all_chars:
        if verbose:
            print("OCR produced no characters! Skipping current file.")
        return None

    # -- ABBREVIATIONS --
    with timer("abbreviations"):
        all_chars = expand_abbreviations(all_chars)
    ocr = "".join(x.char for x in all_chars)
    all_chars_copy = list(all_chars)

    # -- ALIGNMENT + ASSEMBLY --
    if existing_alignment is not None:
        tra_align, ocr_align = existing_alignment
    else:
        with timer("align"):
            tra_align, ocr_align = perform_alignment(
                list(transcript), list(ocr), scoring_system=seq_align_params,
                verbose=False, strict=strict, device=device,
                backend={"hybrid": "auto"}.get(backend, backend))
    tra_align = "".join(tra_align)
    ocr_align = "".join(ocr_align)

    with timer("assemble"):
        syls = syllabify_text(transcript)
        syl_boxes = group_syllables(syls, tra_align, ocr_align, all_chars)
        syl_boxes = rotate_bboxes(syl_boxes, -1 * angle, image.shape,
                                  raw_image.shape)

    return syl_boxes, image, lines_peak_locs, all_chars_copy


def to_JSON_dict(syl_boxes, lines_peak_locs, strict=True) -> dict:
    """Canonical output dict. NB 'median_line_spacing' is the 75th
    percentile of inter-peak gaps (a reference quirk; ``strict=False``
    uses the true median). Fewer than two lines give 0.0."""
    if len(lines_peak_locs) < 2:
        med_line_spacing = 0.0
    else:
        med_line_spacing = np.quantile(np.diff(lines_peak_locs),
                                       0.75 if strict else 0.5)
    return {
        "median_line_spacing": med_line_spacing,
        "syl_boxes": [
            {"syl": s.char,
             "ul": [int(s.ul[0]), int(s.ul[1])],
             "lr": [int(s.lr[0]), int(s.lr[1])]}
            for s in syl_boxes
        ],
    }
