"""Batched multi-folio pipeline: ``process_batch``.

Counterpart of ``text_alignment_tpu/parallel/batch.py``. Stage-major
scheduling instead of folio-major: every page rasters first, each
folio's OCR is queued on the device as soon as its strips exist (the
device recognizes folio i while the host rasters folio i+1), then all
alignments run as bucketed batched NW fills (:func:`..align.nw_torch.
align_pairs`, one launch per size bucket), then host assembly. Output is
byte-identical to the JAX package's ``process_batch`` and to the port's
sequential ``process()``.

The raster stage is :func:`..pipeline.preprocess.raster_stream`, whose
engine :func:`..pipeline.preprocess.raster_backend` picks from
``backend`` and ``device``, as it does for ``process()``: on a CUDA card
``"device"`` (the default, as in the JAX package) and ``"hybrid"`` both
raster with :mod:`..ops.device`, the eroded page staying packed on the
card for the line finder; on a CPU device ``"hybrid"`` takes the native
host engine.

With a ``mesh`` (:mod:`.mesh`), the whole batch is sharded over the
ranks of its ``data`` axis, every rank holding the same folios: each rank
rasters every folio on a thread pool (on the same engine), the
cross-folio OCR batch is sharded (:mod:`.infer_dp`) and so are the NW
buckets (``align_pairs``); every rank returns the same results,
byte-identical to the unsharded batch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..align import perform_alignment
from ..align.api import resolve_device
from ..align.nw_torch import align_pairs
from ..align.scoring import resolve_scoring
from ..lang.syllabify import syllabify_text
from ..models.lstm import pin_float32
from ..pipeline.assemble import (
    llocs_to_charboxes,
    expand_abbreviations,
    group_syllables,
    rotate_bboxes,
)
from ..pipeline.preprocess import raster_stream
from ..pipeline.process import BACKENDS, to_JSON_dict
from ..utils.timing import StageTimer


@dataclass
class FolioResult:
    syl_boxes: list
    peaks: list
    json_dict: dict
    # the folio's full OCR CharBox stream post-abbreviation-expansion —
    # the same value process() returns as all_chars (alignToOCR.py's
    # pickle side-channel), so batched callers can refresh --pickle-dir
    all_chars: list | None = None


class PipelinedOCRWorker:
    """Background OCR worker for the stage-major pipeline: queues each
    folio's OCR on the device as the raster loop hands it over, and runs
    the combined collects off the critical path. Once half the folios are
    dispatched, their combined copy back starts on a second thread and
    overlaps the raster of the remaining folios.

    The worker's threads issue their device work on the stream that was
    current on the constructing thread, so it is ordered after the raster
    programs that produced a device-resident page (one stream, in issue
    order).

    Protocol: construct with the folio count, call :meth:`put` with each
    folio's strip images (in order), then :meth:`rows` to join. On a
    raster failure call :meth:`abandon` (idempotent; also safe after full
    enqueue) so the worker — which loops exactly ``n`` times on the queue
    — terminates instead of leaking a blocked thread."""

    def __init__(self, recognizer, n: int):
        import queue
        import threading

        self._rec = recognizer
        self._n = n
        self._enqueued = 0
        self._cancelled = False
        self._q: queue.Queue = queue.Queue()
        self._out: dict = {}
        self._split = n // 2 if n >= 6 else None
        dev = recognizer.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            if self._stream is None:
                self._work()
            else:
                with torch.cuda.stream(self._stream):
                    self._work()
        except BaseException as e:  # re-raised at rows()
            self._out["err"] = e

    def _work(self):
        handles = []
        first_join = None
        for _ in range(self._n):
            item = self._q.get()
            if self._cancelled:
                break
            handles.append(self._rec.dispatch_async(item))
            if self._split is not None and len(handles) == self._split:
                first_join = self._rec.collect_async_bg(
                    handles[: self._split])
        if self._cancelled:
            self._out["err"] = RuntimeError(
                "OCR worker abandoned: the batch's raster failed")
            return
        if first_join is not None:
            self._out["rows"] = first_join() + self._rec.collect_async(
                handles[self._split:])
        else:
            self._out["rows"] = self._rec.collect_async(handles)

    def put(self, strips) -> None:
        self._q.put(strips)
        self._enqueued += 1

    def abandon(self) -> None:
        """Cancel a partially-enqueued batch: feed sentinels so the
        worker's fixed-count loop terminates, and flag it to skip the
        not-yet-dispatched folios and the result copies. No-op after full
        enqueue."""
        if self._enqueued >= self._n:
            return
        self._cancelled = True
        while self._enqueued < self._n:
            self.put([])

    def rows(self) -> list:
        self._thread.join()
        if "err" in self._out:
            raise self._out["err"]
        return self._out["rows"]


def process_batch(folios, recognizer, seq_align_params=None,
                  backend: str = "device", preproc_params=None,
                  timer: StageTimer | None = None,
                  existing_ocr: list | None = None,
                  existing_pre: list | None = None,
                  mesh=None,
                  min_align_device_cells: int | None = None,
                  raster_workers: int | None = None,
                  strict: bool = True,
                  device=None) -> list[FolioResult | None]:
    """folios: list of (raw_image, transcript). Returns FolioResult per
    folio (None where OCR produced nothing alignable).

    ``recognizer``: a :class:`..models.recognizer.SeqRecognizer` (its own
    device runs the OCR). ``device``: the torch device of the raster's
    device stages and of the NW fill (None: the card; it raises when there
    is none). ``backend``: "device" (the raster of :mod:`..ops.device` on
    ``device``), "hybrid" (the same on a CUDA card, the native host raster
    on a CPU device), both with NW on the device above
    ``min_align_device_cells``, or "host" (numpy raster, host NW); another
    name raises ``ValueError``.
    ``existing_ocr`` optionally injects per-folio CharBox streams,
    skipping the recognizer. ``existing_pre`` injects per-folio (image,
    angle, strips, peaks) tuples, skipping the raster stage.
    ``min_align_device_cells`` forwards to ``align_pairs`` (0 sends every
    pair to the device). ``raster_workers`` rasters the folios on a
    thread pool (the native engine's calls release the GIL), on the same
    engine.

    ``mesh`` shards the batch over a ``torch.distributed`` mesh's
    ``data`` axis, the Rodan/Celery folio fan-out's counterpart (reference
    textAlignment.py:51): the raster runs on a thread pool, the
    cross-folio OCR batch shards through a copy of ``recognizer`` with the
    mesh set (the caller's recognizer is left as it is), and the bucketed
    NW launches shard their pairs. The pipelined OCR worker is off under
    a mesh and with ``raster_workers``. ``device`` is then this rank's
    device (None: the mesh's). Output is byte-identical to the unsharded
    run."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    pin_float32()
    if mesh is not None:
        from .mesh import mesh_device

        device = mesh_device(mesh, device)
        if recognizer is not None and getattr(recognizer, "mesh",
                                              None) is not mesh:
            import copy

            recognizer = copy.copy(recognizer)
            recognizer.mesh = mesh
            mesh_device(mesh, recognizer.device)
    device = resolve_device(device)
    timer = timer or StageTimer(enabled=False)
    n = len(folios)
    if not strict:
        # quirk-fix mode: area-based saturated-CC filter (process() strict
        # docstring); the NW boundary fix rides the Scoring below
        from dataclasses import replace as _dc_replace

        from ..pipeline.preprocess import PreprocParams as _PP
        from ..pipeline.preprocess import SAT_AREA_THRESH_AREA

        pp = preproc_params or _PP()
        if pp.sat_area_thresh == _PP.sat_area_thresh:
            pp = _dc_replace(pp, sat_area_thresh=SAT_AREA_THRESH_AREA)
        preproc_params = _dc_replace(pp, sat_filter_area=True)

    # stage 1: preprocess + line identification. When the recognizer
    # normalizes on the device and the folios raster in turn, each folio's
    # OCR is queued as soon as its strips exist, so the device recognizes
    # folio i while the host rasters folio i+1.
    pipelined = (
        existing_ocr is None
        and existing_pre is None
        and not raster_workers
        and recognizer is not None
        and getattr(recognizer, "normalize_on_device", False)
        and getattr(recognizer, "mesh", None) is None
    )

    def _raster(images):
        return raster_stream(images, backend=backend, params=preproc_params,
                             device=device)

    if existing_pre is not None:
        pre = list(existing_pre)
    elif mesh is not None or raster_workers:
        from concurrent.futures import ThreadPoolExecutor

        workers = raster_workers or max(1, min(n, os.cpu_count() or 1))
        with timer("preprocess"):
            with ThreadPoolExecutor(max_workers=workers) as ex:
                pre = list(ex.map(
                    lambda f: next(_raster([np.asarray(f[0])])), folios))
    else:
        pre = []
        ocr_worker = PipelinedOCRWorker(recognizer, n) if pipelined else None
        with timer("preprocess"):
            try:
                for item in _raster([np.asarray(f[0]) for f in folios]):
                    pre.append(item)
                    if ocr_worker is not None:
                        ocr_worker.put([s.img for s in item[2]])
            finally:
                # a raster failure must not strand the worker (it loops
                # exactly n times on the queue)
                if ocr_worker is not None:
                    ocr_worker.abandon()

    # stage 2: OCR — join the pipelined worker, or run one cross-folio
    # batch
    if existing_ocr is not None:
        all_chars_per_folio = [list(x) for x in existing_ocr]
    elif pipelined:
        with timer("ocr"):
            rows_per_folio = ocr_worker.rows()
        all_chars_per_folio = []
        for rows, (_, _, strips, _) in zip(rows_per_folio, pre):
            chars, _ = llocs_to_charboxes(strips, rows)
            all_chars_per_folio.append(chars)
    else:
        flat_strips = []
        spans = []
        for _, _, strips, _ in pre:
            spans.append((len(flat_strips), len(flat_strips) + len(strips)))
            flat_strips.extend(strips)
        with timer("ocr"):
            rows_flat = recognizer.recognize_batch(
                [s.img for s in flat_strips])
        all_chars_per_folio = []
        for (lo, hi), (_, _, strips, _) in zip(spans, pre):
            chars, _ = llocs_to_charboxes(strips, rows_flat[lo:hi])
            all_chars_per_folio.append(chars)

    # stage 3: abbreviations (host) + bucketed batched NW
    with timer("abbreviations"):
        all_chars_per_folio = [
            expand_abbreviations(ch) if ch else ch
            for ch in all_chars_per_folio
        ]

    sc = resolve_scoring(seq_align_params, strict=strict)
    pairs = []
    pair_idx = []
    for i, ((_, transcript), chars) in enumerate(zip(folios,
                                                     all_chars_per_folio)):
        if not chars:
            continue
        ocr = "".join(x.char for x in chars)
        pairs.append((list(transcript), list(ocr)))
        pair_idx.append(i)

    with timer("align"):
        if backend in ("device", "hybrid"):
            aligned = align_pairs(pairs, sc,
                                  min_device_cells=min_align_device_cells,
                                  device=device, mesh=mesh)
            # non-integer/custom scoring falls back per pair
            aligned = [
                a
                if a is not None
                else perform_alignment(t, o, scoring_system=seq_align_params,
                                       backend="host", strict=strict)
                for a, (t, o) in zip(aligned, pairs)
            ]
        else:
            aligned = [
                perform_alignment(t, o, scoring_system=seq_align_params,
                                  backend="host", strict=strict)
                for t, o in pairs
            ]

    # stage 4: host assembly
    results: list[FolioResult | None] = [None] * n
    with timer("assemble"):
        for (i, (tra_align, ocr_align)) in zip(pair_idx, aligned):
            raw_image, transcript = folios[i]
            image, angle, strips, peaks = pre[i]
            chars = all_chars_per_folio[i]
            syls = syllabify_text(transcript)
            syl_boxes = group_syllables(
                syls, "".join(tra_align), "".join(ocr_align), chars)
            syl_boxes = rotate_bboxes(
                syl_boxes, -1 * angle, image.shape,
                np.asarray(raw_image).shape)
            results[i] = FolioResult(
                syl_boxes, peaks, to_JSON_dict(syl_boxes, peaks,
                                               strict=strict),
                list(chars))
    return results
