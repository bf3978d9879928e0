"""Spool-directory serving loop of the port — the standalone analog of the
Rodan job queue (reference textAlignment.py:51: Rodan/Celery schedules one
``run_my_task`` per folio across platform workers).

Counterpart of ``text_alignment_tpu/serve.py``, with ``device``: one
long-lived process watches a spool directory for job files, keeping the
recognizer weights on the device and the CUDA kernels built and loaded
across jobs, so a job pays the steady-state pipeline cost instead of a
model load and a kernel build per folio the way one-shot CLI invocations
would. The card is the default device; ``device="cpu"`` runs the plain
versions on the CPU.

Job file protocol (``<name>.job.json`` in the spool directory):

    {
      "image": "folio_text.png",            // required: text-layer image
      "transcript": "deus alleluia ...",    // literal transcript text, or
      "transcript_path": "folio.txt",       //   a file (read_file rules)
      "output": "out/folio.json",           // default: <spool>/<name>.json
      "seq_align_params": [8,-4,-7,-7,-3,0],// optional scoring override
      "existing_ocr_pickle": "f.pickle"     // optional OCR stage reuse
    }

Claiming is atomic: the server renames ``X.job.json`` to ``X.job.running``
before touching it (same-filesystem rename), so multiple server processes
can share one spool without double-processing — the multi-worker story of
``ocropus-rpred -Q N`` and the Rodan fan-out, one directory instead of a
message broker. Completed jobs become ``X.job.done`` (the job spec plus the
result path); failures become ``X.job.failed`` (the job spec plus the
traceback — rename it back to ``.job.json`` to requeue). Claims orphaned by
a crashed worker (stale ``.job.running`` files) are requeued at startup.

Relative paths inside a job file resolve against the spool directory.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import NamedTuple

import numpy as np


class ServeStats(NamedTuple):
    """Outcome accounting for one serve() run.

    ``processed`` and ``failed`` are disjoint; ``max_jobs`` bounds their sum
    (a failed job still consumed a job slot) but the two are reported
    separately so "processed 10 job(s)" can never mean "9 succeeded"."""

    processed: int
    failed: int

    @property
    def attempted(self) -> int:
        return self.processed + self.failed


def _resolve(spool: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(spool, path)


def _load_transcript(spool: str, job: dict) -> str:
    if "transcript" in job:
        return job["transcript"]
    if "transcript_path" in job:
        from .textio import read_file

        return read_file(_resolve(spool, job["transcript_path"]))
    raise ValueError("job needs 'transcript' or 'transcript_path'")


def _job_output_path(spool: str, job_path: str, job: dict) -> str:
    name = os.path.basename(job_path)
    for suffix in (".job.running", ".job.json"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
            break
    return _resolve(spool, job.get("output", name + ".json"))


def _parse_job(spool: str, job_path: str, recognizer):
    """Load a claimed job's spec AND its inputs (image, transcript, OCR
    pickle) for the batched path. Returns (job, raw_image, transcript,
    existing_ocr | None, out_path). Pickle-read failures fall back to the
    model exactly like pipeline.process's existing_ocr_pickle handling;
    with no model available they are job errors instead."""
    from PIL import Image

    with open(job_path) as f:
        job = json.load(f)
    raw_image = np.asarray(Image.open(_resolve(spool, job["image"])))
    transcript = _load_transcript(spool, job)
    existing_ocr = None
    if job.get("existing_ocr_pickle"):
        from .utils.ref_pickle import load_charboxes

        try:
            with open(_resolve(spool, job["existing_ocr_pickle"]), "rb") as f:
                existing_ocr = load_charboxes(f)
        except (IOError, AttributeError):
            existing_ocr = None  # process()'s fallback-to-OCR semantics
        if not existing_ocr:
            # an EMPTY unpickled stream also falls back to the model in
            # process() ("if not all_chars"); mirror that so --batch and
            # singleton serving give identical receipts
            existing_ocr = None
    if existing_ocr is None and recognizer is None:
        raise ValueError(
            "no OCR source: the server has no model and the job supplies "
            "no readable existing_ocr_pickle"
        )
    return job, raw_image, transcript, existing_ocr, \
        _job_output_path(spool, job_path, job)


def _process_claims_batched(spool, claims, recognizer, backend, verbose,
                            device):
    """Run a sweep of claimed jobs through the stage-major batched
    pipeline (parallel.batch.process_batch) on ``device``: the folios' OCR
    queued together and NW batched by size bucket instead of one job at a
    time. Jobs group by
    (scoring override, OCR-injection mode) since process_batch fixes both
    per call. Per-job isolation: spec/input errors fail only that job; a
    batch-level exception falls back to one-job-at-a-time processing.

    Returns, per claim, ("ok", out_path, job) or
    ("fail", traceback_str)."""
    from .parallel.batch import process_batch

    results = [None] * len(claims)
    parsed = {}
    for i, (_fname, claimed) in enumerate(claims):
        try:
            parsed[i] = _parse_job(spool, claimed, recognizer)
        except Exception:
            results[i] = ("fail", traceback.format_exc())

    groups: dict = {}
    for i, (job, _img, _tr, ocr, _out) in parsed.items():
        params = job.get("seq_align_params")
        try:
            # a malformed override (non-iterable, nested lists) must fail
            # THIS job, not crash the sweep: singleton serving would have
            # written a .failed receipt and completed the rest
            key = (tuple(params) if params else None, ocr is not None)
            hash(key)
        except Exception:
            results[i] = ("fail", traceback.format_exc())
            continue
        groups.setdefault(key, []).append(i)

    for (params, has_ocr), idxs in groups.items():
        folios = [(parsed[i][1], parsed[i][2]) for i in idxs]
        try:
            batch = process_batch(
                folios, recognizer,
                seq_align_params=list(params) if params else None,
                backend=backend,
                existing_ocr=[parsed[i][3] for i in idxs] if has_ocr
                else None,
                device=device,
            )
        except Exception:
            # isolate the failure: retry the group one job at a time
            for i in idxs:
                fname, claimed = claims[i]
                try:
                    out_path, job = process_job(spool, claimed, recognizer,
                                                backend, verbose=verbose,
                                                device=device)
                    results[i] = ("ok", out_path, job)
                except Exception:
                    results[i] = ("fail", traceback.format_exc())
            continue
        for i, folio_result in zip(idxs, batch):
            job, _img, _tr, _ocr, out_path = parsed[i]
            if folio_result is None:
                results[i] = ("fail", "pipeline produced no alignable OCR")
                continue
            try:
                # per-job isolation, like singleton serving: an unwritable
                # output path fails THIS job (a .failed receipt), not the
                # whole sweep — an escaped OSError here would kill serve()
                # and strand every claimed job in the sweep as .running
                os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(folio_result.json_dict, f)
            except Exception:
                results[i] = ("fail", traceback.format_exc())
                continue
            results[i] = ("ok", out_path, job)
    return results


def process_job(spool: str, job_path: str, recognizer, backend: str,
                verbose: bool = False, device=None):
    """Run one claimed job file on ``device``; returns (output path, job
    dict)."""
    from PIL import Image

    from .pipeline import process, to_JSON_dict

    with open(job_path) as f:
        job = json.load(f)

    raw_image = np.asarray(Image.open(_resolve(spool, job["image"])))
    transcript = _load_transcript(spool, job)

    result = process(
        raw_image,
        transcript,
        ocropus_model=recognizer,
        seq_align_params=job.get("seq_align_params"),
        existing_ocr_pickle=(
            _resolve(spool, job["existing_ocr_pickle"])
            if job.get("existing_ocr_pickle") else None
        ),
        backend=backend,
        verbose=verbose,
        device=device,
    )
    if result is None:
        raise RuntimeError("pipeline produced no alignable OCR")
    syl_boxes, _, lines_peak_locs, _ = result

    out_path = _job_output_path(spool, job_path, job)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(to_JSON_dict(syl_boxes, lines_peak_locs), f)
    return out_path, job


def warmup(recognizer, backend: str, batch: int = 1, device=None) -> None:
    """Build and load the CUDA kernels (on a card) and run one full-size
    synthetic folio through the pipeline, so the first real job pays
    neither the nvcc build nor the first calls' set-up on the device
    (cuBLAS handles, the caching allocator). With ``recognizer=None`` the
    folio carries injected OCR, which is what jobs that supply
    ``existing_ocr_pickle`` run. With ``batch > 1`` one batch of three
    folios runs through the batched pipeline too."""
    from .align.api import resolve_device
    from .synth import make_page, corrupt_ocr, ocr_with_spaces
    from .pipeline import process

    device = resolve_device(device)
    t0 = time.time()
    if device.type == "cuda":
        from . import _kernels

        _kernels.lib()
    page = make_page(np.random.default_rng(0), n_lines=10,
                     words_per_line=3, H=2000, W=1600, char_h=70,
                     char_w=40, gap=8, space_w=60, line_spacing=180,
                     margin_x=60, angle=0.5)
    existing_ocr = None
    if recognizer is None:
        existing_ocr = ocr_with_spaces(
            corrupt_ocr(np.random.default_rng(1), page.char_boxes)
        )
    process(page.image, page.transcript, ocropus_model=recognizer,
            existing_ocr=existing_ocr, backend=backend, verbose=False,
            device=device)
    if batch > 1:
        from .parallel.batch import process_batch

        pages = [
            make_page(np.random.default_rng(10 + i), n_lines=10,
                      words_per_line=3, H=2000, W=1600, char_h=70, char_w=40,
                      gap=8, space_w=60, line_spacing=180, margin_x=60,
                      angle=0.5)
            for i in range(3)
        ]
        folios = [(p.image, p.transcript) for p in pages]
        inj = None
        if recognizer is None:
            inj = [
                ocr_with_spaces(corrupt_ocr(
                    np.random.default_rng(20 + i), p.char_boxes))
                for i, p in enumerate(pages)
            ]
        process_batch(folios, recognizer, backend=backend,
                      existing_ocr=inj, device=device)
    print(f"warmup: {time.time() - t0:.1f}s (kernels built, device warm)")


def serve(spool: str, model, backend: str = "hybrid", poll_s: float = 0.2,
          once: bool = False, max_jobs: int | None = None,
          verbose: bool = False, do_warmup: bool = False,
          stale_after_s: float = 900.0, batch: int = 1,
          device=None) -> ServeStats:
    """Process ``*.job.json`` files in ``spool`` until interrupted (or, with
    ``once=True``, until the directory holds no more pending jobs).
    Returns :class:`ServeStats` — processed and failed counted separately.

    ``batch > 1`` drains up to that many pending jobs per sweep through
    the stage-major batched pipeline (the OCR of each folio queued while
    the host rasters the next, NW batched by size bucket) — the throughput
    mode for backlogged spools. Receipts and outputs are identical to
    one-at-a-time serving. ``device``: the torch device of the recognizer
    and the pipeline's device stages (None: the card; it raises when there
    is none)."""
    from .align.api import resolve_device
    from .pipeline.process import _resolve_recognizer

    device = resolve_device(device)
    recognizer = (_resolve_recognizer(model, backend, device) if model
                  else None)
    if do_warmup:
        warmup(recognizer, backend, batch=batch, device=device)
    # reclaim orphans: a worker killed mid-job leaves X.job.running behind,
    # which the pending filter would otherwise never pick up again. Only
    # claims older than stale_after_s are requeued — a younger one may be
    # a concurrent worker's ACTIVE claim, and stealing it would
    # double-process the job.
    now = time.time()
    for fname in sorted(os.listdir(spool)):
        if not fname.endswith(".job.running"):
            continue
        path = os.path.join(spool, fname)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue
        if age > stale_after_s:
            print(f"requeueing orphaned claim {fname} (age {age:.0f}s)")
            try:
                os.rename(path, path[: -len(".running")] + ".json")
            except FileNotFoundError:
                # a concurrently-starting worker reclaimed (or re-claimed)
                # it first — same lost-race handling as the claim loop
                continue
        else:
            print(f"note: {fname} looks like another worker's active claim "
                  f"(age {age:.0f}s < {stale_after_s:.0f}s); leaving it")
    processed = 0
    failed = 0

    def _write_done(fname, claimed, out_path, job):
        nonlocal processed
        job["result"] = out_path
        with open(claimed[: -len(".running")] + ".done", "w") as f:
            json.dump(job, f)
        os.remove(claimed)
        processed += 1
        print(f"done {fname} -> {out_path}")

    def _write_failed(fname, claimed, tb: str):
        nonlocal failed
        # keep the job spec in the receipt so a failed job can be
        # requeued by renaming it back to .job.json
        try:
            with open(claimed) as f:
                job_spec = json.load(f)
        except Exception:
            job_spec = None
        final = claimed[: -len(".running")] + ".failed"
        with open(final, "w") as f:
            json.dump({"job": job_spec, "traceback": tb}, f, indent=1)
        os.remove(claimed)
        failed += 1
        print(f"FAILED {fname} (see {os.path.basename(final)})")

    while True:
        if max_jobs is not None and processed + failed >= max_jobs:
            return ServeStats(processed, failed)  # incl. max_jobs <= 0
        pending = sorted(
            f for f in os.listdir(spool) if f.endswith(".job.json")
        )
        if not pending:
            if once:
                return ServeStats(processed, failed)
            time.sleep(poll_s)
            continue
        # claim up to `batch` jobs for this sweep (never claim past
        # max_jobs: abandoned claims would strand as .running files)
        room = max(1, batch)
        if max_jobs is not None:
            room = min(room, max_jobs - (processed + failed))
        claims = []
        for fname in pending:
            if len(claims) >= room:
                break
            job_path = os.path.join(spool, fname)
            claimed = job_path[: -len(".json")] + ".running"
            try:  # atomic claim
                os.rename(job_path, claimed)
            except FileNotFoundError:
                continue  # lost the race to another worker
            # any other OSError (read-only spool, EACCES) is a real fault:
            # swallowing it would leave the job pending and busy-spin
            claims.append((fname, claimed))
        if not claims:
            continue
        if len(claims) == 1:
            fname, claimed = claims[0]
            try:
                out_path, job = process_job(spool, claimed, recognizer,
                                            backend, verbose=verbose,
                                            device=device)
                _write_done(fname, claimed, out_path, job)
            except Exception:
                _write_failed(fname, claimed, traceback.format_exc())
        else:
            outcomes = _process_claims_batched(spool, claims, recognizer,
                                               backend, verbose, device)
            for (fname, claimed), outcome in zip(claims, outcomes):
                if outcome[0] == "ok":
                    _write_done(fname, claimed, outcome[1], outcome[2])
                else:
                    _write_failed(fname, claimed, outcome[1])
        if max_jobs is not None and processed + failed >= max_jobs:
            return ServeStats(processed, failed)
