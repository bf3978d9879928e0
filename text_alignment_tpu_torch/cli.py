"""Command-line entry point of the port.

Usage:
    python -m text_alignment_tpu_torch align --csv chants.csv \\
        --manuscript salzinnes --model model.pyrnn.gz \\
        --png-dir ./png --out-json ./out_json --folios 60 61 --device cuda
    python -m text_alignment_tpu_torch serve --spool DIR --model M --once
    python -m text_alignment_tpu_torch evaluate ...
    python -m text_alignment_tpu_torch mei ...
    python -m text_alignment_tpu_torch verify-reference --assets DIR
    python -m text_alignment_tpu_torch lines page.png --out-dir lines
    python -m text_alignment_tpu_torch gtedit html --lines-dir lines
    python -m text_alignment_tpu_torch train --lines-dir lines \
        [--network kraken]

Counterpart of ``text_alignment_tpu/cli.py``: ``align`` (the folio-at-a-
time loop, with ``--cache-dir`` the content-addressed stage cache, and with
``--batch N`` the stage-major batched pipeline, N folios per call, which
rasters on the card as the folio loop does),
``serve`` (the spool-directory server), ``evaluate`` (IoU evaluation and
the scoring grid search), ``mei``, ``verify-reference``, and the training
workflow: ``lines`` (per-line training crops), ``gtedit`` (the correction
page and its ground truth) and ``train`` (the CTC trainer of ocropy's
BiLSTM, or with ``--network kraken`` of kraken's VGSL network). The card is
the default device of every subcommand, which raises without one;
``--device cpu`` runs on the CPU. ``lines`` and ``gtedit extract`` do
their work on the host whatever the device. ``TEXT_ALIGNMENT_TPU_TAIL=
full`` takes the full-chain normalizer kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np


def _load_image(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _folio_ids(values, text_func=None):
    if text_func is not None and list(values) == ["all"]:
        return list(getattr(text_func, "folios", []))
    out = []
    for v in values:
        try:
            out.append(int(v))
        except ValueError:
            out.append(v)
    return out


def cmd_align(args):
    from .lang import filename_to_text_func
    from .pipeline import process, to_JSON_dict
    from .pipeline.render import draw_results_on_page
    from .utils.timing import stage_timer

    text_func = filename_to_text_func(args.csv, args.mapping)
    os.makedirs(args.out_json, exist_ok=True)
    if args.pickle_dir:
        os.makedirs(args.pickle_dir, exist_ok=True)
    if args.out_imgs:
        os.makedirs(args.out_imgs, exist_ok=True)

    timer = stage_timer(enabled=args.timing)
    if args.batch and args.batch > 1:
        if args.cache_dir:
            print("note: --cache-dir applies to sequential alignment only; "
                  "ignoring it under --batch")
        return _align_batched(args, text_func, timer)
    for ind in _folio_ids(args.folios, text_func):
        try:
            fname, transcript = text_func(ind)
        except ValueError as e:
            print(e)
            print("no chants listed for page {}".format(ind))
            continue

        fname = "{}_{}".format(args.manuscript, fname)
        text_layer_fname = os.path.join(args.png_dir, fname + "_text.png")
        if not os.path.isfile(text_layer_fname):
            print("cannot find files for {}.".format(fname))
            continue

        print("processing {}...".format(fname))
        raw_image = _load_image(text_layer_fname)
        ocr_pickle = (os.path.join(args.pickle_dir, fname + "_boxes.pickle")
                      if args.pickle_dir else None)
        result = process(
            raw_image, transcript, ocropus_model=args.model,
            existing_ocr_pickle=ocr_pickle if args.reuse_ocr else None,
            backend=args.backend, verbose=args.verbose, timer=timer,
            stage_cache=args.cache_dir, strict=args.strict,
            device=args.device)
        if result is None:
            continue
        syl_boxes, _, lines_peak_locs, all_chars = result

        out_path = os.path.join(args.out_json, fname + ".json")
        with open(out_path, "w") as f:
            json.dump(to_JSON_dict(syl_boxes, lines_peak_locs,
                                   strict=args.strict), f)
        print("wrote {}".format(out_path))

        if args.pickle_dir:
            with open(ocr_pickle, "wb") as f:
                pickle.dump(all_chars, f, -1)
        if args.out_imgs:
            draw_results_on_page(
                raw_image, syl_boxes, lines_peak_locs,
                os.path.join(args.out_imgs, fname + "_alignment.png"))
    if args.timing:
        print(timer.report())
    return 0


def _align_batched(args, text_func, timer):
    """align --batch N: drain folios through the stage-major batched
    pipeline (parallel.batch.process_batch) instead of folio-at-a-time
    process(). Outputs (JSON, --pickle-dir dumps, overlays) are
    byte-identical to the sequential loop; a chunk groups OCR-injected and
    model folios into separate process_batch calls since the pipeline fixes
    the OCR mode per call."""
    from .parallel.batch import process_batch
    from .pipeline.process import _resolve_recognizer
    from .pipeline.render import draw_results_on_page
    from .utils.ref_pickle import load_charboxes

    items = []  # (fname, transcript, image_path, ocr_pickle, injected)
    for ind in _folio_ids(args.folios, text_func):
        try:
            fname, transcript = text_func(ind)
        except ValueError as e:
            print(e)
            print("no chants listed for page {}".format(ind))
            continue
        fname = "{}_{}".format(args.manuscript, fname)
        text_layer_fname = os.path.join(args.png_dir, fname + "_text.png")
        if not os.path.isfile(text_layer_fname):
            print("cannot find files for {}.".format(fname))
            continue
        ocr_pickle = (os.path.join(args.pickle_dir, fname + "_boxes.pickle")
                      if args.pickle_dir else None)
        injected = None
        if args.reuse_ocr and ocr_pickle and os.path.isfile(ocr_pickle):
            with open(ocr_pickle, "rb") as f:
                injected = load_charboxes(f)
        items.append((fname, transcript, text_layer_fname, ocr_pickle,
                      injected))

    needs_model = any(it[4] is None for it in items)
    recognizer = (_resolve_recognizer(args.model, args.backend, args.device)
                  if (args.model and needs_model) else None)
    for lo in range(0, len(items), args.batch):
        chunk = items[lo:lo + args.batch]
        for has_ocr in (True, False):
            idxs = [k for k, it in enumerate(chunk)
                    if (it[4] is not None) == has_ocr]
            if not idxs:
                continue
            if not has_ocr and recognizer is None:
                for k in idxs:
                    print("no model and no reusable OCR for {}; "
                          "skipping.".format(chunk[k][0]))
                continue
            folios = []
            for k in idxs:
                fname, transcript, img_path, _, _ = chunk[k]
                print("processing {}...".format(fname))
                folios.append((_load_image(img_path), transcript))
            results = process_batch(
                folios, None if has_ocr else recognizer,
                backend=args.backend, timer=timer,
                existing_ocr=([chunk[k][4] for k in idxs] if has_ocr
                              else None),
                strict=args.strict, device=args.device)
            for k, res in zip(idxs, results):
                fname, _, img_path, ocr_pickle, _ = chunk[k]
                if res is None:
                    continue
                out_path = os.path.join(args.out_json, fname + ".json")
                with open(out_path, "w") as f:
                    json.dump(res.json_dict, f)
                print("wrote {}".format(out_path))
                if args.pickle_dir:
                    with open(ocr_pickle, "wb") as f:
                        pickle.dump(res.all_chars, f, -1)
                if args.out_imgs:
                    draw_results_on_page(
                        _load_image(img_path), res.syl_boxes, res.peaks,
                        os.path.join(args.out_imgs,
                                     fname + "_alignment.png"))
    if args.timing:
        print(timer.report())
    return 0


def cmd_evaluate(args):
    from .evaluate import grid_search, parse_gt_xml
    from .lang import filename_to_text_func
    from .utils.ref_pickle import load_charboxes

    text_func = filename_to_text_func(args.csv, args.mapping)
    fixtures = []
    eval_inds = []
    for ind in _folio_ids(args.folios, text_func):
        try:
            fname, transcript = text_func(ind)
        except ValueError as e:
            print(e)
            print("no chants listed for page {}".format(ind))
            continue
        fname = "{}_{}".format(args.manuscript, fname)
        png_path = os.path.join(args.png_dir, fname + "_text.png")
        pik_path = os.path.join(args.pickle_dir, fname + "_boxes.pickle")
        gt_path = os.path.join(args.gt_dir, fname + "_gt.xml")
        missing = [p for p in (png_path, pik_path, gt_path)
                   if not os.path.isfile(p)]
        if missing:
            print("skipping {}: missing {}".format(
                fname, ", ".join(missing)))
            continue
        with open(pik_path, "rb") as f:
            existing_ocr = load_charboxes(f)
        fixtures.append({"raw_image": _load_image(png_path),
                         "transcript": transcript,
                         "gt_boxes": parse_gt_xml(gt_path),
                         "existing_ocr": existing_ocr})
        eval_inds.append(ind)
    if not fixtures:
        print("no evaluable folios (need page image + OCR pickle + GT XML)")
        return 1
    if args.grid:
        logs, ranked = grid_search(fixtures, backend=args.backend,
                                   device=args.device)
        print(ranked[-10:])
        return 0

    # single-scoring evaluation: per-folio mean bbox IoU and ink IoU with
    # the default (or given) scoring
    from .evaluate import evaluate_alignment
    from .pipeline import process, to_JSON_dict
    from .pipeline.preprocess import preprocess_images

    scoring = json.loads(args.scoring) if args.scoring else None
    scores = []
    for fx, ind in zip(fixtures, eval_inds):
        eval_img, _, _ = preprocess_images(
            fx["raw_image"], correct_rotation=False, backend=args.backend,
            device=args.device)
        result = process(
            fx["raw_image"], fx["transcript"], seq_align_params=scoring,
            existing_ocr=fx["existing_ocr"], verbose=False,
            backend=args.backend, device=args.device)
        if result is None:
            print(f"{ind}: no alignable OCR; skipped")
            continue
        syl_boxes, _, peaks, _ = result
        d = to_JSON_dict(syl_boxes, peaks)
        iou, ink = evaluate_alignment(fx["gt_boxes"], d["syl_boxes"],
                                      eval_img)
        scores.append((iou, ink))
        print(f"{ind}: bbox IoU {iou:.3f}  ink IoU {ink:.3f} "
              f"({len(d['syl_boxes'])} syllables)")
    if not scores:
        print("no folios evaluated (all skipped)")
        return 1
    mi = float(np.mean([s[0] for s in scores]))
    mk = float(np.mean([s[1] for s in scores]))
    print(f"mean: bbox IoU {mi:.3f}  ink IoU {mk:.3f}")
    return 0


def cmd_mei(args):
    """Enrich a raw MEI file with aligned syllable text + zones
    (writeToMEI.py:148-214 workflow as a real CLI)."""
    from .mei import add_text_to_mei_file, charboxes_to_tuples, parse_mei
    from .pipeline import process
    from .textio import read_file

    transcript = read_file(args.transcript)
    raw_image = _load_image(args.image)
    with open(args.mei) as f:
        tree = parse_mei(f.read())

    result = process(
        raw_image, transcript, ocropus_model=args.model,
        existing_ocr_pickle=args.ocr_pickle, backend=args.backend,
        verbose=args.verbose, device=args.device)
    if result is None:
        print("alignment produced no syllables; MEI left unmodified")
        return 1
    syl_boxes, _, lines_peak_locs, _ = result
    med_line_spacing = (
        float(np.quantile(np.diff(lines_peak_locs), 0.75))
        if len(lines_peak_locs) >= 2 else 0.0)

    tree, all_bboxes, _ = add_text_to_mei_file(
        tree, charboxes_to_tuples(syl_boxes), med_line_spacing)
    tree.write(args.out)
    print("wrote {}".format(args.out))

    if args.overlay:
        from .pipeline.render import draw_boxes_on_page

        draw_boxes_on_page(raw_image, all_bboxes, args.overlay)
        print("wrote {}".format(args.overlay))
    return 0


def cmd_train(args):
    from .models import vgsl
    from .models.codec import Codec
    from .models.lineest_host import CenterNormalizer, normalize_strip
    from .models.train import Trainer, VGSLTrainer, batch_lines

    kraken = args.network == "kraken"

    # fail on a missing checkpoint dir BEFORE the training run, not at the
    # first save
    out_dir = os.path.dirname(args.output_prefix)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    # line images + ground-truth text files, ocropus-rtrain style pairing:
    # X.png with X.gt.txt
    pairs = []
    for fn in sorted(os.listdir(args.lines_dir)):
        if not fn.endswith(".png"):
            continue
        gt = os.path.join(args.lines_dir, fn[:-4] + ".gt.txt")
        if not os.path.isfile(gt):
            continue
        pairs.append((os.path.join(args.lines_dir, fn), gt))
    if not pairs:
        print("no training pairs found in", args.lines_dir)
        return 1

    charset = [""] + ["~", " "]
    texts = []
    frames = []
    for img_path, gt_path in pairs:
        with open(gt_path) as f:
            text = f.read().strip()
        if not text:
            # defense in depth vs gtedit.extract's empty-row skip: a
            # hand-made empty gt file must not become an
            # empty-transcription CTC pair that degrades the model
            print(f"skipping {img_path}: empty ground truth")
            continue
        norm = normalize_strip(_load_image(img_path), CenterNormalizer(
            vgsl.HEIGHT if kraken else 48))
        if norm is None:
            continue
        frames.append(norm[0])
        texts.append(text)
        for ch in text:
            if ch not in charset:
                charset.append(ch)

    if args.resume:
        trainer = (VGSLTrainer if kraken else Trainer).load_state(
            args.resume, device=args.device)
        codec = trainer.codec
        missing = sorted(set(charset) - set(codec.charset))
        if missing:
            print(f"training data contains characters absent from the "
                  f"checkpoint charset: {missing!r}")
            return 1
        if args.lr != trainer.lr or (not kraken and args.hidden
                                     != trainer.ns):
            print(f"note: --hidden/--lr ignored on resume; continuing with "
                  f"the checkpoint's widths and lr={trainer.lr}")
        print(f"resumed at iteration {trainer.iteration} from {args.resume}")
    else:
        codec = Codec(charset)
        trainer = (VGSLTrainer(codec, lr=args.lr, device=args.device)
                   if kraken else
                   Trainer(codec, ni=48, ns=args.hidden, lr=args.lr,
                           device=args.device))

    rng = np.random.default_rng(0)
    T = max(len(f) for f in frames)
    S = max(len(t) for t in texts) + 2
    idx = np.arange(len(frames))
    if args.resume and trainer.iteration:
        # continue the batch-sampling RNG exactly where the original run
        # left off. Checkpoints store the bit-generator state (exact even
        # across CHAINED resumes at different --batch-size values); old
        # checkpoints without it fall back to replaying the draw stream
        # at the ORIGINAL run's batch size — each draw consumes a
        # batch-size-dependent amount of the Generator stream, so a
        # single-resume replay must use the saved size (and a chain of
        # mixed-size resumes is only exact via the stored state).
        extra = getattr(trainer, "loaded_extra", {})
        if "rng_state" in extra:
            rng.bit_generator.state = extra["rng_state"]
        else:
            saved_bs = extra.get("batch_size", args.batch_size)
            if saved_bs != args.batch_size:
                print(f"note: checkpoint was trained with --batch-size "
                      f"{saved_bs}; replaying its draw stream at that size "
                      f"(new iterations use --batch-size "
                      f"{args.batch_size})")
            for _ in range(trainer.iteration):
                rng.choice(idx, size=min(saved_bs, len(idx)), replace=False)
    for it in range(args.iterations):
        batch = rng.choice(idx, size=min(args.batch_size, len(idx)),
                           replace=False)
        xs, xl, lb, ll = batch_lines(
            [frames[i] for i in batch], [texts[i] for i in batch],
            codec, T=T, S=S,
        )
        loss = trainer.step(xs, xl, lb, ll)
        if it % args.log_every == 0:
            print(f"iter {it}: ctc loss {loss:.4f}")
        if args.save_every and it > 0 and it % args.save_every == 0:
            print("saved", trainer.save(args.output_prefix))
            print("saved", trainer.save_state(
                args.output_prefix + ".state",
                extra={"batch_size": args.batch_size,
                       "rng_state": rng.bit_generator.state}))

    print("saved", trainer.save(args.output_prefix))
    print("saved", trainer.save_state(
                args.output_prefix + ".state",
                extra={"batch_size": args.batch_size,
                       "rng_state": rng.bit_generator.state}))
    return 0


def cmd_lines(args):
    from .align.api import resolve_device
    from .gtedit import extract_lines
    from .pipeline.preprocess import PreprocParams

    # the crops are cut on the host, the raster runs on the device with
    # --backend device; the device is resolved all the same, as every
    # subcommand's is (no card and no --device cpu: it raises)
    device = resolve_device(args.device)
    pp = (PreprocParams(filter_size=args.filter_size)
          if args.filter_size else None)
    total = 0
    for page in args.pages:
        stem = os.path.splitext(os.path.basename(page))[0]
        paths = extract_lines(_load_image(page), args.out_dir, stem,
                              backend=args.backend, preproc_params=pp,
                              device=device)
        print(f"{page}: {len(paths)} line crop(s) -> {args.out_dir}")
        total += len(paths)
    if total == 0:
        print("no text lines detected")
        return 1
    return 0


def cmd_gtedit(args):
    from . import gtedit
    from .align.api import resolve_device

    device = resolve_device(args.device)
    if args.gtedit_cmd == "html":
        rec = None
        if args.model:
            from .pipeline.process import _resolve_recognizer

            rec = _resolve_recognizer(args.model, args.backend, device)
        n = gtedit.make_html(args.lines_dir, args.out, recognizer=rec)
        print(f"wrote {args.out} ({n} line(s))")
        return 0 if n else 1
    n = gtedit.extract(args.saved, args.out_dir)
    print(f"wrote {n} .gt.txt file(s) -> {args.out_dir}")
    return 0 if n else 1


def cmd_serve(args):
    from .serve import serve

    stats = serve(args.spool, args.model, backend=args.backend,
                  poll_s=args.poll, once=args.once, max_jobs=args.max_jobs,
                  verbose=args.verbose, do_warmup=args.warmup,
                  batch=args.batch, device=args.device)
    print(f"processed {stats.processed} job(s), {stats.failed} failed")
    return 0 if stats.failed == 0 else 1


def cmd_verify_reference(args):
    """Real-asset parity harness: run a reference checkout end-to-end and
    report JSON/GT parity (verify_reference module)."""
    from .verify_reference import verify

    rep = verify(args.assets, manuscript=args.manuscript,
                 folios=args.folios, backend=args.backend,
                 reuse_ocr=not args.no_reuse_ocr, device=args.device)
    d = rep.to_dict()
    print("match {match}  mismatch {mismatch}  no-reference "
          "{no_reference}  error {error}".format(**d["summary"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(d, f, indent=2)
        print("wrote", args.out)
    return 1 if (d["summary"]["mismatch"] or d["summary"]["error"]) else 0


def _device_arg(parser, what):
    parser.add_argument(
        "--device", default="cuda",
        help=f"torch device of {what}: cuda (default; it fails without a "
             "card) or cpu")


def main(argv=None):
    p = argparse.ArgumentParser(prog="text_alignment_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("align", help="align transcripts to manuscript pages")
    a.add_argument("--csv", required=True)
    a.add_argument("--mapping", default=None)
    a.add_argument("--manuscript", required=True)
    a.add_argument("--model", required=True)
    a.add_argument("--png-dir", default="./png")
    a.add_argument("--out-json", default="./out_json")
    a.add_argument("--pickle-dir", default=None)
    a.add_argument("--out-imgs", default=None)
    a.add_argument("--folios", nargs="+", required=True)
    a.add_argument("--backend", default="hybrid",
                   choices=["host", "hybrid", "device"])
    _device_arg(a, "the OCR, the device raster and the device NW fill")
    a.add_argument("--cache-dir", default=None,
                   help="content-addressed stage cache directory")
    a.add_argument("--reuse-ocr", action="store_true")
    a.add_argument("--batch", type=int, default=0,
                   help="folios per batched-pipeline call (process_batch); "
                        "0 or 1: the sequential loop")
    a.add_argument("--timing", action="store_true")
    a.add_argument("--no-strict", dest="strict", action="store_false",
                   help="fix the documented reference defects instead of "
                        "preserving them (see PARITY.md)")
    a.add_argument("--verbose", action="store_true")
    a.set_defaults(func=cmd_align)

    e = sub.add_parser("evaluate", help="IoU evaluation + scoring grid search")
    e.add_argument("--csv", required=True)
    e.add_argument("--mapping", default=None)
    e.add_argument("--manuscript", required=True)
    e.add_argument("--png-dir", default="./png")
    e.add_argument("--pickle-dir", default="./pik")
    e.add_argument("--gt-dir", default="./ground-truth-alignments")
    e.add_argument("--folios", nargs="+", required=True)
    e.add_argument("--backend", default="host",
                   choices=["host", "hybrid", "device"])
    _device_arg(e, "the grid's batched NW fill, the device raster and "
                "process()")
    e.add_argument("--grid", action="store_true",
                   help="run the 729-combination scoring grid search "
                   "instead of a single-scoring evaluation")
    e.add_argument("--scoring", default=None,
                   help='JSON scoring list, e.g. "[8,-4,-7,-7,-3,0]" '
                   "(single-scoring mode only)")
    e.set_defaults(func=cmd_evaluate)

    vr = sub.add_parser(
        "verify-reference",
        help="run a real reference checkout (png/ csv/ pik/ models/ "
             "out_json/ ground-truth-alignments/) end-to-end and emit a "
             "parity report vs its out_json + GT XML")
    vr.add_argument("--assets", required=True,
                    help="path to the reference checkout")
    vr.add_argument("--manuscript", default=None,
                    choices=["salzinnes", "einsiedeln", "stgall390",
                             "stmaurf"])
    vr.add_argument("--folios", nargs="+", default=None,
                    help="restrict to these folio fnames (as in the png "
                         "filenames)")
    vr.add_argument("--backend", default="hybrid",
                    choices=["host", "hybrid", "device"])
    _device_arg(vr, "the OCR, the device raster and the device NW fill")
    vr.add_argument("--no-reuse-ocr", action="store_true",
                    help="ignore pik/ caches and run the recognizer from "
                         "the .pyrnn.gz model (full-stack parity)")
    vr.add_argument("--out", default=None, help="write the report JSON")
    vr.set_defaults(func=cmd_verify_reference)

    m = sub.add_parser(
        "mei", help="enrich a raw MEI file with aligned syllable text")
    m.add_argument("--transcript", required=True)
    m.add_argument("--image", required=True, help="text layer PNG")
    m.add_argument("--mei", required=True, help="raw MEI input")
    m.add_argument("--out", required=True, help="enriched MEI output path")
    m.add_argument("--model", default=None)
    m.add_argument("--ocr-pickle", default=None)
    m.add_argument("--overlay", default=None, help="debug overlay PNG path")
    m.add_argument("--backend", default="hybrid",
                   choices=["host", "hybrid", "device"])
    _device_arg(m, "the OCR, the device raster and the device NW fill")
    m.add_argument("--verbose", action="store_true")
    m.set_defaults(func=cmd_mei)

    t = sub.add_parser("train", help="train a CTC line recognizer")
    t.add_argument("--lines-dir", required=True,
                   help="dir of X.png + X.gt.txt line pairs")
    t.add_argument("--output-prefix", default="./model")
    t.add_argument("--iterations", type=int, default=10000)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--network", default="ocropy",
                   choices=["ocropy", "kraken"],
                   help="ocropy's BiLSTM (48 rows, --hidden units) or "
                   "kraken's default VGSL network (RECOGNITION_SPEC at its "
                   "published widths, 120 rows; checkpoints *.vgsl.npz)")
    t.add_argument("--hidden", type=int, default=100,
                   help="the BiLSTM's units (ocropy's network only)")
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--save-every", type=int, default=5000)
    t.add_argument("--resume", default=None,
                   help="resume from a .state checkpoint of either package "
                   "(full optimizer state; exact trajectory continuation "
                   "when --lines-dir holds the same data; .state files are "
                   "pickle-free .npz archives, safe to load)")
    _device_arg(t, "the training step")
    t.set_defaults(func=cmd_train)

    li = sub.add_parser(
        "lines",
        help="segment pages into per-line training crops (the reference's "
        "'ocropus page segmentation' training step, README.md:52-56)")
    li.add_argument("pages", nargs="+", help="page image PNGs")
    li.add_argument("--out-dir", default="./lines")
    li.add_argument("--backend", default="host",
                    choices=["host", "hybrid", "device"])
    li.add_argument("--filter-size", type=int, default=0,
                    help="projection smoothing half-window override "
                    "(reference filter_size=30; smaller for low-res pages)")
    _device_arg(li, "the device raster (the crops are cut on the host)")
    li.set_defaults(func=cmd_lines)

    g = sub.add_parser(
        "gtedit",
        help="browser-based line-transcription correction round trip "
        "(the ocropus-gtedit equivalent, reference README.md:52-56)")
    gsub = g.add_subparsers(dest="gtedit_cmd", required=True)
    gh = gsub.add_parser(
        "html", help="render line crops + editable transcriptions into one "
        "self-contained HTML page")
    gh.add_argument("--lines-dir", required=True,
                    help="dir of X.png line crops (+ optional X.gt.txt)")
    gh.add_argument("--out", default="correction.html")
    gh.add_argument("--model", default=None,
                    help=".pyrnn.gz recognizer to prefill missing "
                    "transcriptions by OCR")
    gh.add_argument("--backend", default="hybrid",
                    choices=["host", "hybrid", "device"])
    _device_arg(gh, "the --model prefill's OCR")
    gh.set_defaults(func=cmd_gtedit)
    ge = gsub.add_parser(
        "extract", help="write X.gt.txt ground truth from a saved "
        "correction page or downloaded corrections.tsv")
    ge.add_argument("saved", help="saved HTML or corrections.tsv")
    ge.add_argument("--out-dir", required=True,
                    help="where to write the .gt.txt files (usually the "
                    "lines dir)")
    _device_arg(ge, "the subcommand (extraction runs on the host)")
    ge.set_defaults(func=cmd_gtedit)

    s = sub.add_parser(
        "serve",
        help="spool-directory server: process *.job.json jobs with the "
        "model on the device and the kernels built (the Rodan job-queue "
        "analog)")
    s.add_argument("--spool", required=True, help="job spool directory")
    s.add_argument("--model", help=".pyrnn.gz recognizer checkpoint")
    s.add_argument("--backend", default="hybrid",
                   choices=["host", "hybrid", "device"])
    _device_arg(s, "the OCR, the device raster and the device NW fill")
    s.add_argument("--poll", type=float, default=0.2,
                   help="idle poll interval, seconds")
    s.add_argument("--once", action="store_true",
                   help="drain pending jobs and exit")
    s.add_argument("--max-jobs", type=int, default=None)
    s.add_argument("--batch", type=int, default=1,
                   help="drain up to N pending jobs per sweep through the "
                   "batched pipeline; 1 = one job at a time")
    s.add_argument("--warmup", action="store_true",
                   help="build the kernels and run a synthetic folio "
                   "before accepting jobs")
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(func=cmd_serve)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
