"""Command-line entry point of the port: the sequential ``align`` workflow.

Usage:
    python -m text_alignment_tpu_torch align --csv chants.csv \\
        --manuscript salzinnes --model model.pyrnn.gz \\
        --png-dir ./png --out-json ./out_json --folios 60 61 --device cuda

Counterpart of ``text_alignment_tpu/cli.py``'s ``align``: the folio-at-a-
time loop, and with ``--batch N`` the stage-major batched pipeline
(``parallel.batch.process_batch``, N folios per call; set
``TEXT_ALIGNMENT_TPU_RASTER=device`` to run its raster on the card). The
card is the default device; ``--device cpu`` runs on the CPU. The other
subcommands and ``--cache-dir`` are not ported yet (ROADMAP queue A).
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
            strict=args.strict, device=args.device)
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
    a.add_argument("--backend", default="hybrid", choices=["host", "hybrid"])
    a.add_argument("--device", default="cuda",
                   help="torch device of the OCR, the device raster and the "
                        "device NW fill: cuda (default; it fails without a "
                        "card) or cpu")
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

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
