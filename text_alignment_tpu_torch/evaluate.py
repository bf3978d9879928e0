"""The scoring-parameter grid search over evaluation fixtures, on the port.

Counterpart of ``text_alignment_tpu/evaluate.py``'s ``grid_search``: the
729-combination scoring grid (``scoring_grid``) runs every fixture through
the port's ``process()`` once per combination, with the raster stages and
the OCR stream injected, so only NW and assembly rerun. The metrics
(``evaluate_alignment``, ``parse_gt_xml``), the grid and the per-syllable
``diagnose_alignment`` are copies of the JAX package's host code.

Reference semantics: evaluate_text_alignment.py:16-198. Ground truth is
PASCAL-VOC-style XML per folio (``{fname}_gt.xml`` with
object/name/difficult/bndbox elements); predicted syl boxes are matched by
substring-compatible syllable text, best by raw intersection; scores are
bbox IoU and ink-pixel ("black area") IoU.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from itertools import product

import numpy as np

from .align.api import align_grid, resolve_device
from .ops import oracle
from .pipeline.assemble import expand_abbreviations
from .pipeline.preprocess import identify_text_lines, preprocess_images

def intersect(bb1, bb2):
    """Overlap area of two {'ul','lr'} boxes, or False
    (evaluate_text_alignment.py:16-31)."""
    lr1, ul1 = bb1["lr"], bb1["ul"]
    lr2, ul2 = bb2["lr"], bb2["ul"]
    dx = min(lr1[0], lr2[0]) - max(ul1[0], ul2[0])
    dy = min(lr1[1], lr2[1]) - max(ul1[1], ul2[1])
    if (dx > 0) and (dy > 0):
        return dx * dy
    return False


def IOU(bb1, bb2):
    """Bounding-box intersection over union (evaluate_text_alignment.py:34-53)."""
    lr1, ul1 = bb1["lr"], bb1["ul"]
    lr2, ul2 = bb2["lr"], bb2["ul"]
    new_ulx = max(ul1[0], ul2[0])
    new_uly = max(ul1[1], ul2[1])
    new_lrx = min(lr1[0], lr2[0])
    new_lry = min(lr1[1], lr2[1])
    area_int = (new_lrx - new_ulx) * (new_lry - new_uly)
    area_1 = (lr1[0] - ul1[0]) * (lr1[1] - ul1[1])
    area_2 = (lr2[0] - ul2[0]) * (lr2[1] - ul2[1])
    return float(area_int) / (area_1 + area_2 - area_int)


def black_area_IOU(bb1, bb2, image: np.ndarray):
    """Ink-pixel IoU over a binarized page (evaluate_text_alignment.py:56-76)."""
    lr1, ul1 = bb1["lr"], bb1["ul"]
    lr2, ul2 = bb2["lr"], bb2["ul"]
    new_ul = (max(ul1[0], ul2[0]), max(ul1[1], ul2[1]))
    new_lr = (min(lr1[0], lr2[0]), min(lr1[1], lr2[1]))

    bb1_black = oracle.black_area(oracle.subimage(image, ul1, lr1))
    bb2_black = oracle.black_area(oracle.subimage(image, ul2, lr2))
    intersect_black = oracle.black_area(oracle.subimage(image, new_ul, new_lr))

    denom = bb1_black + bb2_black - intersect_black
    if denom == 0:
        return 0.0
    return float(intersect_black) / denom


def parse_gt_xml(path: str) -> list[dict]:
    """PASCAL-VOC-ish ground truth boxes (evaluate_text_alignment.py:82-98)."""
    gt_xml = ET.parse(path)
    gt_boxes = []
    for el in list(gt_xml.getroot()):
        if not el.tag == "object":
            continue
        diff = int(el.find("difficult").text)
        name = el.find("name").text
        bb = el.find("bndbox")
        ul = (int(bb.find("xmin").text), int(bb.find("ymin").text))
        lr = (int(bb.find("xmax").text), int(bb.find("ymax").text))
        gt_boxes.append({"syl": name, "difficult": diff, "ul": ul, "lr": lr})
    return gt_boxes


def evaluate_alignment(gt_boxes, align_boxes, image: np.ndarray,
                       eval_difficult: bool = False):
    """Mean (bbox IoU, ink IoU) of predicted boxes against ground truth
    (evaluate_text_alignment.py:109-131). ``image`` is the binarized page
    (un-rotated — the reference preprocesses with correct_rotation=False)."""
    score = {}
    area_score = {}
    for box in gt_boxes:
        if box["difficult"] and not eval_difficult:
            continue
        same_syl_boxes = [
            x
            for x in align_boxes
            if x["syl"] in box["syl"] or box["syl"] in x["syl"]
        ]
        if not same_syl_boxes:
            score[box["syl"]] = 0
            area_score[box["syl"]] = 0
            continue
        ints = [intersect(box, x) for x in same_syl_boxes]
        if not any(ints):
            score[box["syl"]] = 0
            area_score[box["syl"]] = 0
            continue
        best_box = same_syl_boxes[ints.index(max(ints))]
        score[box["syl"]] = IOU(box, best_box)
        area_score[box["syl"]] = black_area_IOU(box, best_box, image)

    return (
        float(np.mean(list(score.values()))),
        float(np.mean(list(area_score.values()))),
    )


DEFAULT_GRID = (
    [5, 8, 11],
    [-4, -7, -10],
    [-2, -5, -7],
    [-2, -5, -7],
    [0, -3, -5],
    [0, -3, -5],
)


def diagnose_alignment(transcript, all_chars, gt_boxes,
                       seq_align_params=None, strict=True,
                       iou_thresh=0.25, rotate_back=None):
    """Per-syllable failure classification for an aligned page — the
    instrumented replay of the assembly walk (pipeline.assemble.
    group_syllables), answering WHERE each ground-truth syllable was
    lost: OCR (its characters aligned to gaps), alignment placement
    (boxes exist but land on the wrong line vs GT), or boundary error
    (right line, weak overlap).

    ``all_chars`` is the pipeline's post-abbreviation CharBox stream
    (process()'s all_chars return / the pik cache), ``gt_boxes`` the
    hand/synthetic GT dicts ({'syl', 'ul', 'lr'}). When the page was
    deskewed, ``all_chars`` live in the ROTATED frame while GT lives in
    the raw frame — pass ``rotate_back=(angle, rotated_shape,
    raw_shape)`` to apply the pipeline's own un-rotation
    (pipeline.assemble.rotate_bboxes) before comparing. Returns a dict:
    ``categories`` maps syllable index -> (syl, category, detail) with
    categories in {'ok', 'boundary', 'wrong-line', 'aligned-to-nothing',
    'no-gt'}, plus 'counts' and 'ocr_cer' (character error rate of the
    OCR stream measured through the same alignment)."""
    import re as _re

    from .align.api import perform_alignment
    from .charbox import CharBox
    from .lang.syllabify import syllabify_text

    ocr = "".join(c.char for c in all_chars)
    tra_align, ocr_align = perform_alignment(
        list(transcript), list(ocr), scoring_system=seq_align_params,
        backend="host", strict=strict)
    tra_align = "".join(tra_align)
    ocr_align = "".join(ocr_align)

    # OCR character error rate through the alignment: non-gap pairs that
    # mismatch + every gap on either side, over the transcript length
    errs = sum(1 for a, b in zip(tra_align, ocr_align)
               if a != b)
    cer = errs / max(1, len(transcript))

    chars = list(all_chars)
    for i, ch in enumerate(ocr_align):
        if ch == "_":
            chars.insert(i, CharBox("_"))
    assert len(chars) == len(tra_align)

    # GT boxes by consumption order: match each syllable occurrence to the
    # next unused GT entry with the same text (GT is emitted in reading
    # order by both the reference harness and the synthetic generator)
    gt_pool = list(gt_boxes)

    def take_gt(syl):
        for k, g in enumerate(gt_pool):
            if g["syl"] == syl:
                return gt_pool.pop(k)
        return None

    categories = {}
    counts = {"ok": 0, "boundary": 0, "wrong-line": 0,
              "aligned-to-nothing": 0, "no-gt": 0, "no-match": 0}
    offset = 0
    for si, syl in enumerate(syllabify_text(transcript)):
        if len(syl) < 1:
            continue
        syl_regex = "_*".join(_re.escape(c) for c in syl)
        m = _re.search(syl_regex, tra_align[offset:])
        if m is None:
            categories[si] = (syl, "no-match",
                              "syllable absent from aligned transcript")
            counts["no-match"] += 1
            continue
        start = m.start() + offset
        end = m.end() + offset
        offset = end
        boxes = [x for x in chars[start:end] if x.lr is not None]
        gt = take_gt(syl)
        if gt is None:
            categories[si] = (syl, "no-gt", "")
            counts["no-gt"] += 1
            continue
        if not boxes:
            n_gap = ocr_align[start:end].count("_")
            categories[si] = (syl, "aligned-to-nothing",
                              f"{n_gap}/{end - start} aligned chars are "
                              f"OCR gaps (chars lost by OCR)")
            counts["aligned-to-nothing"] += 1
            continue
        if len(set(x.uly for x in boxes)) > 1:
            lower = max(x.uly for x in boxes)
            boxes = [b for b in boxes if b.uly == lower]
        pred_cb = CharBox(
            syl,
            (min(x.ulx for x in boxes), min(x.uly for x in boxes)),
            (max(x.lrx for x in boxes), max(x.lry for x in boxes)),
        )
        if rotate_back is not None:
            from .pipeline.assemble import rotate_bboxes

            angle, rot_shape, raw_shape = rotate_back
            pred_cb = rotate_bboxes([pred_cb], -1 * angle, rot_shape,
                                    raw_shape)[0]
        pred = {"ul": pred_cb.ul, "lr": pred_cb.lr}
        gt_bb = {"ul": tuple(gt["ul"]), "lr": tuple(gt["lr"])}
        v = IOU(pred, gt_bb)
        if v >= iou_thresh:
            categories[si] = (syl, "ok", f"IoU {v:.2f}")
            counts["ok"] += 1
        else:
            gh = gt_bb["lr"][1] - gt_bb["ul"][1] + 1
            dy = abs(pred["ul"][1] - gt_bb["ul"][1])
            if dy > gh:
                categories[si] = (
                    syl, "wrong-line",
                    f"pred y {pred['ul'][1]} vs GT {gt_bb['ul'][1]}")
                counts["wrong-line"] += 1
            else:
                categories[si] = (syl, "boundary", f"IoU {v:.2f}")
                counts["boundary"] += 1
    return {"categories": categories, "counts": counts, "ocr_cer": cer}


def scoring_grid(grid=DEFAULT_GRID) -> np.ndarray:
    """The 729-combination scoring grid (evaluate_text_alignment.py:181-189)."""
    return np.array(list(product(*grid)))


# "auto" sends a fixture's whole grid to the batched device fill from this
# many transcript x OCR cells: the JAX package's rule for its kernel route
# (text_alignment_tpu/evaluate.py), kept as it is.
GRID_DEVICE_MIN_CELLS = 40_000


def grid_search(fixtures, shuffle=True, seed=None, backend="host",
                verbose=True, params_list=None, grid_align="auto",
                device=None, mesh=None):
    """Grid-search scoring parameters over evaluation fixtures.

    ``fixtures`` is a list of dicts with keys raw_image (np array),
    transcript (str), gt_boxes (list), existing_ocr (list[CharBox]) and
    optionally preproc_params and existing_preproc_images.

    ``grid_align`` selects how the alignments are computed: "device"
    aligns ALL combinations of a fixture in batched launches on ``device``
    (:func:`.align.api.align_grid`; on a CPU device its plain versions) and
    injects each combination's result into ``process()``; "host" leaves NW
    to each ``process()`` call; "auto" (default) takes the device batch
    when ``device`` is a card and the fixture's pair has at least
    ``GRID_DEVICE_MIN_CELLS`` cells. ``device`` (None: the card; it raises
    when there is none) also runs ``process()``'s own stages. ``mesh``
    shards each fixture's grid over the ranks of the mesh's ``data`` axis
    (:func:`.align.api.align_grid`), each rank on its own device (then
    ``device``, None: this rank's); with a mesh, "auto" takes the device
    batch for every fixture, and "host", which would leave the mesh
    unused, raises. Under a mesh every rank takes rank 0's shuffled order
    (each rank draws its own), so the rows the ranks share are the same
    rows in the same order.

    Returns (logs, ranked): {params tuple: mean ink-IoU} and its items
    sorted ascending, like the reference's __main__.
    """
    from .pipeline import process, to_JSON_dict

    if mesh is not None:
        from .parallel.mesh import mesh_device

        device = mesh_device(mesh, device)
        if grid_align == "host":
            raise ValueError("grid_align='host' with a mesh: the mesh shards "
                             "the device grid, and the host route has none")
        grid_align = "device"
    device = resolve_device(device)
    if params_list is None:
        params_list = scoring_grid()
    params_list = np.asarray(params_list)
    if shuffle:
        np.random.default_rng(seed).shuffle(params_list)
    if mesh is not None:  # rank 0's order on every rank
        import torch.distributed as dist

        box = [params_list]
        dist.broadcast_object_list(box, src=0)
        params_list = box[0]

    # the raster stages do not depend on the scoring: run them once per
    # fixture (the evaluation image without deskew, as the reference does)
    prepared = []
    for fx in fixtures:
        eval_img, _, _ = preprocess_images(
            fx["raw_image"], correct_rotation=False, backend=backend,
            device=device)
        pre = fx.get("existing_preproc_images")
        if pre is None:
            pre = preprocess_images(fx["raw_image"], backend=backend,
                                    params=fx.get("preproc_params"),
                                    device=device)
        image, eroded, _ = pre
        strips, peaks, _ = identify_text_lines(
            image, eroded, backend=backend, verbose=False,
            params=fx.get("preproc_params"), device=device)

        # the OCR stream process() aligns: the abbreviation-expanded chars
        grid_aligns = None
        chars = expand_abbreviations(list(fx["existing_ocr"]))
        ocr = "".join(c.char for c in chars)
        cells = len(fx["transcript"]) * len(ocr)
        if grid_align == "device" or (
                grid_align == "auto" and device.type == "cuda"
                and cells >= GRID_DEVICE_MIN_CELLS):
            grid_aligns = align_grid(list(fx["transcript"]), list(ocr),
                                     params_list, device, mesh)
        elif grid_align not in ("auto", "host"):
            raise ValueError(f"unknown grid_align {grid_align!r}")
        prepared.append((fx, pre, eval_img, (strips, peaks), grid_aligns))

    logs = {}
    for pi, p in enumerate(params_list):
        results = []
        for fx, pre, eval_img, lines, grid_aligns in prepared:
            syl_boxes, _, peaks, _ = process(
                fx["raw_image"], fx["transcript"],
                seq_align_params=list(p),
                existing_ocr=fx["existing_ocr"],
                existing_preproc_images=pre,
                existing_lines=lines,
                preproc_params=fx.get("preproc_params"),
                verbose=False, backend=backend, device=device,
                existing_alignment=(None if grid_aligns is None
                                    else grid_aligns[pi]))
            json_dict = to_JSON_dict(syl_boxes, peaks)
            results.append(evaluate_alignment(
                fx["gt_boxes"], json_dict["syl_boxes"], eval_img)[1])
        key = tuple(int(v) for v in p)
        logs[key] = float(np.mean(results))
        if verbose:
            print(p, logs[key])

    ranked = sorted(logs.items(), key=lambda kv: kv[1])
    return logs, ranked
