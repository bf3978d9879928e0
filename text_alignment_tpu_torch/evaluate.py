"""The scoring-parameter grid search over evaluation fixtures, on the port.

Counterpart of ``text_alignment_tpu/evaluate.py``'s ``grid_search``: the
729-combination scoring grid (``scoring_grid``) runs every fixture through
the port's ``process()`` once per combination, with the raster stages and
the OCR stream injected, so only NW and assembly rerun. The metrics
(``evaluate_alignment``, ``parse_gt_xml``) are the JAX package's host code,
reached through ``_reuse``.
"""

from __future__ import annotations

import numpy as np

from ._reuse import (
    evaluate_alignment,
    expand_abbreviations,
    identify_text_lines,
    preprocess_images,
    scoring_grid,
)
from .align.api import align_grid, resolve_device

# "auto" sends a fixture's whole grid to the batched device fill from this
# many transcript x OCR cells: the JAX package's rule for its kernel route
# (text_alignment_tpu/evaluate.py), kept as it is.
GRID_DEVICE_MIN_CELLS = 40_000


def grid_search(fixtures, shuffle=True, seed=None, backend="host",
                verbose=True, params_list=None, grid_align="auto",
                device=None):
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
    ``GRID_DEVICE_MIN_CELLS`` cells. ``device`` (None: the card when there
    is one) also runs ``process()``'s own stages.

    Returns (logs, ranked): {params tuple: mean ink-IoU} and its items
    sorted ascending, like the reference's __main__.
    """
    from .pipeline import process, to_JSON_dict

    device = resolve_device(device)
    if params_list is None:
        params_list = scoring_grid()
    params_list = np.asarray(params_list)
    if shuffle:
        np.random.default_rng(seed).shuffle(params_list)

    # the raster stages do not depend on the scoring: run them once per
    # fixture (the evaluation image without deskew, as the reference does)
    prepared = []
    for fx in fixtures:
        eval_img, _, _ = preprocess_images(
            fx["raw_image"], correct_rotation=False, backend=backend)
        pre = fx.get("existing_preproc_images")
        if pre is None:
            pre = preprocess_images(fx["raw_image"], backend=backend,
                                    params=fx.get("preproc_params"))
        image, eroded, _ = pre
        strips, peaks, _ = identify_text_lines(
            image, eroded, backend=backend, verbose=False,
            params=fx.get("preproc_params"))

        # the OCR stream process() aligns: the abbreviation-expanded chars
        grid_aligns = None
        chars = expand_abbreviations(list(fx["existing_ocr"]))
        ocr = "".join(c.char for c in chars)
        cells = len(fx["transcript"]) * len(ocr)
        if grid_align == "device" or (
                grid_align == "auto" and device.type == "cuda"
                and cells >= GRID_DEVICE_MIN_CELLS):
            grid_aligns = align_grid(list(fx["transcript"]), list(ocr),
                                     params_list, device)
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
