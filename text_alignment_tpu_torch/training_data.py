"""Training-data preparation: clean pages for OCR model training.

Reference semantics: clean_images_for_training.py:15-56 — a gentler
preprocess (small-CC removal by *area* before inversion despeckle, default
despeckle 25, run filter 1) plus a page-level routine that unions detected
line strips into a cleaned training image.
"""

from __future__ import annotations

import numpy as np

from .pipeline.preprocess import (
    _raster_engine,
    preprocess_images,
    identify_text_lines,
)


def clean_image(input_image, despeckle_amt: int = 25, filter_runs: int = 1,
                filter_runs_amt: int = 1, cc_min_size: int = 50,
                backend: str = "host"):
    """clean_images_for_training.py:15-40 equivalent. Returns (image, angle).

    ``backend="hybrid"`` runs the chain on the native C++ raster engine
    (bit-identical to the host oracle; parity pinned in test_aux.py)."""
    eng = _raster_engine(backend)
    img = eng.to_onebit(np.asarray(input_image))
    img = eng.remove_small_ccs(img, cc_min_size)
    img = ~eng.despeckle(~img, despeckle_amt)  # invert-despeckle-invert
    angle = eng.rotation_angle_projections(img)
    img = eng.rotate_onebit(img, angle)
    for _ in range(filter_runs):
        img = eng.filter_short_runs(img, filter_runs_amt, "black")
        img = eng.filter_narrow_runs(img, filter_runs_amt, "black")
    return img, angle


def union_line_strips(raw_image, backend: str = "host", preproc_params=None,
                      device=None):
    """Union detected line strips onto a blank page — the 'cleaned_*.png'
    output of clean_images_for_training.py:43-56. ``device``: the torch
    device of ``backend="device"`` (None: the card)."""
    image, eroded, _ = preprocess_images(
        np.asarray(raw_image), despeckle_amt=20, filter_runs=0,
        backend=backend, params=preproc_params, device=device,
    )
    strips, _, _ = identify_text_lines(image, eroded, backend=backend,
                                       params=preproc_params, device=device)
    out = np.zeros_like(image)
    for s in strips:
        h, w = s.img.shape
        out[s.offset_y : s.offset_y + h, s.offset_x : s.offset_x + w] |= s.img
    return out, strips
