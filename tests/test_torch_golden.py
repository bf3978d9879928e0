"""The port's process() against the golden JSON files of tests/golden/ on
the CPU: the end-to-end snapshot (``e2e_syn31.json``, the fixture of
tests/test_pipeline.py::test_end_to_end_golden_json) and the six
adversarial fixtures of tests/test_adversarial.py (``adv_*.json``) with
their host == hybrid engine parity, and that module's boundary cases
(skew at the search limits, touching lines, the empty page, the
saturated-CC and noise-area thresholds) on the host and hybrid engines.
The bar is JSON equal to the golden file, or the reference's decision at
the boundary. Every fixture injects its OCR, so no weights are needed.
``backend="device"`` (``ops/device.py``: the CC kernels' plain versions
here) runs every case as well, on the CPU device.

The pages are made by the port's own copy of ``synth``, so this module
imports no JAX: tests/test_torch_cuda.py imports its fixtures for the card
twins."""

import json
import os

import numpy as np
import pytest

from text_alignment_tpu_torch.pipeline import process, to_JSON_dict
from text_alignment_tpu_torch.pipeline.preprocess import (
    PreprocParams, identify_text_lines, preprocess_images)
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PARAMS = PreprocParams(filter_size=8)


def _page_ocr(page, seed=9):
    return ocr_with_spaces(corrupt_ocr(np.random.default_rng(seed),
                                       page.char_boxes))


def fixture_e2e():
    page = make_page(np.random.default_rng(31), n_lines=5, words_per_line=2,
                     H=900, W=800, char_h=50, char_w=30, gap=6, space_w=40,
                     line_spacing=150, speckles=25, margin_x=30, angle=0.7)
    return page, page.transcript, _page_ocr(page)


def fixture_skew(sign):
    page = make_page(np.random.default_rng(41), n_lines=4, words_per_line=2,
                     H=900, W=800, char_h=40, char_w=24, gap=5, space_w=30,
                     line_spacing=170, speckles=15, margin_x=120,
                     angle=sign * 5.9)
    return page, page.transcript, _page_ocr(page)


def fixture_touching_lines():
    page = make_page(np.random.default_rng(43), n_lines=3, words_per_line=3,
                     H=400, W=800, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=60, speckles=10, margin_x=40, angle=0.0)
    img = page.image
    for li in range(2):  # bridge line li -> li+1
        y0 = 50 + li * 60
        x = 300 + 150 * li
        img[y0: y0 + 60 + 30, x: x + 3] = 0
    return page, page.transcript, _page_ocr(page)


def _fixture_one_line():
    page = make_page(np.random.default_rng(44), n_lines=1, words_per_line=3,
                     H=300, W=800, char_h=36, char_w=20, gap=4, space_w=28,
                     speckles=10, margin_x=40)
    return page, page.transcript, _page_ocr(page)


def _fixture_transcript_gg_ocr():
    page = make_page(np.random.default_rng(45), n_lines=5, words_per_line=3,
                     H=800, W=800, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=140, speckles=10, margin_x=40)
    first_line_y = min(cb.uly for cb in page.char_boxes)
    ocr = [cb for cb in _page_ocr(page) if cb.uly == first_line_y]
    return page, page.transcript, ocr


def _fixture_ocr_gg_transcript():
    page = make_page(np.random.default_rng(46), n_lines=5, words_per_line=3,
                     H=800, W=800, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=140, speckles=10, margin_x=40)
    short = " ".join(page.transcript.split()[:3])
    return page, short, _page_ocr(page)


# golden file -> (fixture, preprocessing parameters of its test)
GOLDEN = {
    "e2e_syn31": (fixture_e2e, None),
    "adv_skew_pos_limit": (lambda: fixture_skew(+1), PARAMS),
    "adv_skew_neg_limit": (lambda: fixture_skew(-1), PARAMS),
    "adv_touching_lines": (fixture_touching_lines, PARAMS),
    "adv_one_line": (_fixture_one_line, PARAMS),
    "adv_transcript_gg_ocr": (_fixture_transcript_gg_ocr, PARAMS),
    "adv_ocr_gg_transcript": (_fixture_ocr_gg_transcript, PARAMS),
}


def golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        return json.load(f)


def run_golden(name, backend, device):
    """process() on one golden fixture; its JSON dict, or None."""
    make, params = GOLDEN[name]
    page, transcript, ocr = make()
    res = process(page.image, transcript, existing_ocr=ocr, backend=backend,
                  verbose=False, preproc_params=params, device=device)
    if res is None:
        return None
    return to_JSON_dict(res[0], res[2])


BACKENDS = ["host", "hybrid", "device"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_end_to_end_golden_json(backend):
    assert run_golden("e2e_syn31", backend, "cpu") == golden("e2e_syn31")


@pytest.mark.parametrize("name", sorted(n for n in GOLDEN
                                        if n.startswith("adv_")))
def test_adversarial_golden_and_engine_parity(name):
    got_host = run_golden(name, "host", "cpu")
    got_hybrid = run_golden(name, "hybrid", "cpu")
    assert got_host == got_hybrid, f"{name}: host vs hybrid diverged"
    assert got_host == golden(name), f"{name}: golden drift"
    if name != "adv_transcript_gg_ocr":
        assert got_host is not None and got_host["syl_boxes"], \
            f"{name}: vacuous fixture"


@pytest.mark.parametrize("name", sorted(n for n in GOLDEN
                                        if n.startswith("adv_")))
def test_adversarial_golden_on_the_device_backend(name):
    assert run_golden(name, "device", "cpu") == golden(name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_skew_limit_detection(backend):
    """The coarse-to-fine search recovers corrective angles at the +-6 deg
    search boundary (textAlignPreprocessing.py:183 range)."""
    for sign in (+1, -1):
        page, _, _ = fixture_skew(sign)
        _, _, angle = preprocess_images(page.image, backend=backend,
                                        device="cpu")
        assert abs(angle - (-sign * 5.9)) < 0.5, (sign, angle)


@pytest.mark.parametrize("backend", BACKENDS)
def test_touching_lines_separator_cut(backend):
    """The bridged lines must still give one strip per text line."""
    page, _, _ = fixture_touching_lines()
    image, eroded, _ = preprocess_images(page.image, backend=backend,
                                         device="cpu")
    strips, peaks, _ = identify_text_lines(image, eroded, backend=backend,
                                           params=PARAMS, device="cpu")
    assert len(peaks) == 3 and len(strips) == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_page_skips_folio(backend):
    """All-white page -> no lines -> empty OCR -> process returns None."""
    blank = np.full((400, 600, 3), 255, np.uint8)
    assert process(blank, "dominus deus", existing_ocr=[], backend=backend,
                   verbose=False, preproc_params=PARAMS,
                   device="cpu") is None


def sat_boundary_page():
    """A text line plus two bars straddling sat_area_thresh=150: the filter
    removes CCs spanning MORE than 150 rows (the reference's nrows-as-area
    quirk)."""
    page = make_page(np.random.default_rng(47), n_lines=2, words_per_line=2,
                     H=700, W=800, char_h=30, char_w=18, gap=4, space_w=24,
                     line_spacing=90, speckles=0, margin_x=40)
    img = page.image
    img[300:451, 100:103] = 0  # 151 rows: removed (151 > 150)
    img[300:450, 700:703] = 0  # 150 rows: kept
    return page


@pytest.mark.parametrize("backend", BACKENDS)
def test_sat_area_nrows_boundary(backend):
    image, _, _ = preprocess_images(sat_boundary_page().image,
                                    backend=backend, correct_rotation=False,
                                    device="cpu")
    image = np.asarray(image)
    assert not image[300:451, 100:103].any(), "151-row bar kept"
    assert image[300:450, 700:703].all(), "150-row bar removed"


def noise_boundary_page():
    """One text line plus two solid rectangles coinciding with it, of
    post-erosion areas 100 and 102: the line-stage noise filter keeps
    strictly-greater-than-100 only (textAlignPreprocessing.py:235)."""
    page = make_page(np.random.default_rng(48), n_lines=1, words_per_line=2,
                     H=300, W=800, char_h=30, char_w=18, gap=4, space_w=24,
                     speckles=0, margin_x=300)
    img = page.image
    y0 = 50  # the single line's top
    img[y0: y0 + 2, 20:70] = 0    # 2x50 = 100: dropped (not > 100)
    img[y0: y0 + 2, 730:781] = 0  # 2x51 = 102: kept
    return page


NOISE_PARAMS = PreprocParams(filter_size=8, despeckle_amt=20)


def check_noise_strips(strips):
    assert len(strips) == 1
    s = strips[0]
    assert s.offset_x + s.img.shape[1] - 1 >= 780, \
        "area-102 CC excluded from the strip"
    assert s.offset_x >= 100, "area-100 CC should have been dropped"


@pytest.mark.parametrize("backend", BACKENDS)
def test_noise_area_boundary(backend):
    image, eroded, _ = preprocess_images(noise_boundary_page().image,
                                         backend=backend, despeckle_amt=20,
                                         correct_rotation=False,
                                         device="cpu")
    strips, _, _ = identify_text_lines(image, eroded, backend=backend,
                                       params=NOISE_PARAMS, device="cpu")
    check_noise_strips(strips)
