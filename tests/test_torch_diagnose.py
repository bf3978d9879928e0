"""The port's ``evaluate.diagnose_alignment`` on the CPU: the JAX package's
two tests of it (tests/test_aux.py) on the port, and the port against
``text_alignment_tpu.evaluate.diagnose_alignment`` dict for dict on seeded
pages: perfect OCR, one syllable's characters deleted, one syllable's
boxes displaced a line down, a deskewed page scored through ``rotate_back``
(the angle from each package's ``preprocess_images``), ``strict=False``,
and a non-default row of ``scoring_grid()``. Host code on both sides, so
the bar is exact: the same ``categories``, ``counts`` and ``ocr_cer``."""

import numpy as np
import pytest

from text_alignment_tpu import evaluate as jax_evaluate
from text_alignment_tpu.charbox import CharBox as JaxCharBox
from text_alignment_tpu.pipeline.preprocess import (
    preprocess_images as jax_preprocess_images)
from text_alignment_tpu_torch.charbox import CharBox
from text_alignment_tpu_torch.evaluate import diagnose_alignment, scoring_grid
from text_alignment_tpu_torch.lang.syllabify import syllabify_text
from text_alignment_tpu_torch.pipeline.assemble import rotate_bboxes
from text_alignment_tpu_torch.pipeline.preprocess import preprocess_images
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

SEEDS = (41, 42, 43, 44)
CASES = ("perfect", "deleted", "displaced", "deskewed", "nonstrict",
         "grid_row")
LINE_SPACING = 120


def gt_boxes(page, chars):
    """GT syllable boxes: each syllable's characters' union, in reading
    order (the JAX test's construction)."""
    gt = []
    i = 0
    flat = [c for c in chars if c.char != " "]
    for s in syllabify_text(page.transcript):
        grp = flat[i: i + len(s)]
        i += len(s)
        gt.append({"syl": s, "difficult": 0,
                   "ul": (min(c.ul[0] for c in grp),
                          min(c.ul[1] for c in grp)),
                   "lr": (max(c.lr[0] for c in grp),
                          max(c.lr[1] for c in grp))})
    return gt


def victim_span(page, chars, seed):
    """(start, length) in ``chars`` of a syllable picked by the seed."""
    syls = syllabify_text(page.transcript)
    victim = syls[1 + seed % (len(syls) - 1)]
    return "".join(c.char for c in chars).find(victim), len(victim)


def case_inputs(case, seed):
    """(transcript, all_chars, gt_boxes, kwargs) of one parity case."""
    angle = 0.8 if case == "deskewed" else 0.0
    page = make_page(np.random.default_rng(seed), n_lines=3,
                     words_per_line=3, H=500, W=700, char_h=30, char_w=18,
                     gap=4, space_w=24, line_spacing=LINE_SPACING,
                     speckles=10, angle=angle)
    chars = ocr_with_spaces(page.char_boxes)
    gt = gt_boxes(page, chars)
    kw = {}
    if case == "deleted":
        idx, n = victim_span(page, chars, seed)
        chars = chars[:idx] + chars[idx + n:]
    elif case == "displaced":
        idx, n = victim_span(page, chars, seed)
        chars = [CharBox(c.char, (c.ul[0], c.ul[1] + LINE_SPACING),
                         (c.lr[0], c.lr[1] + LINE_SPACING))
                 if idx <= k < idx + n else c for k, c in enumerate(chars)]
    elif case == "deskewed":
        image, _, det = preprocess_images(page.image, backend="host")
        _, _, det_jax = jax_preprocess_images(page.image, backend="host")
        assert det == det_jax and det != 0.0
        raw_shape = page.image.shape[:2]
        chars = rotate_bboxes(chars, det, raw_shape, image.shape)
        kw["rotate_back"] = (det, image.shape, raw_shape)
    elif case in ("nonstrict", "grid_row"):
        chars = ocr_with_spaces(corrupt_ocr(np.random.default_rng(seed + 7),
                                            page.char_boxes, sub_rate=0.15,
                                            del_rate=0.08))
        if case == "nonstrict":
            kw["strict"] = False
        else:
            kw["seq_align_params"] = [int(v) for v in
                                      scoring_grid()[97 * seed % 729]]
    return page.transcript, chars, gt, kw


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_diagnose_matches_jax(seed, case):
    transcript, chars, gt, kw = case_inputs(case, seed)
    got = diagnose_alignment(transcript, chars, gt, **kw)
    want = jax_evaluate.diagnose_alignment(
        transcript, [JaxCharBox(c.char, c.ul, c.lr) for c in chars], gt,
        **kw)
    assert got == want
    assert type(got["ocr_cer"]) is float
    assert sum(got["counts"].values()) == len(got["categories"])
    if case == "perfect":
        assert got["counts"]["ok"] == len(gt)
    elif case == "deleted":
        assert got["counts"]["aligned-to-nothing"] >= 1
    elif case == "displaced":
        assert got["counts"]["wrong-line"] >= 1


def test_diagnose_alignment_classifies_failures():
    """evaluate.diagnose_alignment: perfect OCR -> all ok; deleting one
    syllable's characters from the OCR stream -> that syllable classified
    aligned-to-nothing; a syllable's boxes displaced a line down ->
    wrong-line."""
    page = make_page(np.random.default_rng(41), n_lines=3, words_per_line=2)
    chars = ocr_with_spaces(page.char_boxes)
    syls = syllabify_text(page.transcript)
    gt = gt_boxes(page, chars)

    d = diagnose_alignment(page.transcript, chars, gt)
    assert d["counts"]["ok"] == len(gt)
    assert d["ocr_cer"] < 0.05

    # delete the second syllable's characters from the OCR stream
    victim = syls[1]
    idx = "".join(c.char for c in chars).find(victim)
    mut = chars[:idx] + chars[idx + len(victim):]
    d2 = diagnose_alignment(page.transcript, mut, gt)
    assert d2["counts"]["aligned-to-nothing"] >= 1
    assert any(cat == "aligned-to-nothing" and syl == victim
               for syl, cat, _ in d2["categories"].values())

    # displace one syllable's boxes far down -> wrong-line
    moved = []
    for c in chars:
        if idx <= chars.index(c) < idx + len(victim):
            moved.append(CharBox(c.char, (c.ul[0], c.ul[1] + 400),
                                 (c.lr[0], c.lr[1] + 400)))
        else:
            moved.append(c)
    d3 = diagnose_alignment(page.transcript, moved, gt)
    assert d3["counts"]["wrong-line"] >= 1


def test_diagnose_alignment_metachar_and_unmatched():
    """A syllable with a regex metacharacter is escaped (no re.error), and
    a syllable absent from the aligned transcript classifies as no-match
    instead of raising."""
    transcript = "a(b zz"
    chars = [CharBox(c, (10 * i, 0), (10 * i + 9, 9))
             for i, c in enumerate("a(b")]
    gt = [{"syl": "a(b", "difficult": 0, "ul": (0, 0), "lr": (29, 9)}]
    d = diagnose_alignment(transcript, chars, gt)
    assert d["counts"]["ok"] + d["counts"]["boundary"] >= 1
    assert d["counts"].get("no-match", 0) + d["counts"]["no-gt"] >= 1
    assert d == jax_evaluate.diagnose_alignment(
        transcript, [JaxCharBox(c.char, c.ul, c.lr) for c in chars], gt)
