"""Synthetic manuscript-page generator: a frozen copy of the port's
``synth`` module, the generator of the benchmark's pages and OCR streams.

The reference's data (png pages, CANTUS CSVs, trained pyrnn models) is not
distributable with this repo (SURVEY.md §0: large blobs stripped, data dirs
gitignored), so fixtures are generated: pages with glyph-like ink laid out
in text lines at known positions, optional skew, speckle noise, and matching
ground-truth OCR character streams for stage-injection tests (the
generalization of the reference's OCR-pickle trick, alignToOCR.py:225-233).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..reference.charbox import CharBox


@dataclass
class SynthPage:
    image: np.ndarray            # uint8 RGB (H, W, 3), white bg / black ink
    transcript: str              # space-separated lowercase words
    char_boxes: list = field(default_factory=list)  # CharBox ground truth
    line_baselines: list = field(default_factory=list)
    angle: float = 0.0           # applied skew, degrees


def _glyph(rng, h, w):
    """A dense glyph-like blob that binarizes to one connected component."""
    g = np.zeros((h, w), dtype=bool)
    g[:, : max(1, w // 3)] = True  # vertical stem
    g[h // 2 : h // 2 + max(2, h // 4), :] = True  # crossbar
    extra = rng.random((h, w)) < 0.35
    g |= extra
    # connect: dilate-ish by or-ing shifts
    g[1:] |= g[:-1]
    g[:, 1:] |= g[:, :-1]
    return g


def make_page(rng=None, n_lines: int = 6, words_per_line: int = 4,
              H: int = 560, W: int = 800, char_h: int = 18, char_w: int = 11,
              gap: int = 3, space_w: int = 18, angle: float = 0.0,
              speckles: int = 60, margin_x: int = 40,
              line_spacing: int | None = None,
              vocabulary=("dominus", "deus", "alleluia", "sanctus", "gloria",
                          "kyrie", "angelus", "maria", "in", "excelsis",
                          "benedictus", "magnificat")) -> SynthPage:
    """Render a synthetic text page. Ground-truth char boxes are in the
    *unrotated* page frame when angle == 0 (tests inject OCR at that stage)."""
    rng = rng or np.random.default_rng(0)
    img = np.zeros((H, W), dtype=bool)
    spacing = line_spacing or (H - 100) // n_lines
    boxes: list[CharBox] = []
    baselines = []
    words_all = []

    for li in range(n_lines):
        y0 = 50 + li * spacing
        baselines.append(y0 + char_h // 2)
        x = margin_x + int(rng.integers(0, 30))
        line_words = [
            str(rng.choice(vocabulary)) for _ in range(words_per_line)
        ]
        for wi, word in enumerate(line_words):
            # keep transcript == rendered char stream: a word that would
            # hit the right margin is skipped entirely, so neither the page
            # nor the ground truth ever contains truncated fragments
            end_x = x + len(word) * (char_w + gap) - gap
            if end_x >= W - margin_x:
                continue
            for ch in word:
                # vertical jitter keeps projections from forming perfectly
                # flat plateaus (real ink never does; exactly-equal
                # prominences would trip the reference's flat-top dedup)
                jy = int(rng.integers(-2, 3))
                g = _glyph(rng, char_h, char_w)
                img[y0 + jy : y0 + jy + char_h, x : x + char_w] |= g
                # ground-truth boxes use line-constant y like real
                # strip-derived OCR boxes do (alignToOCR.py:160-173)
                boxes.append(CharBox(ch, (x, y0), (x + char_w, y0 + char_h)))
                x += char_w + gap
            words_all.append(word)
            x += space_w

    # speckle noise (small enough for despeckle to eat)
    for _ in range(speckles):
        y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
        img[y : y + 2, x : x + 2] = True

    if angle != 0.0:
        from .rotate import rotate_onebit

        img = rotate_onebit(img, angle)

    rgb = np.where(img[..., None], 0, 255).astype(np.uint8)
    rgb = np.repeat(rgb, 3, axis=2)
    transcript = " ".join(words_all)
    return SynthPage(rgb, transcript, boxes, baselines, angle)


def corrupt_ocr(rng, char_boxes, sub_rate=0.08, del_rate=0.03,
                alphabet="abcdefghijklmnopqrstuvwxyz"):
    """Simulate OCR errors over the ground-truth char stream: the aligner's
    job is to undo exactly this kind of damage (README.md:26-34)."""
    out = []
    for cb in char_boxes:
        r = rng.random()
        if r < del_rate:
            continue
        ch = cb.char
        if r < del_rate + sub_rate:
            ch = str(rng.choice(list(alphabet)))
        out.append(CharBox(ch, cb.ul, cb.lr))
    return out


def ocr_with_spaces(char_boxes, space_gap: int = 12):
    """Insert ' ' CharBoxes at word gaps, approximating how a real line
    recognizer emits spaces between words."""
    out = []
    prev = None
    for cb in char_boxes:
        if (
            prev is not None
            and cb.uly == prev.uly
            and cb.ulx - prev.lrx >= space_gap
        ):
            out.append(CharBox(" ", (prev.lrx, prev.uly), (cb.ulx, prev.lry)))
        elif prev is not None and cb.uly != prev.uly:
            out.append(CharBox(" ", (prev.lrx, prev.uly), (prev.lrx + 5, prev.lry)))
        out.append(cb)
        prev = cb
    return out
