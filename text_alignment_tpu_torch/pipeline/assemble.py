"""Alignment→syllable assembly: OCR box construction, abbreviation
expansion, gap insertion, syllable-regex grouping, box un-rotation.

Exact reference semantics: alignToOCR.py:90-125 (rotate_bbox), :153-184
(llocs -> CharBox), :248-268 (abbreviations), :270-330 (assembly).
"""

from __future__ import annotations

import re

import numpy as np

from ..charbox import CharBox
from ..textio import clean_special_chars
from ..lang.syllabify import abbreviations as ABBREVIATIONS


def rotate_bbox(cbox: CharBox, angle: float, orig_shape, target_shape,
                radians: bool = False) -> CharBox:
    """Rotate a box back by ``angle`` about the processed image's center,
    compensating for rotation padding (alignToOCR.py:90-125). ``orig_shape``
    is the processed (rotated) page's (H, W); ``target_shape`` the raw
    page's. Integer divisions floor, as the reference's Python 2 ints did."""
    orig_nrows, orig_ncols = orig_shape[:2]
    target_nrows, target_ncols = target_shape[:2]

    pivot_x = orig_ncols // 2
    pivot_y = orig_nrows // 2

    dx = (orig_ncols - target_ncols) // 2
    dy = (orig_nrows - target_nrows) // 2

    if not radians:
        angle = angle * np.pi / 180

    s = np.sin(angle)
    c = np.cos(angle)

    old_ulx = cbox.ulx - pivot_x
    old_uly = cbox.uly - pivot_y
    old_lrx = cbox.lrx - pivot_x
    old_lry = cbox.lry - pivot_y

    new_ulx = (old_ulx * c) - (old_uly * s)
    new_uly = (old_ulx * s) + (old_uly * c)
    new_lrx = (old_lrx * c) - (old_lry * s)
    new_lry = (old_lrx * s) + (old_lry * c)

    new_ulx += pivot_x - dx
    new_uly += pivot_y - dy
    new_lrx += pivot_x - dx
    new_lry += pivot_y - dy

    new_ul = np.round([new_ulx, new_uly]).astype("int16")
    new_lr = np.round([new_lrx, new_lry]).astype("int16")

    return CharBox(cbox.char, new_ul, new_lr)


def rotate_bboxes(cboxes, angle: float, orig_shape, target_shape,
                  radians: bool = False) -> list:
    """Vectorized :func:`rotate_bbox` over a list of boxes: one float64
    numpy pass over a (N, 4) corner array instead of N scalar sin/cos/round
    calls (the per-box version costs ~17 µs of numpy scalar overhead each —
    this is the per-folio assembly hot spot). Bit-identical results: same
    float64 arithmetic, same np.round semantics, elementwise."""
    if not cboxes:
        return []
    orig_nrows, orig_ncols = orig_shape[:2]
    target_nrows, target_ncols = target_shape[:2]
    pivot_x = orig_ncols // 2
    pivot_y = orig_nrows // 2
    dx = (orig_ncols - target_ncols) // 2
    dy = (orig_nrows - target_nrows) // 2
    if not radians:
        angle = angle * np.pi / 180
    s = np.sin(angle)
    c = np.cos(angle)

    corners = np.array(
        [[cb.ulx, cb.uly, cb.lrx, cb.lry] for cb in cboxes], np.float64
    )
    old_x = corners[:, [0, 2]] - pivot_x
    old_y = corners[:, [1, 3]] - pivot_y
    new_x = old_x * c - old_y * s + (pivot_x - dx)
    new_y = old_x * s + old_y * c + (pivot_y - dy)
    xi = np.round(new_x).astype("int16")
    yi = np.round(new_y).astype("int16")
    return [
        CharBox(cb.char, (xi[i, 0], yi[i, 0]), (xi[i, 1], yi[i, 1]))
        for i, cb in enumerate(cboxes)
    ]


def to_processed_frame(cbox: CharBox, angle: float, orig_shape,
                       target_shape) -> CharBox:
    """Exact inverse of :func:`rotate_bbox`'s back-mapping: lift a box from
    the raw page frame into the processed (rotated, padded) frame, i.e.
    p_proc = R(angle) (p_raw - pivot + d) + pivot. Used to inject
    raw-frame fixture OCR at the stage boundary (tests, eval harness)."""
    orig_nrows, orig_ncols = orig_shape[:2]
    target_nrows, target_ncols = target_shape[:2]
    pivot_x = orig_ncols // 2
    pivot_y = orig_nrows // 2
    dx = (orig_ncols - target_ncols) // 2
    dy = (orig_nrows - target_nrows) // 2

    a = angle * np.pi / 180
    s, c = np.sin(a), np.cos(a)

    def fwd(x, y):
        tx = x - (pivot_x - dx)
        ty = y - (pivot_y - dy)
        return (tx * c - ty * s + pivot_x, tx * s + ty * c + pivot_y)

    ulx, uly = fwd(cbox.ulx, cbox.uly)
    lrx, lry = fwd(cbox.lrx, cbox.lry)
    new_ul = np.round([ulx, uly]).astype("int16")
    new_lr = np.round([lrx, lry]).astype("int16")
    return CharBox(cbox.char, new_ul, new_lr)


def llocs_to_charboxes(strips, llocs_rows) -> tuple[list[CharBox], list[CharBox]]:
    """Per-line (char, x) rows -> page-coordinate CharBoxes
    (alignToOCR.py:153-184). OCR reports each character's rightmost edge, so
    a char's box spans from the previous char's right edge to its own.
    Returns (all_chars, other_chars) — '~' and '' land in other_chars."""
    all_chars: list[CharBox] = []
    other_chars: list[CharBox] = []
    for strip, rows in zip(strips, llocs_rows):
        x_min = strip.offset_x
        y_min = strip.offset_y
        y_max = strip.offset_y + strip.height

        prev_xpos = x_min
        for ch, x in rows:
            cur_xpos = int(np.round(float(x) + x_min))
            ul = (prev_xpos, y_min)
            lr = (cur_xpos, y_max)
            if ch == "~" or ch == "":
                other_chars.append(CharBox(ch, ul, lr))
            else:
                all_chars.append(CharBox(clean_special_chars(ch), ul, lr))
            prev_xpos = cur_xpos
    return all_chars, other_chars


def expand_abbreviations(all_chars: list[CharBox]) -> list[CharBox]:
    """Replace abbreviation glyph sequences with expansion syllables, each
    expansion segment inheriting the bbox of the char at its position;
    loops until no occurrences remain (alignToOCR.py:251-264)."""
    for abb in ABBREVIATIONS.keys():
        while True:
            ocr_str = "".join(str(x.char) for x in all_chars)
            idx = ocr_str.find(abb)
            if idx == -1:
                break
            ins = []
            for i, segment in enumerate(ABBREVIATIONS[abb]):
                split_box = all_chars[i + idx]
                ins += [CharBox(x, split_box.ul, split_box.lr) for x in segment]
            all_chars = all_chars[:idx] + ins + all_chars[idx + len(abb):]
    return all_chars


def group_syllables(syls, tra_align: str, ocr_align: str,
                    all_chars: list[CharBox]) -> list[CharBox]:
    """Group aligned characters into syllable boxes (alignToOCR.py:279-324).

    Mutates a copy of all_chars by inserting gap boxes where ocr_align has
    '_', asserts stream/alignment sync, regex-locates each syllable in
    tra_align tolerating interleaved gaps, and unions surviving boxes
    (keeping only the lower text line when a syllable spans two).
    """
    all_chars = list(all_chars)
    for i, char in enumerate(ocr_align):
        if char == "_":
            all_chars.insert(i, CharBox("_"))

    assert len(all_chars) == len(tra_align), (
        "all_chars not same length as alignment: "
        "{} vs {}".format(len(all_chars), len(tra_align))
    )

    current_offset = 0
    syl_boxes = []
    for syl in syls:
        if len(syl) < 1:
            continue
        elif len(syl) == 1:
            syl_regex = syl
        else:
            syl_regex = syl[0] + syl[1:-1].replace("", "_*") + syl[-1]

        syl_match = re.search(syl_regex, tra_align[current_offset:])
        start = syl_match.start() + current_offset
        end = syl_match.end() + current_offset
        current_offset = end
        align_boxes = [x for x in all_chars[start:end] if x.lr is not None]

        if not align_boxes:
            continue

        if len(set(x.uly for x in align_boxes)) > 1:
            lower_level = max(x.uly for x in align_boxes)
            align_boxes = [b for b in align_boxes if b.uly == lower_level]

        new_ul = (min(x.ulx for x in align_boxes), min(x.uly for x in align_boxes))
        new_lr = (max(x.lrx for x in align_boxes), max(x.lry for x in align_boxes))
        syl_boxes.append(CharBox(syl, new_ul, new_lr))

    return syl_boxes
