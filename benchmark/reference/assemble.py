"""Syllable assembly, in plain Python and NumPy: frozen copies of the
port's Latin syllabification (latinSyllabification.py:5-109, :170-174),
its grouping of aligned characters into syllable boxes
(alignToOCR.py:279-324) and its rotation of the boxes back to the raw
page (alignToOCR.py:90-125), and ``syl_boxes``: what ``process`` makes of a
transcript and its OCR characters with the NW reference's alignment."""

from __future__ import annotations

import re

import numpy as np

from . import nw
from .charbox import CharBox

CONSONANT_GROUPS = ["qu", "ch", "ph", "fl", "fr", "st", "br", "cr", "cl",
                    "pr", "tr", "ct", "th"]
DIPHTHONGS = ["ae", "au", "ei", "oe", "ui", "ya", "ex", "ix"]
VOWELS = ["a", "e", "i", "o", "u", "y"]
SPECIAL = {"euouae": ["e", "u", "o", "u", "ae"], "cuius": ["cu", "ius"],
           "eius": ["e", "ius"]}


def _stick(word, seed_first):
    """One pass gluing a unit without a vowel seed ('*') to its neighbour
    that has one: the following one, or with ``seed_first`` the
    preceding."""
    out, i = [], 0
    while i < len(word):
        if i + 1 >= len(word):
            out.append(word[i])
            break
        cur, nxt = word[i], word[i + 1]
        if seed_first == ("*" in cur) and ("*" in cur) != ("*" in nxt):
            out.append(cur + nxt)
            i += 2
        else:
            out.append(cur)
            i += 1
    return out


def syllabify_word(inp):
    if inp in SPECIAL:
        return list(SPECIAL[inp])
    word = [inp]
    for unit in CONSONANT_GROUPS + DIPHTHONGS:
        new = []
        for seg in word:
            if "*" in seg:
                new.append(seg)
                continue
            split = seg.split(unit)
            inter = [v for pair in zip(split, [unit + "*"] * len(split))
                     for v in pair]
            new += [x for x in inter[:-1] if x]
        word = new
    new = []
    for seg in word:
        new += [seg.replace("*", "")] if "*" in seg else list(seg)
    word = [w + "*" if w in VOWELS + DIPHTHONGS else w for w in new]
    if not any("*" in x for x in word):
        return ["".join(word)] if word else []
    while not all("*" in x for x in word):
        word = _stick(_stick(word, False), True)
    return [x.replace("*", "") for x in word]


def syllabify_text(text):
    return [s for w in text.split(" ") for s in syllabify_word(w)]


def group_syllables(syls, tra_align, ocr_align, all_chars):
    all_chars = list(all_chars)
    for i, ch in enumerate(ocr_align):
        if ch == "_":
            all_chars.insert(i, CharBox("_"))
    assert len(all_chars) == len(tra_align)
    offset, out = 0, []
    for syl in syls:
        if not syl:
            continue
        regex = syl if len(syl) == 1 else (
            syl[0] + syl[1:-1].replace("", "_*") + syl[-1])
        m = re.search(regex, tra_align[offset:])
        start, end = m.start() + offset, m.end() + offset
        offset = end
        boxes = [x for x in all_chars[start:end] if x.lr is not None]
        if not boxes:
            continue
        if len({x.uly for x in boxes}) > 1:
            low = max(x.uly for x in boxes)
            boxes = [b for b in boxes if b.uly == low]
        out.append(CharBox(syl, (min(x.ulx for x in boxes),
                                 min(x.uly for x in boxes)),
                           (max(x.lrx for x in boxes),
                            max(x.lry for x in boxes))))
    return out


def rotate_bboxes(boxes, angle, orig_shape, target_shape):
    """Each box's corners rotated by ``angle`` degrees about the processed
    page's centre (shape ``orig_shape``), less the rotation's padding to
    ``target_shape``; float64, numpy's rounding."""
    if not boxes:
        return []
    pivot_x, pivot_y = orig_shape[1] // 2, orig_shape[0] // 2
    dx = (orig_shape[1] - target_shape[1]) // 2
    dy = (orig_shape[0] - target_shape[0]) // 2
    a = angle * np.pi / 180
    s, c = np.sin(a), np.cos(a)
    xy = np.array([[b.ulx, b.uly, b.lrx, b.lry] for b in boxes], np.float64)
    old_x = xy[:, [0, 2]] - pivot_x
    old_y = xy[:, [1, 3]] - pivot_y
    xi = np.round(old_x * c - old_y * s + (pivot_x - dx)).astype("int16")
    yi = np.round(old_x * s + old_y * c + (pivot_y - dy)).astype("int16")
    return [CharBox(b.char, (xi[i, 0], yi[i, 0]), (xi[i, 1], yi[i, 1]))
            for i, b in enumerate(boxes)]


def syl_boxes(transcript, all_chars, angle, image_shape, raw_shape):
    """The syllable boxes of ``transcript`` on the raw page, from its OCR
    characters (after abbreviation expansion) on the processed page, the
    page's skew ``angle`` and the two pages' shapes."""
    tra, ocr = nw.align(transcript, "".join(c.char for c in all_chars))
    groups = group_syllables(syllabify_text(transcript), "".join(tra),
                             "".join(ocr), all_chars)
    return rotate_bboxes(groups, -1 * angle, image_shape, raw_shape)
