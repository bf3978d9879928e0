"""Abbreviation expansion of an OCR stream (alignToOCR.py:251-264): a
frozen copy of the port's, with the reference's table
(latinSyllabification.py:9-19)."""

from __future__ import annotations

from .charbox import CharBox

# OCR abbreviation glyphs -> expanded syllables
ABBREVIATIONS = {
    "dns": ["do", "mi", "nus"],
    "dūs": ["do", "mi", "nus"],
    "dne": ["do", "mi", "ne"],
    "alla": ["al", "le", "lu", "ia"],
    "^": ["us"],
    "ā": ["am"],
    "ē": ["em"],
    "ū": ["um"],
    "ō": ["om"],
}


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
