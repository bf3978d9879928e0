"""Label <-> character codec for the line recognizer.

Class 0 is the CTC blank (written as '' in llocs output); class 1 is the
reject glyph '~'. Both are filtered by the OCR stage exactly as the
reference filters them from ocropus-rpred output (alignToOCR.py:175-177).
"""

from __future__ import annotations

DEFAULT_CHARSET = ["", "~", " "] + list("abcdefghijklmnopqrstuvwxyz")


class Codec:
    def __init__(self, charset=None):
        self.charset = list(charset if charset is not None else DEFAULT_CHARSET)
        assert self.charset[0] == "", "class 0 must be the blank"
        self.char2code = {c: i for i, c in enumerate(self.charset)}

    def __len__(self):
        return len(self.charset)

    def l2s(self, labels) -> str:
        """Labels -> string (ocrolib Codec.l2s equivalent)."""
        return "".join(self.charset[int(l)] for l in labels)

    def s2l(self, s: str) -> list[int]:
        return [self.char2code[c] for c in s]

    def __eq__(self, other):
        return isinstance(other, Codec) and self.charset == other.charset
