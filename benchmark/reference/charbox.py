"""CharBox value type: one character (or syllable) plus its bounding box.

Semantics match the reference value type (alignToOCR.py:35-58): ``ul``/``lr``
are (x, y) tuples or ``None`` for an "empty" box (a gap inserted by the
aligner); convenience attributes are derived at construction.
"""

from __future__ import annotations


class CharBox:
    __slots__ = ["char", "ul", "lr", "ulx", "lrx", "uly", "lry", "width", "height"]

    def __init__(self, char, ul=None, lr=None):
        self.char = char
        if (ul is None) or (lr is None):
            self.ul = None
            self.lr = None
            self.ulx = None
            self.lrx = None
            self.uly = None
            self.lry = None
            self.width = None
            self.height = None
            return
        self.ul = tuple(int(v) for v in ul)
        self.lr = tuple(int(v) for v in lr)
        self.ulx = self.ul[0]
        self.lrx = self.lr[0]
        self.uly = self.ul[1]
        self.lry = self.lr[1]
        self.width = self.lr[0] - self.ul[0]
        self.height = self.lr[1] - self.ul[1]

    def __repr__(self):
        if self.ul and self.lr:
            return "{}: {}, {}".format(self.char, self.ul, self.lr)
        return "{}: empty".format(self.char)

    def __eq__(self, other):
        if not isinstance(other, CharBox):
            return NotImplemented
        return (
            self.char == other.char and self.ul == other.ul and self.lr == other.lr
        )

    def __hash__(self):
        return hash((self.char, self.ul, self.lr))
