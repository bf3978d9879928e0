"""Host-side traceback shared by all NW fill backends.

Exact reference semantics (textSeqCompare.py:90-170): start at the
bottom-right cell, forcibly align the final (sentinel) characters, follow the
pointer matrices back to the top-left, emit ``'_'`` gap symbols, then reverse
with ``[-1:0:-1]`` (dropping the sentinel pair).

The fill backends provide pointers either as dense (N, M) arrays or in
anti-diagonal layout; a ``PtrView`` adapter normalizes access. Traceback cost
is O(N+M) — negligible next to the fill.
"""

from __future__ import annotations


class DensePtrView:
    """Pointer access over dense (N, M) mat/x/y pointer arrays."""

    def __init__(self, mat_ptr, x_ptr, y_ptr):
        self._m = mat_ptr
        self._x = x_ptr
        self._y = y_ptr

    def mat(self, i, j):
        return int(self._m[i, j])

    def x(self, i, j):
        return int(self._x[i, j])

    def y(self, i, j):
        return int(self._y[i, j])


def traceback(transcript, ocr, ptrs):
    """Trace the alignment path. ``transcript``/``ocr`` include the appended
    sentinel elements. Returns (tra_align, ocr_align) lists."""
    tra_align = []
    ocr_align = []

    xpt = len(transcript) - 1
    ypt = len(ocr) - 1
    mpt = ptrs.mat(xpt, ypt)

    # forcibly align the final (sentinel) characters
    tra_align.append(transcript[xpt])
    ocr_align.append(ocr[ypt])

    while xpt > 0 and ypt > 0:
        if mpt == 0:
            tra_align.append(transcript[xpt - 1])
            ocr_align.append(ocr[ypt - 1])
            mpt = ptrs.mat(xpt, ypt)
            xpt -= 1
            ypt -= 1
        elif mpt == 1:
            tra_align.append(transcript[xpt - 1])
            ocr_align.append("_")
            mpt = ptrs.x(xpt, ypt)
            xpt -= 1
        elif mpt == 2:
            tra_align.append("_")
            ocr_align.append(ocr[ypt - 1])
            mpt = ptrs.y(xpt, ypt)
            ypt -= 1

    while ypt > 0:
        tra_align.append("_")
        ocr_align.append(ocr[ypt - 1])
        ypt -= 1

    while xpt > 0:
        ocr_align.append("_")
        tra_align.append(transcript[xpt - 1])
        xpt -= 1

    # reverse; [-1:0:-1] drops the sentinel pair appended first
    tra_align = tra_align[-1:0:-1]
    ocr_align = ocr_align[-1:0:-1]

    return tra_align, ocr_align
