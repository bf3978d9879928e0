"""Affine-gap Needleman-Wunsch (Gotoh, three matrices) on the host, with
the reference's first-max tie-breaking (textSeqCompare.py:45-170): a frozen
copy of the port's row-vectorized integer fill (``align.nw_host.
fill_host_fast``), exact in int64, and its traceback.

``saturate=8`` clamps every score to the int8 range after each step: the
benchmark's control for the NW stages, the integer precision below the
fill's."""

from __future__ import annotations

import numpy as np

from .scoring import resolve_scoring
from .traceback import DensePtrView, traceback

def _first_argmax3(a, b, c):
    """Elementwise index of the max of three arrays, first-max-wins."""
    stacked = np.stack([a, b, c])
    return np.argmax(stacked, axis=0).astype(np.int8)


def fill_host_fast(transcript, ocr, sc, saturate=None):
    """Row-vectorized exact fill for integer scoring systems.

    The y (horizontal-gap) recurrence y[j] = max(A[j], y[j-1] + gey) is a
    running max of A[k] - k*gey — exact in int64.
    Returns (mat_ptr, x_ptr, y_ptr) int8 arrays of shape (N, M).
    """
    N, M = len(transcript), len(ocr)
    NEG = np.int64(-(2**56))
    gox = int(sc.gap_open_x)
    goy = int(sc.gap_open_y)
    gex = int(sc.gap_extend_x)
    gey = int(sc.gap_extend_y)

    # substitution scores per row computed on demand below
    ocr_arr = np.array(ocr, dtype=object)

    mat_ptr = np.zeros((N, M), dtype=np.int8)
    x_ptr = np.zeros((N, M), dtype=np.int8)
    y_ptr = np.zeros((N, M), dtype=np.int8)

    br0 = int(sc.bge_row0)
    bc0 = int(sc.bge_col0)
    j_idx = np.arange(M, dtype=np.int64)

    m_prev = br0 * j_idx
    x_prev = br0 * j_idx
    y_prev = np.full(M, NEG, dtype=np.int64)

    if sc.match_mismatch is not None:
        match, mismatch = int(sc.match_mismatch[0]), int(sc.match_mismatch[1])
        score_row_cache = {}

        def score_row(a):
            key = a
            row = score_row_cache.get(key)
            if row is None:
                row = np.where(ocr_arr == a, match, mismatch).astype(np.int64)
                score_row_cache[key] = row
            return row

    else:
        def score_row(a):
            return np.array(
                [int(sc.score(a, b)) for b in ocr], dtype=np.int64
            )

    for i in range(1, N):
        # mat[i][j]: depends on row i-1 at j-1
        mvals0 = m_prev[:-1]
        mvals1 = x_prev[:-1]
        mvals2 = y_prev[:-1]
        srow = score_row(transcript[i - 1])[:-1]  # score vs ocr[j-1], j=1..M-1
        m_best = np.maximum(np.maximum(mvals0, mvals1), mvals2)
        m_cur = np.empty(M, dtype=np.int64)
        m_cur[0] = bc0 * i
        m_cur[1:] = m_best + srow
        mat_ptr[i, 1:] = _first_argmax3(mvals0, mvals1, mvals2)

        # x_mat[i][j]: depends on row i-1 at j
        xc0 = m_prev[1:] + (gox + gex)
        xc1 = x_prev[1:] + gex
        xc2 = y_prev[1:] + (gox + gex)
        x_cur = np.empty(M, dtype=np.int64)
        x_cur[0] = NEG
        x_cur[1:] = np.maximum(np.maximum(xc0, xc1), xc2)
        x_ptr[i, 1:] = _first_argmax3(xc0, xc1, xc2)

        # y_mat[i][j] = max(m_cur[j-1]+goy+gey, x_cur[j-1]+goy+gey,
        #                   y_cur[j-1]+gey): running max in closed form.
        a_vals = np.empty(M, dtype=np.int64)
        a_vals[0] = bc0 * i  # y boundary value at j=0
        a_vals[1:] = (
            np.maximum(m_cur[:-1] + (goy + gey), x_cur[:-1] + (goy + gey))
        )
        b_vals = a_vals - gey * j_idx
        run = np.maximum.accumulate(b_vals)
        y_cur = run + gey * j_idx
        y_cur[0] = bc0 * i

        yc0 = m_cur[:-1] + (goy + gey)
        yc1 = x_cur[:-1] + (goy + gey)
        yc2 = y_cur[:-1] + gey
        y_ptr[i, 1:] = _first_argmax3(yc0, yc1, yc2)

        if saturate is not None:
            lo, hi = -(1 << (saturate - 1)), (1 << (saturate - 1)) - 1
            m_cur, x_cur, y_cur = (np.clip(v, lo, hi)
                                   for v in (m_cur, x_cur, y_cur))
        m_prev, x_prev, y_prev = m_cur, x_cur, y_cur

    return mat_ptr, x_ptr, y_ptr


def align(transcript, ocr, scoring_system=None, saturate=None):
    """(tra_align, ocr_align) lists of ``transcript`` against ``ocr``
    (each given without the sentinel, which is appended here)."""
    t = list(transcript) + [" "]
    o = list(ocr) + [" "]
    sc = resolve_scoring(scoring_system)
    ptrs = DensePtrView(*fill_host_fast(t, o, sc, saturate))
    return traceback(t, o, ptrs)
