"""Host (numpy) fills for affine-gap Needleman–Wunsch (Gotoh, 3 matrices).

Two implementations sharing the exact reference semantics
(textSeqCompare.py:45-88):

- ``fill_reference_slow`` — literal port of the reference's O(N·M) Python
  loop. This is the correctness oracle and the CPU baseline the benchmarks
  measure against.
- ``fill_host_fast`` — row-vectorized numpy fill. Exact for integer scoring
  (the reference default and its whole 729-combo grid are integers); the
  within-row y recurrence is solved in closed form with a running max, which
  is bit-exact in int64.

Both return the three pointer matrices with first-max tie-breaking
(``list.index(max(...))`` semantics, textSeqCompare.py:72,80,88 — replicated
via ``np.argmax``'s first-occurrence rule).
"""

from __future__ import annotations

import numpy as np

from .scoring import Scoring, BOUNDARY_GAP_EXTEND


def fill_reference_slow(transcript, ocr, sc: Scoring):
    """Literal port of the reference DP fill. Returns (mat_ptr, x_ptr, y_ptr)."""
    N, M = len(transcript), len(ocr)
    mat = np.zeros((N, M))
    y_mat = np.zeros((N, M))
    x_mat = np.zeros((N, M))
    mat_ptr = np.zeros((N, M), dtype=np.int8)
    y_mat_ptr = np.zeros((N, M), dtype=np.int8)
    x_mat_ptr = np.zeros((N, M), dtype=np.int8)

    # boundary conditions use the module-global gap extend (reference
    # quirk; strict=False scorings carry the corrected per-axis extends)
    bc0, br0 = sc.bge_col0, sc.bge_row0
    for i in range(N):
        mat[i][0] = bc0 * i
        x_mat[i][0] = -1e100
        y_mat[i][0] = bc0 * i
    for j in range(M):
        mat[0][j] = br0 * j
        x_mat[0][j] = br0 * j
        y_mat[0][j] = -1e100

    gox, goy = sc.gap_open_x, sc.gap_open_y
    gex, gey = sc.gap_extend_x, sc.gap_extend_y
    score = sc.score

    for i in range(1, N):
        for j in range(1, M):
            match_score = score(transcript[i - 1], ocr[j - 1])

            mat_vals = [mat[i - 1][j - 1], x_mat[i - 1][j - 1], y_mat[i - 1][j - 1]]
            mat[i][j] = max(mat_vals) + match_score
            mat_ptr[i][j] = int(mat_vals.index(max(mat_vals)))

            y_mat_vals = [
                mat[i][j - 1] + goy + gey,
                x_mat[i][j - 1] + goy + gey,
                y_mat[i][j - 1] + gey,
            ]
            y_mat[i][j] = max(y_mat_vals)
            y_mat_ptr[i][j] = int(y_mat_vals.index(max(y_mat_vals)))

            x_mat_vals = [
                mat[i - 1][j] + gox + gex,
                x_mat[i - 1][j] + gex,
                y_mat[i - 1][j] + gox + gex,
            ]
            x_mat[i][j] = max(x_mat_vals)
            x_mat_ptr[i][j] = int(x_mat_vals.index(max(x_mat_vals)))

    return mat_ptr, x_mat_ptr, y_mat_ptr


def _first_argmax3(a, b, c):
    """Elementwise index of the max of three arrays, first-max-wins."""
    stacked = np.stack([a, b, c])
    return np.argmax(stacked, axis=0).astype(np.int8)


def fill_host_fast(transcript, ocr, sc: Scoring):
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

        m_prev, x_prev, y_prev = m_cur, x_cur, y_cur

    return mat_ptr, x_ptr, y_ptr


def fill_native(transcript, ocr, sc: Scoring):
    """Native C++ fill (ops.host_native.nw_fill) for integral
    match/mismatch scoring: elements are tokenized by equality, then the
    scalar row sweep runs at ~5 ns/cell. Pointer matrices are bit-identical
    to fill_host_fast (tested)."""
    from ..ops import host_native

    vocab: dict = {}
    def ids(seq):
        out = np.empty(len(seq), np.int32)
        for k, el in enumerate(seq):
            out[k] = vocab.setdefault(el, len(vocab))
        return out

    t_ids, o_ids = ids(transcript), ids(ocr)
    match, mismatch = (int(v) for v in sc.match_mismatch)
    return host_native.nw_fill(
        t_ids, o_ids, match, mismatch,
        int(sc.gap_open_x), int(sc.gap_open_y),
        int(sc.gap_extend_x), int(sc.gap_extend_y), BOUNDARY_GAP_EXTEND,
    )


def _native_nw_available() -> bool:
    import os

    if os.environ.get("TEXT_ALIGNMENT_TPU_NO_NATIVE_NW"):
        return False
    from ..ops import host_native

    return host_native.available()


def fill_host(transcript, ocr, sc: Scoring):
    """Pick the fastest exact path for this scoring system: the native C++
    sweep, the vectorized numpy fill, or the literal reference loop."""
    if sc.is_integral and sc.match_mismatch is not None:
        # the native C++ sweep covers the parity boundary form only;
        # strict=False boundaries ride the vectorized numpy fill
        if sc.default_boundary and _native_nw_available():
            return fill_native(transcript, ocr, sc)
        return fill_host_fast(transcript, ocr, sc)
    if sc.match_mismatch is None:
        # custom callable: probe integrality on the actual alphabet
        try:
            vals = {
                sc.score(a, b)
                for a in set(transcript)
                for b in set(ocr)
            }
            if all(float(v) == int(v) for v in vals) and all(
                float(g) == int(g)
                for g in (sc.gap_open_x, sc.gap_open_y, sc.gap_extend_x, sc.gap_extend_y)
            ):
                return fill_host_fast(transcript, ocr, sc)
        except Exception as e:
            # a broken custom scoring callable must surface, not silently
            # degrade to the slow fill where it will raise anyway — warn
            # with the cause so the eventual failure is attributable
            import warnings

            warnings.warn(
                f"custom scoring callable failed integrality probe ({e!r}); "
                "falling back to the reference fill",
                RuntimeWarning,
            )
    return fill_reference_slow(transcript, ocr, sc)
