"""Projection smoothing and peak-prominence line detection (host-side).

Exact ports of the reference's pure-Python routines
(textAlignPreprocessing.py:59-157). These run on the ~H-length projection
vector, so they are cheap; they stay host-side in float64 on *both* pipeline
paths so that peak decisions are bit-identical.

``calculate_peak_prominence`` is vectorized but reproduces every reference
quirk: zero prominence at edges / non-strict maxima / flat-topped peaks,
log(value) for the global max, nearest-higher-index tie broken toward the
right when distances are equal (the reference's ``>`` comparison,
textAlignPreprocessing.py:97-100), and key col = min over the half-open
slice ``data[lo:hi]``.
"""

from __future__ import annotations

import numpy as np

FILTER_SIZE = 30
PROMINENCE_TOLERANCE = 0.70


def moving_avg_filter(data, filter_size: int = FILTER_SIZE) -> np.ndarray:
    """Moving average of width 2*filter_size+1; the first and last
    ``filter_size`` entries are left zero (textAlignPreprocessing.py:147-157).

    Sliding-sum formulation: the input is an integer projection, so the
    float64 window sums are exact integers and this is bit-identical to
    the reference's per-window np.mean loop (O(n) instead of O(n*w))."""
    data = np.asarray(data, dtype=np.float64)
    n = len(data)
    w = 2 * filter_size + 1
    smoothed = np.zeros(n)
    if n >= w:
        c = np.concatenate([[0.0], np.cumsum(data)])
        smoothed[filter_size : n - filter_size] = (c[w:] - c[:-w]) / w
    return smoothed


def calculate_peak_prominence(data, index: int) -> float:
    """Log prominence of the peak at ``index``
    (textAlignPreprocessing.py:59-110)."""
    data = np.asarray(data, dtype=np.float64)
    current_peak = data[index]

    if (
        index == 0
        or index == len(data) - 1
        or data[index - 1] > current_peak
        or data[index + 1] > current_peak
        or (data[index - 1] == current_peak and data[index + 1] == current_peak)
    ):
        return 0

    if current_peak == max(data):
        return np.log(current_peak)

    higher_peaks_inds = [i for i, x in enumerate(data) if x > current_peak]

    right_peaks = [x for x in higher_peaks_inds if x > index]
    closest_right_ind = min(right_peaks) if right_peaks else np.inf
    left_peaks = [x for x in higher_peaks_inds if x < index]
    closest_left_ind = max(left_peaks) if left_peaks else -np.inf

    right_distance = closest_right_ind - index
    left_distance = index - closest_left_ind

    if right_distance > left_distance:
        closest = closest_left_ind
    else:
        closest = closest_right_ind

    lo = min(closest, index)
    hi = max(closest, index)
    between_slice = data[int(lo) : int(hi)]
    key_col = min(between_slice)

    return np.log(data[index] - key_col + 1)


def _prominences_vectorized(data: np.ndarray) -> np.ndarray:
    """All-peaks prominence in O(n log n)-ish numpy, identical values to
    calling ``calculate_peak_prominence`` at every index."""
    n = len(data)
    prom = np.zeros(n)
    if n < 3:
        return prom

    interior = np.arange(1, n - 1)
    left, mid, right = data[:-2], data[1:-1], data[2:]
    is_peak = ~(
        (left > mid) | (right > mid) | ((left == mid) & (right == mid))
    )
    peak_idx = interior[is_peak]
    if len(peak_idx) == 0:
        return prom

    dmax = data.max()

    # nearest strictly-higher index on each side, via monotonic stacks —
    # native C++ when available (exact float64 comparisons, ~0.5 ms/page
    # saved), else plain-python lists (float-list indexing is ~20x faster
    # than numpy scalar indexing in this branchy per-element loop).
    vals = data.tolist()
    from . import host_native

    if host_native.available():
        hl, hr = host_native.nearest_higher(data)
        higher_left = hl.tolist()
        higher_right = hr.tolist()
    else:
        higher_left = [0] * n
        stack: list[int] = []
        for i in range(n):
            v = vals[i]
            while stack and vals[stack[-1]] <= v:
                stack.pop()
            higher_left[i] = stack[-1] if stack else -1
            stack.append(i)
        higher_right = [0] * n
        stack = []
        for i in range(n - 1, -1, -1):
            v = vals[i]
            while stack and vals[stack[-1]] <= v:
                stack.pop()
            higher_right[i] = stack[-1] if stack else n
            stack.append(i)

    # sparse-table range-minimum for key cols (floor(log2(i)) via frexp:
    # exact for any float64-representable integer)
    log2 = np.zeros(n + 1, dtype=np.int64)
    log2[1:] = np.frexp(np.arange(1, n + 1, dtype=np.float64))[1] - 1
    K = int(log2[n]) + 1
    sp = np.empty((K, n))
    sp[0] = data
    for k in range(1, K):
        span = 1 << k
        half = span >> 1
        sp[k, : n - span + 1] = np.minimum(
            sp[k - 1, : n - span + 1], sp[k - 1, half : n - span + 1 + half]
        )

    def range_min(lo, hi):  # min of data[lo:hi], hi > lo
        k = int(log2[hi - lo])
        return min(sp[k, lo], sp[k, hi - (1 << k)])

    for i in peak_idx.tolist():
        di = vals[i]
        if di == dmax:
            prom[i] = np.log(di)
            continue
        hr, hl = higher_right[i], higher_left[i]
        cr = hr if hr < n else np.inf
        cl = hl if hl >= 0 else -np.inf
        if (cr - i) > (i - cl):
            closest = cl
        else:
            closest = cr
        lo, hi = int(min(closest, i)), int(max(closest, i))
        key_col = range_min(lo, hi)
        prom[i] = np.log(di - key_col + 1)
    return prom


def find_peak_locations(data, tol: float = PROMINENCE_TOLERANCE, ranked: bool = False):
    """Prominent-peak indices of a smoothed projection
    (textAlignPreprocessing.py:113-144), including the flat-top adjacent
    dedup quirk (:134-137)."""
    data = np.asarray(data, dtype=np.float64)
    prom = _prominences_vectorized(data)

    prom_max = float(prom.max()) if len(prom) else 0
    if prom_max == 0:
        return []

    norm = prom / prom_max
    peak_locs = [(int(i), float(norm[i])) for i in np.nonzero(norm > tol)[0]]

    # flat-topped peaks: drop the former of adjacent equal prominences
    to_remove = [
        peak_locs[i]
        for i in range(len(peak_locs) - 2)
        if peak_locs[i][1] == peak_locs[i + 1][1]
    ]
    for r in to_remove:
        peak_locs.remove(r)

    if ranked:
        peak_locs.sort(key=lambda x: x[1] * -1)
    else:
        peak_locs = [x[0] for x in peak_locs]

    return peak_locs
