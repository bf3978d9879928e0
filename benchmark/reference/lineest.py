"""The OCR stage's line normalizer, in NumPy and SciPy: a frozen copy of
ocrolib's ``lineest.CenterNormalizer`` (measure, dewarp, normalize) and
``lstm.prepare_line``, as ``ocropus-rpred`` runs them on a onebit line:
the smoothed vertical centre of ink mass a column, each column dewarped
about it with half-height ``r = 1 + 4 MAD``, a bilinear zoom to the
model's height, ink scaled to [0, 1] and ``pad`` blank frames at either
end. SciPy's filters and zoom work in float64 and store float32.

``normalize(ink, rnd=bf16)`` is the control's: every array that a filter,
the zoom or the scaling stores is rounded to bfloat16, one precision
below the float32 that the configuration states."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import (gaussian_filter, gaussian_filter1d,
                           uniform_filter, zoom)

RANGE, SMOOTHNESS, EXTRA = 4, 1.0, 0.3


def f32(x):
    return np.asarray(x, np.float32)


def bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def measure(line, rnd=f32):
    """(center (w,) int32, r) of an ink-positive (h, w) float32 line."""
    h, w = line.shape
    smoothed = rnd(gaussian_filter(line, (h * 0.5, h * SMOOTHNESS),
                                   mode="constant"))
    smoothed = rnd(smoothed + rnd(0.001 * uniform_filter(
        smoothed, (h * 0.5, w), mode="constant")))
    a = np.argmax(smoothed, axis=0)
    center = np.array(gaussian_filter1d(a.astype(float), h * EXTRA), "i")
    if (line != 0).any():
        deltas = np.abs(np.arange(h)[:, None] - center[None, :])
        mad = float(np.mean(deltas[line != 0]))
    else:
        mad = h / 4.0
    return center, int(1 + RANGE * mad)


def dewarp(img, center, r, cval):
    h, w = img.shape
    padded = np.vstack([cval * np.ones((r, w)), img, cval * np.ones((r, w))])
    c = center + r
    return np.array([padded[c[i] - r:c[i] + r, i] for i in range(w)],
                    np.float32).T


def normalize(ink, target_height=48, pad=16, rnd=f32):
    """The (T, target_height) float32 frames of a onebit (h, w) line
    (True = ink), or None for a blank one."""
    grey = 1.0 - ink.astype(np.float32)
    mx = float(np.amax(grey))
    temp = mx - grey
    tmax = float(np.amax(temp))
    if tmax <= 0:
        return None
    center, r = measure(f32(temp * 1.0 / tmax), rnd)
    d = dewarp(grey, center, r, mx)
    line = rnd(zoom(d, target_height * 1.0 / d.shape[0], order=1,
                    mode="constant", cval=mx))
    line = rnd(line * 1.0 / np.amax(line))
    line = rnd(np.amax(line) - line).T
    frames = np.vstack([np.zeros((pad, target_height)), line,
                        np.zeros((pad, target_height))])
    return frames.astype(np.float32)
