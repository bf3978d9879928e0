"""Text-line normalization: center-of-mass dewarping + height scaling.

Canonical reimplementation of ocrolib's ``lineest.CenterNormalizer`` and
``lstm.prepare_line`` — the preprocessing baked into every trained ``.pyrnn``
model (SURVEY.md §2.10; invoked by ocropus-rpred before the BiLSTM). The
recognizer's input contract:

1. measure the smoothed vertical center of ink mass per column;
2. dewarp each column so the center lands mid-height, with half-height
   ``r = 1 + range * MAD`` (range=4 default);
3. zoom to ``target_height`` (48) with bilinear interpolation;
4. ``prepare_line``: scale to [0,1], invert so ink=1, transpose to
   (frames, height), and pad 16 zero frames on each side.

Runs host-side (scipy) in float32; per line this is ~1 ms and overlaps with
device compute in the batched pipeline.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, gaussian_filter1d, uniform_filter, zoom

DEFAULT_TARGET_HEIGHT = 48
DEFAULT_PAD = 16


class CenterNormalizer:
    def __init__(self, target_height: int = DEFAULT_TARGET_HEIGHT,
                 params=(4, 1.0, 0.3)):
        self.target_height = target_height
        self.range, self.smoothness, self.extra = params
        self.center = None
        self.r = None

    def setHeight(self, target_height: int):
        self.target_height = target_height

    def measure(self, line: np.ndarray):
        """``line`` is ink-positive (ink ~1, background 0)."""
        h, w = line.shape
        smoothed = gaussian_filter(
            line, (h * 0.5, h * self.smoothness), mode="constant"
        )
        smoothed = smoothed + 0.001 * uniform_filter(
            smoothed, (h * 0.5, w), mode="constant"
        )
        a = np.argmax(smoothed, axis=0)
        a = gaussian_filter1d(a.astype(float), h * self.extra)
        self.center = np.array(a, "i")
        deltas = np.abs(np.arange(h)[:, None] - self.center[None, :])
        if (line != 0).any():
            self.mad = float(np.mean(deltas[line != 0]))
        else:
            self.mad = h / 4.0
        self.r = int(1 + self.range * self.mad)

    def dewarp(self, img: np.ndarray, cval=0, dtype=np.float32):
        h, w = img.shape
        hpadding = self.r
        padded = np.vstack(
            [
                cval * np.ones((hpadding, w)),
                img,
                cval * np.ones((hpadding, w)),
            ]
        )
        center = self.center + hpadding
        dewarped = [
            padded[center[i] - self.r : center[i] + self.r, i] for i in range(w)
        ]
        return np.array(dewarped, dtype=dtype).T

    def normalize(self, img: np.ndarray, order=1, dtype=np.float32, cval=0):
        dewarped = self.dewarp(img, cval=cval, dtype=dtype)
        h, w = dewarped.shape
        scale = self.target_height * 1.0 / h
        return zoom(dewarped, scale, order=order, mode="constant", cval=cval)


def prepare_line(line: np.ndarray, pad: int = DEFAULT_PAD) -> np.ndarray:
    """Scale to [0,1], invert to ink=1, transpose to (frames, height), pad
    ``pad`` zero frames each side (ocrolib lstm.prepare_line semantics)."""
    line = line * 1.0 / np.amax(line)
    line = np.amax(line) - line
    line = line.T
    if pad > 0:
        w = line.shape[1]
        line = np.vstack([np.zeros((pad, w)), line, np.zeros((pad, w))])
    return line.astype(np.float32)


def normalize_strip(strip: np.ndarray, lnorm: CenterNormalizer | None = None,
                    pad: int = DEFAULT_PAD):
    """Full per-line input pipeline, from a onebit (bool, True=ink) or grey
    float strip to model frames.

    Mirrors ocropus-rpred's flow (SURVEY.md §2.10): grey line with ink dark,
    measure on the inverted copy, normalize with white cval, prepare_line.
    Returns (frames (T, target_height) float32, raw_width) or None for a
    blank strip. llocs x positions map back as
    ``x = (frame - pad) * raw_width / (T - 2 * pad)``.
    """
    if strip.dtype == bool:
        grey = 1.0 - strip.astype(np.float32)  # ink -> 0.0, background -> 1.0
    else:
        grey = strip.astype(np.float32)
        if grey.max() > 1.0:
            grey = grey / 255.0

    if lnorm is None:
        lnorm = CenterNormalizer()

    mx = float(np.amax(grey))
    temp = mx - grey  # ink-positive
    tmax = float(np.amax(temp))
    if tmax <= 0:
        return None  # blank line: nothing to recognize
    temp = temp * 1.0 / tmax
    lnorm.measure(temp)
    line = lnorm.normalize(grey, cval=mx)
    frames = prepare_line(line, pad)
    return frames, strip.shape[1]
