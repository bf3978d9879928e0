"""The page generator's skew: a onebit page rotated by nearest neighbour
through a Q16 fixed-point inverse map onto a grown canvas, a frozen copy
of the port's ``fixedpoint`` and ``oracle.rotate_onebit``."""

from __future__ import annotations

import math

import numpy as np

SCALE_BITS = 16
SCALE = 1 << SCALE_BITS
CANVAS_QUANTUM = 32


def rotated_canvas(H: int, W: int, angle_deg: float) -> tuple[int, int]:
    """The grown canvas of a rotation, rounded up to a CANVAS_QUANTUM
    multiple (symmetric white margin)."""
    r = math.radians(angle_deg)
    c, s = abs(math.cos(r)), abs(math.sin(r))
    W2 = int(math.ceil(W * c + H * s))
    H2 = int(math.ceil(H * c + W * s))
    q = CANVAS_QUANTUM
    return ((H2 + q - 1) // q) * q, ((W2 + q - 1) // q) * q


def inverse_rotation_map(H: int, W: int, H2: int, W2: int, angle_deg: float):
    """For each pixel of the H2 x W2 canvas, its source (y, x) in the H x W
    input, about the centres; out-of-range sources are background."""
    r = math.radians(angle_deg)
    cfix = int(round(math.cos(r) * SCALE))
    sfix = int(round(math.sin(r) * SCALE))
    x2 = np.arange(W2, dtype=np.int32)[None, :]
    y2 = np.arange(H2, dtype=np.int32)[:, None]
    dx2 = 2 * x2 - (W2 - 1)  # doubled offsets stay integral
    dy2 = 2 * y2 - (H2 - 1)
    sx2 = cfix * dx2 + sfix * dy2
    sy2 = -sfix * dx2 + cfix * dy2
    src_x = (sx2 + (W - 1) * SCALE + SCALE) >> (SCALE_BITS + 1)
    src_y = (sy2 + (H - 1) * SCALE + SCALE) >> (SCALE_BITS + 1)
    return src_y, src_x


def rotate_onebit(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """``img`` rotated by ``angle_deg`` about its centre onto the grown
    white canvas."""
    H, W = img.shape
    H2, W2 = rotated_canvas(H, W, angle_deg)
    src_y, src_x = inverse_rotation_map(H, W, H2, W2, angle_deg)
    valid = (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
    sy = np.clip(src_y, 0, H - 1)
    sx = np.clip(src_x, 0, W - 1)
    return img[sy, sx] & valid
