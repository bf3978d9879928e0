"""The OCR stage's decode, in NumPy: frozen copies of the port's region
decode (ocropy's ``lstm.translate_back(outputs, pos=1)``), of
``ocropus-rpred --llocs``'s x positions and of the llocs -> CharBox
mapping (alignToOCR.py:153-184).

A region is a maximal run of frames whose blank posterior is below 0.7;
it emits the (frame, class) of its largest posterior over the whole
frames x classes block, the first in row-major order on ties (class 0
included: an ocropy quirk)."""

from __future__ import annotations

import numpy as np

from .charbox import CharBox

THRESHOLD = 0.7


def regions(post, threshold=THRESHOLD):
    """[(start, end, frame, class)] of one line's (T, C) posteriors, its
    valid frames only."""
    below = post[:, 0] < threshold
    out, t, T = [], 0, len(post)
    while t < T:
        if not below[t]:
            t += 1
            continue
        s = t
        while t < T and below[t]:
            t += 1
        r, c = divmod(int(np.argmax(post[s:t])), post.shape[1])
        out.append((s, t, s + r, c))
    return out


def llocs_x(frame, raw_width, length, pad):
    """A frame's x in the strip, with one decimal, as ocropus-rpred writes
    it."""
    scale = raw_width * 1.0 / (length - 2 * pad)
    return float("%.1f" % ((int(frame) - pad) * scale))


def page_x(frame, raw_width, length, pad, offset_x):
    """A frame's x on the page, as the CharBox mapping rounds it."""
    return int(np.round(llocs_x(frame, raw_width, length, pad) + offset_x))


def charboxes(lines):
    """The page's CharBoxes from per-line llocs: ``lines`` holds, per
    strip, (offset_x, offset_y, height, [(char, x), ...]) with height =
    nrows - 1. A box spans from the previous llocs x (the strip's left
    edge first) to its own; '~' and '' are dropped but move that edge."""
    out = []
    for x_min, y_min, height, rows in lines:
        prev = x_min
        for ch, x in rows:
            cur = int(np.round(float(x) + x_min))
            if ch not in ("~", ""):
                out.append(CharBox(ch, (prev, y_min), (cur, y_min + height)))
            prev = cur
    return out
