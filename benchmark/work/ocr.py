"""Bytes and operations of the OCR stage's work, from the shapes of its
inputs (each input byte read once, each output byte written once, valid
frames and strip pixels only)."""

from __future__ import annotations


def bilstm(lengths, ni, ns, nout):
    """The BiLSTM over lines of ``lengths`` valid frames: per frame and
    direction, the input projection (4 ns x (1 + ni), bias included), the
    recurrence's 4 ns x ns product and ~16 ns operations of the gates; per
    frame, the output layer (nout x (2 ns + 1)) and its softmax (~3 nout).
    Bytes: the frames, the weights and the posteriors once each."""
    frames = sum(int(n) for n in lengths)
    per_frame = (2 * (2 * 4 * ns * (1 + ni) + 2 * 4 * ns * ns + 16 * ns)
                 + 2 * nout * (2 * ns + 1) + 3 * nout)
    weights = 2 * (4 * ns * (1 + ni + ns) + 3 * ns) + nout * (2 * ns + 1)
    nbytes = 4 * (frames * (ni + nout) + weights)
    return nbytes, frames * per_frame


def lineest_tail(hs, ws, Hp, Wp, extra=0.3, truncate=4.0):
    """The normalizer's center tail on a batch of strips padded to (Hp,
    Wp): the smoothed image and the ink mask inside each strip's (h, w)
    read once (4 + 1 bytes a pixel), the smoothing taps (float64, a bank
    of 2 int(4 x 0.3 Hp + 0.5) + 1 a strip), (h, w) and the outputs (a
    center a column, two counts a strip); per strip the two windowed means,
    v and the argmax over h x w (4 operations a pixel), and per column the
    smoothing over the strip's nonzero taps (3 a pair of taps, and one)."""
    B = len(hs)
    k2 = 2 * int(truncate * extra * Hp + 0.5) + 1
    ops = nbytes = 0
    for h, w in zip(hs, ws):
        h, w = int(h), int(w)
        n_taps = 2 * int(truncate * extra * h + 0.5) + 1 if h > 0 else 1
        ops += 4 * h * w + Wp * (3 * (n_taps // 2) + 1)
        nbytes += 5 * h * w
    nbytes += 8 * B * k2 + 8 * B + 4 * B * Wp + 8 * B
    return nbytes, ops
