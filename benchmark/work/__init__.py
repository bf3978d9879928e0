"""Operations and bytes that the kernels' work needs, computed from the
shapes of their inputs (each input byte read once, each output byte
written once, valid cells only), and the card's published
peaks (NVIDIA H100 SXM): the yardstick of the roofline shares and of
``mfu``."""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12    # float32 outside the tensor cores, per second
PEAK_HBM_BYTES = 3.35e12   # bytes per second


class Work:
    """Per-kernel totals of (bytes, operations) over the traced items."""

    def __init__(self):
        self.totals: dict = {}

    def add(self, name, nbytes, ops):
        b, o = self.totals.get(name, (0, 0))
        self.totals[name] = (b + nbytes, o + ops)

    def least_seconds(self, name):
        """The least time the card could take: bytes over the HBM rate or
        operations over the float32 rate, the larger; None when no such
        work was traced."""
        if name not in self.totals:
            return None
        nbytes, ops = self.totals[name]
        return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS)


def nw_fill(nts, nos, n_rows):
    """The batched NW fill of ``n_rows`` scoring rows over pairs of
    (nts[i] + 1) x (nos[i] + 1) cells (the sentinel included): one pointer
    byte written a valid cell, the two sequences and a row's six scores
    read once; 20 integer operations a cell (three maxima of three, the
    substitution, the gap sums and the pointer packing)."""
    cells = sum((int(a) + 1) * (int(b) + 1) for a, b in zip(nts, nos))
    seq = sum(int(a) + int(b) + 2 for a, b in zip(nts, nos))
    return n_rows * (cells + 4 * seq + 24), n_rows * 20 * cells
