"""A CPU model of the NW traceback kernel's window schedule
(``text_alignment_tpu_torch/csrc/nw_traceback.cu``), shared by the CPU
tests (``test_torch_nw.py``, against ``nw_jax`` and the Pallas kernel) and
the card tests (``test_torch_cuda.py``, against the kernel's window and
miss counts)."""

import numpy as np

from text_alignment_tpu_torch.align.nw_kernel import TB_SCHEDULE


class WindowEscape(AssertionError):
    """The model read a cell outside the window it walks in."""


# The traceback kernel's schedule constants.
TB_KERNEL = TB_SCHEDULE
# Windows shrunk so that a pair of a few hundred characters hops often.
TB_SMALL = dict(TH=24, TW=12, U=4, MD=6, MI=3, ALIGN=4)


def windowed_walk(packed, nts, nos, TH, TW, U, MD, MI, ALIGN, extra=0):
    """The traceback kernel's window schedule on the CPU, pair by pair.

    A window is TH diagonals x TW lanes of the (B * D, L) pointer bytes at
    (b * D + d0, i0), zeros past the tensor (the TMA copy). The first window
    has the end cell as its top-right corner; on entering a window the next
    is predicted: the path goes on from the cursor with the last hop's
    slope to the edge where it leaves the current window, and the next
    window's top-right corner is MD diagonals and MI lanes above and right
    of that point, never above or right of the cursor (lane origins rounded
    up to ALIGN, origins >= 0). From the cursor, S = min(ws, min(xpt, ypt))
    with ws = min((d - d0) >> 1, i - i0) + 1 (plus ``extra``, the
    mutation the tests make) steps are safe: S >= U walks whole blocks of U,
    S < U with ws > min(xpt, ypt) walks S single steps, and otherwise the
    walk switches to the predicted window if it holds the cursor with
    min(U, min(xpt, ypt)) safe steps, or stages one at the cursor (a miss).
    Every cell read is checked against the window (WindowEscape).

    Returns the wires (B, 3 + P) [k, xpt, ypt, ops...], the window and
    miss counts in the two last slots as the kernel writes them, and per
    pair the list of window edges ("d" or "i") the walk switched at and the
    origins of its windows."""
    B, D, L = packed.shape
    P = D + 1
    flat = packed.reshape(B * D, L)
    wires = np.zeros((B, 3 + P), np.int32)
    log = []

    def stage(b, td, ti):
        d0 = max(td - TH + 1, 0)
        i0 = max((ti - TW + ALIGN) & ~(ALIGN - 1), 0)
        win = np.zeros((TH, TW), np.uint8)
        part = flat[b * D + d0:b * D + d0 + TH, i0:i0 + TW]
        win[:part.shape[0], :part.shape[1]] = part
        return d0, i0, win

    def safe(d, i, w):
        d0, i0, _ = w
        if not (d0 <= d < d0 + TH and i0 <= i < i0 + TW):
            return 0
        return min((d - d0) >> 1, i - i0) + 1 + extra

    for b in range(B):
        i = int(nts[b]) - 1
        d = i + int(nos[b]) - 1
        k = windows = misses = 0
        edges, origins = [], []
        ops = wires[b, 3:]
        if i > 0 and d - i > 0:
            cur = stage(b, d, i)
            windows += 1
            origins.append(cur[:2])
            pd, pi = d + 2, i + 1
            mpt = int(cur[2][d - cur[0], i - cur[1]]) & 3
            nxt, enter = None, True
            while True:
                cd0, ci0, win = cur
                if enter:
                    enter = False
                    dd, di = max(pd - d, 1), max(pi - i, 0)
                    ed, ei = d - cd0 + 1, i - ci0 + 1
                    if di == 0 or ed * di <= ei * dd:
                        xd, xi = cd0 - 1, i - ed * di // dd
                    else:
                        xd, xi = d - ei * dd // di, ci0 - 1
                    nxt = stage(b, min(xd + MD, d), min(xi + MI, i))
                    windows += 1
                    origins.append(nxt[:2])
                    pd, pi = d, i
                term = min(i, d - i)
                if term <= 0:
                    break
                ws = min((d - cd0) >> 1, i - ci0) + 1 + extra
                S = min(ws, term)
                if S < U and ws <= term:
                    edges.append("d" if (d - cd0) >> 1 < i - ci0 else "i")
                    hit = nxt is not None and safe(d, i, nxt) >= min(U, term)
                    if hit:
                        cur = nxt
                    else:
                        cur = stage(b, d, i)
                        windows += 1
                        misses += 1
                        origins.append(cur[:2])
                    nxt, enter = None, True
                    continue
                for _ in range(S // U * U if S >= U else S):
                    if not (cd0 <= d < cd0 + TH and ci0 <= i < ci0 + TW):
                        raise WindowEscape(f"pair {b}: step {k} reads "
                                           f"({d}, {i}) outside window "
                                           f"({cd0}, {ci0})")
                    cell = int(win[d - cd0, i - ci0])
                    ops[k] = mpt
                    k += 1
                    dx, dy = int(mpt != 2), int(mpt != 1)
                    d, i = d - dx - dy, i - dx
                    mpt = (cell >> (2 * mpt)) & 3
        wires[b, :3] = (k, i, d - i)
        wires[b, -2:] = (windows, misses)
        log.append((edges, origins))
    return wires, log
