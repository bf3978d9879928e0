"""A CPU model of the normalizer tail's schedule on the card
(``csrc/lineest_tail.cu``), and the tail cases that the CPU tests and the
card tests share.

:func:`tiled_tail` computes (center, dsum, dcnt) as the kernel's passes B
and C do, in numpy:

- the argmax as the per-column max of 64-bit keys (the order-preserving
  bits of v = sm + 0.001 u2 over Hp - 1 - i, -0.0 taken as +0.0), over rows
  i < h and columns x < w; a column with no key decodes to row 0;
- per tile of ``tile`` columns, the argmax row with a halo of ``rb``
  columns each side staged through scipy's reflect map (a read outside
  the staged window finds 0), where rb is the strip's outermost nonzero
  tap, so the smoothing skips only the taps beyond it;
- the smoothing in float64, centre term then (left + right) pairs from
  the outermost inwards, each product and sum rounded on its own;
- the MAD as one partial sum a tile, added up.

``halo_short`` (the halo that many columns short) and ``ties="last"``
(equal values resolved to the last row) are the off-by-one faults the tests
show the model catches. Imports no JAX: the card tests use it too.
"""

import numpy as np
import torch

from text_alignment_tpu_torch.models import lineest as tle
from text_alignment_tpu_torch.models.lineest_kernel import (
    CENTER_TILE, windowed_mean_h, windowed_mean_w)

_U32 = np.uint64(0xFFFFFFFF)
_SIGN = np.uint64(0x80000000)


def argmax_keys(v, hs, ws, ties="first"):
    """(B, Wp) uint64: per column the largest key over rows i < h, 0 for
    columns x >= w and strips with h = 0. v: (B, Hp, Wp) float32."""
    B, Hp, Wp = v.shape
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    bits = v.view(np.uint32).astype(np.uint64)
    bits = np.where(bits & _SIGN, ~bits & _U32, bits | _SIGN)
    rows = np.arange(Hp, dtype=np.uint64)
    low = np.uint64(Hp - 1) - rows if ties == "first" else rows
    keys = (bits << np.uint64(32)) | low[None, :, None]
    inside = ((np.arange(Hp)[None, :, None] < hs[:, None, None])
              & (np.arange(Wp)[None, None, :] < ws[:, None, None]))
    return np.where(inside, keys, np.uint64(0)).max(axis=1)


def decode_keys(keys, Hp, ties="first"):
    """The argmax row of each column as float64; 0 where there is no key."""
    low = (keys & _U32).astype(np.int64)
    rows = Hp - 1 - low if ties == "first" else low
    return np.where(keys != 0, rows, 0).astype(np.float64)


def tail_values(sm, hs, ws):
    """v = sm + 0.001 u2 (B, Hp, Wp) float32 from the plain version's
    windowed means (passes A and B's sums)."""
    B, Hp, Wp = sm.shape
    valid = ((torch.arange(Hp)[None, :, None] < hs.long()[:, None, None])
             & (torch.arange(Wp)[None, None, :] < ws.long()[:, None, None]))
    u = windowed_mean_h(torch.where(valid, sm, 0.0),
                        (0.5 * hs.float()).long())
    u = windowed_mean_w(u, ws)
    return (sm + 0.001 * u).numpy()


def strip_radius(taps):
    """The largest j whose tap is nonzero (0 for the identity tap)."""
    nz = np.nonzero(taps)[0]
    return int(nz.max()) if nz.size else 0


def tiled_tail(sm, temp, hs, ws, k2, tile=CENTER_TILE, halo_short=0,
               ties="first", skip=True):
    """(center, dsum, dcnt) as torch int32 tensors, by the kernel's
    schedule. ``skip=False`` runs every tap pair, as the plain version
    does."""
    B, Hp, Wp = sm.shape
    hs_n, ws_n = hs.numpy().astype(np.int64), ws.numpy().astype(np.int64)
    a = decode_keys(argmax_keys(tail_values(sm, hs, ws), hs_n, ws_n, ties),
                    Hp, ties)
    temp = temp.numpy()
    r2 = k2.shape[1] // 2
    center = np.zeros((B, Wp), np.int32)
    dsum = np.zeros(B, np.int64)
    dcnt = np.zeros(B, np.int64)
    for b in range(B):
        h, w = int(hs_n[b]), int(ws_n[b])
        taps = k2[b].numpy()[r2::-1]          # taps[j] = k2[b, r2 - j]
        rb = strip_radius(taps) if skip else r2
        halo = rb - halo_short
        period = 2 * max(w, 1)
        for x0 in range(0, Wp, tile):
            m = np.arange(x0 - halo, x0 + tile + halo) % period
            src = np.clip(np.where(m < w, m, period - 1 - m), 0, Wp - 1)
            staged = np.where(src < w, a[b, src], 0.0)

            def at(off):
                k = np.arange(tile) + halo + off
                ok = (k >= 0) & (k < staged.size)
                return np.where(ok, staged[np.clip(k, 0, staged.size - 1)],
                                0.0)

            acc = at(0) * taps[0]
            for j in range(rb, 0, -1):
                acc = acc + (at(-j) + at(j)) * taps[j]
            c = acc.astype(np.int32)           # truncation toward zero
            n = min(tile, Wp - x0)
            center[b, x0:x0 + n] = c[:n]
            tw = min(tile, w - x0)
            if tw > 0 and h > 0:
                ink = temp[b, :h, x0:x0 + tw] != 0
                dsum[b] += int((np.abs(np.arange(h)[:, None] - c[None, :tw])
                                * ink).sum())
                dcnt[b] += int(ink.sum())
    return (torch.from_numpy(center), torch.from_numpy(dsum.astype(np.int32)),
            torch.from_numpy(dcnt.astype(np.int32)))


# (B, Hp, Wp, kind): the folio's shape and the card test shapes of the full
# chain, then the tail's own edge cases
TAIL_CASES = [
    (12, 96, 1536, None),     # the folio's batch
    (5, 64, 512, None),
    (4, 64, 512, "full"),     # every strip h = Hp, w = Wp
    (6, 96, 1536, "narrow"),  # w of 1 to 40 columns
    (1, 96, 1536, None),      # B = 1: the one strip is padding
    (1, 48, 700, "full"),     # B = 1, h = Hp, w = Wp
    (5, 32, 300, "h1"),       # strips of one row
    (4, 96, 256, "wrap"),     # w < r2: the reflect wraps several periods
    (5, 64, 1000, "ragged"),  # w and Wp not multiples of the tile or 16
    (3, 48, 640, "ties"),     # tied maxima in a column, negative values
]


def tail_case(B, Hp, Wp, kind=None, seed=None):
    """(sm, temp, hs, ws, k2) on the CPU for a case of :data:`TAIL_CASES`:
    random ink through the port's own front and gaussians, a last padding
    strip (h = w = 0) unless every strip is ``"full"``; ``"ties"`` replaces
    sm by a hand-made one, equal on every row inside the strip, so that the
    rows whose row windows lie inside the strip tie exactly, at values
    below zero in some columns."""
    rng = np.random.default_rng(Hp + Wp if seed is None else seed)
    hs = rng.integers(Hp // 2, Hp + 1, B).astype(np.int32)
    ws = rng.integers(Wp // 8, Wp + 1, B).astype(np.int32)
    if kind == "full":
        hs[:], ws[:] = Hp, Wp
    if kind == "narrow":
        ws = rng.integers(1, 41, B).astype(np.int32)
    if kind == "h1":
        hs[:B - 1:2] = 1
    if kind == "wrap":
        ws[:] = np.array([1, 7, 40, 100])[np.arange(B) % 4]
    if kind == "ragged":
        ws[:] = np.array([129, 255, 383, Wp, 500])[np.arange(B) % 5]
    if kind == "ties":
        hs[:] = np.array([48, 40, 20])[np.arange(B) % 3]
    if kind != "full":
        hs[-1] = ws[-1] = 0  # a padding strip of the pack ladder
    grey = (rng.random((B, Hp, Wp)) > 0.12).astype(np.uint8)
    hs_t, ws_t = torch.from_numpy(hs), torch.from_numpy(ws)
    _, _, _, sm, temp, k2 = tle.center_inputs(
        torch.from_numpy(grey), hs_t, ws_t, onebit=True)
    if kind == "ties":
        levels = np.array([-1.0, -0.5, 0.5, 1.0, 2.0], np.float32)
        row = levels[rng.integers(0, len(levels), (B, 1, Wp))]
        sm = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(row, (B, Hp, Wp))))
    return sm, temp, hs_t, ws_t, k2


def plateau_case(Hp=64, Wp=384):
    """Strips whose argmax row is one row k = h // 2 on every column: the
    smoothed value is k times the taps' sum, whose truncation gives k or
    k - 1 by its last bit. Strips h = 16 .. Hp."""
    hs = np.arange(16, Hp + 1, 4).astype(np.int32)
    B = len(hs)
    ws = np.full(B, Wp, np.int32)
    sm = np.zeros((B, Hp, Wp), np.float32)
    sm[np.arange(B), hs // 2, :] = 1.0
    return (torch.from_numpy(sm), torch.zeros((B, Hp, Wp), dtype=torch.uint8),
            torch.from_numpy(hs), torch.from_numpy(ws),
            torch.from_numpy(tle.smoothing_taps(hs, Hp)))
