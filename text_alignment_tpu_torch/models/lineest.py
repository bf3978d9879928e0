"""Batched line normalization on the device, in PyTorch.

Counterpart of ``text_alignment_tpu/models/lineest_jax.py``
(``normalize_batch_device`` and its helpers): ocrolib's
``CenterNormalizer.measure`` + ``normalize`` + ``prepare_line`` for a whole
batch of padded strips at once, whose scipy canon is the JAX package's
``models/lineest.py``.

- axis-0 gaussian (sigma = h/2) as a per-strip (Hp, Hp) kernel matrix;
- axis-1 gaussian (sigma = h) as a banded block-Toeplitz matrix product
  (``_conv_rows_banded``), the one h-gauss route ported;
- the center-finding tail (uniform means, argmax, sigma = 0.3 h smoothing,
  MAD) in :mod:`.lineest_kernel`, the CUDA kernel on the card, with the
  smoothing's taps from :func:`smoothing_taps`;
- with ``TEXT_ALIGNMENT_TPU_TAIL=full`` (read at each call; onebit batches),
  the whole center chain from the ink mask in one kernel
  (:func:`.lineest_kernel.center_full`, the JAX package's
  ``lineest_pallas.center_from_temp`` route) in place of the two products and
  the tail;
- dewarp + bilinear zoom + prepare_line as two gathers with scipy zoom's
  (in-1)/(out-1) coordinate map.

Numerics: float32. The normalizer's argmax and int casts are knife edges,
so the port's entry points (``SeqRecognizer``, ``process``) call
:func:`.lstm.pin_float32`: no TF32 in cuBLAS or cuDNN and float32 matmul
precision "highest", as the reference runs every product at HIGHEST.
The sigma = 0.3 h smoothing of the argmax row and the MAD run in float64
with scipy's taps and summation order, as ocrolib's scipy normalizer does:
on a plateau of equal argmax rows the smoothed value is k * sum(taps), and
its int truncation (k or k - 1) follows the last bit of the sum (the
"knife edge" of docs/DESIGN.md), so only scipy's own arithmetic gives
scipy's center there, on every device alike. The JAX package's float32
tail leaves that edge to its summation order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .lineest_host import DEFAULT_PAD, DEFAULT_TARGET_HEIGHT
from .lineest_kernel import center_full, tail

_RANGE = 4
_SMOOTHNESS = 1.0
_EXTRA = 0.3
_TRUNCATE = 4.0
_NEG = -1e30


def _gauss_kernel_bank(sigma, kmax: int):
    """(B, kmax) gaussian taps, zero beyond each strip's radius
    int(truncate * sigma + 0.5), normalized over the full kernel (scipy)."""
    r = kmax // 2
    t = torch.arange(-r, r + 1, dtype=torch.float32,
                     device=sigma.device)[None, :]
    sigma = sigma.clamp(min=1e-6)[:, None]
    radius = torch.floor(_TRUNCATE * sigma + 0.5).int()
    w = torch.exp(-0.5 * (t / sigma) ** 2)
    w = torch.where(t.abs() <= radius.float(), w, 0.0)
    return w / w.sum(dim=1, keepdim=True)


def smoothing_taps(hs, Hp: int):
    """(B, 2 r2max + 1) float64 taps of the sigma = 0.3 h center smoothing,
    r2max = int(4 * 0.3 Hp + 0.5): each strip's weights computed as
    ``scipy.ndimage.gaussian_filter1d`` computes them (numpy, float64,
    radius int(4 sigma + 0.5), normalized by their numpy sum), centred in
    the bank with zeros beyond. Computed on the host, so that every device
    gets scipy's bits: a plateau of equal argmax rows k smooths to
    k * sum(taps), whose int truncation lands on k or k - 1 with the last
    bit of the taps. A padding strip (h = 0) gets the identity tap."""
    hs = np.asarray(hs, np.int64)
    r2max = int(_TRUNCATE * Hp * _EXTRA + 0.5)
    bank = np.zeros((len(hs), 2 * r2max + 1))
    bank[:, r2max] = 1.0
    for b, h in enumerate(hs):
        if h <= 0:
            continue
        sigma = float(h) * _EXTRA
        r = int(_TRUNCATE * sigma + 0.5)
        x = np.arange(-r, r + 1)
        phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
        bank[b] = 0.0
        bank[b, r2max - r:r2max + r + 1] = phi / phi.sum()
    return bank


def _conv_rows_banded(x, kernels):
    """Per-strip 1-D filter along the last axis with zero padding, as a
    blocked-Toeplitz matrix product: out[b, i, p] = sum_q x[b, i, q] *
    k[b, q - p + r]. Blocking W by 128, output block j sees input blocks
    j - no .. j + no (no = ceil(r / 128)) through per-strip (128, 128)
    Toeplitz tiles T[b, o, ql, pl] = k[b, (o - no) * 128 + ql - pl + r]."""
    B, R, W = x.shape
    K = kernels.shape[1]
    r = K // 2
    bs = 128
    nb = -(-W // bs)
    no = -(-r // bs)
    Wb = nb * bs
    xb = F.pad(x, (no * bs, no * bs + Wb - W)).reshape(B, R, nb + 2 * no, bs)
    q = torch.arange(bs, device=x.device)
    d = (q[None, :, None] - q[None, None, :]
         + (torch.arange(2 * no + 1, device=x.device)[:, None, None] - no)
         * bs)
    idx = (d + r).clamp(0, K - 1)
    T = kernels[:, idx.reshape(-1)].reshape(B, 2 * no + 1, bs, bs)
    T = torch.where((d.abs() <= r)[None], T, 0.0)
    out = x.new_zeros((B, R * nb, bs))
    for o in range(2 * no + 1):
        out = out + torch.bmm(xb[:, :, o:o + nb].reshape(B, R * nb, bs),
                              T[:, o])
    return out.reshape(B, R, Wb)[..., :W]


def _front(grey, hs, ws, onebit):
    """The contrast front: (grey, mx, blank, temp_f), the masked grey page,
    each strip's max grey and blank flag, and the normalized ink image
    (the ink mask itself for ``onebit``)."""
    B, Hp, Wp = grey.shape
    dev = grey.device
    valid = ((torch.arange(Hp, device=dev)[None, :, None] < hs[:, None, None])
             & (torch.arange(Wp, device=dev)[None, None, :]
                < ws[:, None, None]))
    if onebit:
        # every valid pixel is exactly 0 (ink) or 1: temp is the ink mask
        g = torch.where(valid, grey.to(torch.uint8), 1)
        ink = valid & (g == 0)
        any_ink = ink.any(dim=2).any(dim=1)
        any_bg = (valid & (g != 0)).any(dim=2).any(dim=1)
        blank = ~(any_ink & any_bg)
        mx = any_bg.float()
        temp_f = (ink & any_bg[:, None, None]).float()
        return g, mx, blank, temp_f
    grey = torch.where(valid, grey.float(), 1.0)
    mx = torch.where(valid, grey, _NEG).amax(dim=(1, 2))
    temp_f = torch.where(valid, mx[:, None, None] - grey, 0.0)
    tmax = temp_f.amax(dim=(1, 2))
    blank = tmax <= 0.0
    temp_f = temp_f / torch.where(blank, 1.0, tmax)[:, None, None]
    return grey, mx, blank, temp_f


def vgauss_bank(hs, Hp: int):
    """(B, Hp, Hp) axis-0 gaussian (sigma = 0.5 h) kernel matrices,
    normalized over the FULL kernel sum as scipy does."""
    dev = hs.device
    hf = hs.float()
    i_idx = torch.arange(Hp, device=dev)
    k0max = 2 * int(_TRUNCATE * Hp * 0.5 + 0.5) + 1
    sig0 = (0.5 * hf).clamp(min=1e-6)
    rad0 = torch.floor(_TRUNCATE * 0.5 * hf + 0.5).int()
    d0 = (i_idx[:, None] - i_idx[None, :])[None]
    w0 = torch.exp(-0.5 * (d0.float() / sig0[:, None, None]) ** 2)
    w0 = torch.where(d0.abs() <= rad0[:, None, None], w0, 0.0)
    t_full = torch.arange(-(k0max // 2), k0max // 2 + 1, dtype=torch.float32,
                          device=dev)[None, :]
    wfull = torch.exp(-0.5 * (t_full / sig0[:, None]) ** 2)
    wfull = torch.where(t_full.abs() <= rad0.float()[:, None], wfull, 0.0)
    return w0 / wfull.sum(dim=1)[:, None, None]


def hgauss_taps(hs, Hp: int):
    """(B, K1) axis-1 gaussian (sigma = smoothness * h) taps, K1 =
    2 int(4 Hp + 0.5) + 1."""
    k1max = 2 * int(_TRUNCATE * Hp * _SMOOTHNESS + 0.5) + 1
    return _gauss_kernel_bank(_SMOOTHNESS * hs.float(), k1max)


def _smoothing_taps_on(hs, Hp: int):
    return torch.from_numpy(smoothing_taps(hs.cpu().numpy(), Hp)).to(
        hs.device)


def center_inputs(grey, hs, ws, onebit=False):
    """Contrast front + v-gauss + h-gauss: everything upstream of the tail.

    Returns (grey, mx, blank, sm, temp, k2): the masked grey page, each
    strip's max grey and blank flag, the h-gauss output ``sm`` (B, Hp, Wp)
    f32, the ink mask ``temp`` (B, Hp, Wp) u8 and the tail's sigma = 0.3 h
    tap bank ``k2`` (B, K2) f64 (:func:`smoothing_taps`)."""
    Hp = grey.shape[1]
    grey, mx, blank, temp_f = _front(grey, hs, ws, onebit)
    sm = torch.bmm(vgauss_bank(hs, Hp), temp_f)
    sm = _conv_rows_banded(sm, hgauss_taps(hs, Hp))
    temp = (temp_f != 0).to(torch.uint8)
    return grey, mx, blank, sm.contiguous(), temp, _smoothing_taps_on(hs, Hp)


def _dewarp_zoom(grey, mx, center, r, hs, ws, blank, target_height, pad,
                 t_max):
    """Dewarp + bilinear zoom + prepare_line from (center, r):
    dewarped[v, x] = grey[center[x] - r + v, x] (mx outside the strip),
    v in [0, 2r), zoomed by target_height / 2r with scipy zoom's
    (in-1)/(out-1) coordinate map, then scaled to [0, 1] and inverted."""
    B, Hp, Wp = grey.shape
    dev = grey.device
    x_idx = torch.arange(Wp, device=dev)
    hs = hs.long()
    ws = ws.long()
    r = r.long()
    t_raw = torch.round(ws.float() * (target_height / (2 * r).float()))
    t_cap = t_max - 2 * pad
    t_raw = torch.where(blank, 0, t_raw.long().clamp(0, t_cap))

    # rows: out1[u, x] = (1 - fv) * D[v0, x] + fv * D[v0 + 1, x]
    greyf = grey.float()
    start = center.long() - r[:, None]                    # (B, Wp)
    u_idx = torch.arange(target_height, dtype=torch.float32, device=dev)
    src_v = u_idx[None, :] * ((2 * r).float()[:, None] - 1) / (
        target_height - 1)
    v0 = torch.floor(src_v).long()
    fv = (src_v - v0.float())[:, :, None]

    def dewarped(v):                                      # (B, th) rows
        row = v[:, :, None] + start[:, None, :]           # (B, th, Wp)
        inb = ((row >= 0) & (row < hs[:, None, None])
               & (x_idx[None, None, :] < ws[:, None, None]))
        vals = torch.gather(greyf, 1, row.clamp(0, Hp - 1))
        return torch.where(inb, vals, mx[:, None, None])

    out1 = (1 - fv) * dewarped(v0) + fv * dewarped(v0 + 1)

    # columns: z[u, t] = (1 - fx) * out1[u, x0] + fx * out1[u, x0 + 1]
    t_idx = torch.arange(t_cap, dtype=torch.float32, device=dev)
    denom = (t_raw - 1).clamp(min=1).float()
    src_x = t_idx[None, :] * (ws - 1).float()[:, None] / denom[:, None]
    x0 = torch.floor(src_x).long()
    fx = (src_x - x0.float())[:, None, :]

    def column(xi):                                       # (B, t_cap)
        g = torch.gather(out1, 2, xi.clamp(0, Wp - 1)[:, None, :].expand(
            B, target_height, t_cap))
        return torch.where(((xi >= 0) & (xi < Wp))[:, None, :], g, 0.0)

    z = (1 - fx) * column(x0) + fx * column(x0 + 1)
    tmask = t_idx[None, None, :] < t_raw[:, None, None]
    z = torch.where(tmask, z, 0.0)
    zmax = torch.where(tmask, z, _NEG).amax(dim=(1, 2))
    zmax = torch.where(t_raw > 0, zmax, 1.0)
    core = torch.where(tmask, 1.0 - z / zmax[:, None, None], 0.0)
    frames = torch.zeros((B, t_max, target_height), dtype=torch.float32,
                         device=dev)
    frames[:, pad:pad + t_cap] = core.transpose(1, 2)
    lengths = torch.where(blank | (t_raw == 0), 0, t_raw + 2 * pad)
    return frames, lengths.int(), t_raw.int()


def center_route(onebit: bool = True) -> str:
    """The center chain :func:`normalize_batch_device` takes: ``"full"``
    (the full-chain kernel) for ``onebit`` batches when
    ``TEXT_ALIGNMENT_TPU_TAIL=full``, read at each call, else ``"default"``
    (the two products and the tail)."""
    return ("full" if onebit and os.environ.get("TEXT_ALIGNMENT_TPU_TAIL")
            == "full" else "default")


def normalize_batch_device(grey, hs, ws, target_height=DEFAULT_TARGET_HEIGHT,
                           pad=DEFAULT_PAD, t_max=4096, onebit=False):
    """Batched CenterNormalizer.measure + normalize + prepare_line.

    grey: (B, Hp, Wp) float32 (or uint8 {0, 1} with ``onebit=True``),
    ink-dark (1 = background), garbage outside each strip's (hs[b], ws[b])
    region (masked here). Returns (frames (B, t_max, target_height) f32,
    lengths (B,) i32, t_raws (B,) i32); lengths = t_raw + 2 * pad, 0 for
    blank strips.

    :func:`center_route` picks the chain: ``TEXT_ALIGNMENT_TPU_TAIL=full``
    (the JAX package's switch) takes the full-chain kernel for ``onebit``
    batches; any other value the default route. The two agree but at the
    float32 knife edges of the h-gauss sums, which they take in different
    orders."""
    Hp = grey.shape[1]
    hs = hs.to(torch.int32).contiguous()
    ws = ws.to(torch.int32).contiguous()
    if center_route(onebit) == "full":
        grey, mx, blank, temp_f = _front(grey, hs, ws, onebit)
        center, dsum, dcnt = center_full(
            (temp_f != 0).to(torch.uint8), vgauss_bank(hs, Hp).contiguous(),
            hgauss_taps(hs, Hp).contiguous(), hs, ws,
            _smoothing_taps_on(hs, Hp))
    else:
        grey, mx, blank, sm, temp, k2 = center_inputs(grey, hs, ws, onebit)
        center, dsum, dcnt = tail(sm, temp, hs, ws, k2)
    # float64, as scipy's np.mean and int(1 + range * mad)
    mad = dsum.double() / dcnt.clamp(min=1).double()
    mad = torch.where(dcnt > 0, mad, hs.double() / 4.0)
    r = (1.0 + _RANGE * mad).int().clamp(1, Hp)
    return _dewarp_zoom(grey, mx, center, r, hs, ws, blank, target_height,
                        pad, t_max)
