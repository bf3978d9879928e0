"""The line normalizer's center finding: the CUDA kernels
``csrc/lineest_tail.cu`` and ``csrc/lineest_full.cu`` and their plain
PyTorch versions.

Counterparts of ``text_alignment_tpu/models/lineest_pallas.py``:

- ``tail_from_sm``, the default route: from the h-gauss output ``sm``
  (B, Hp, Wp) f32, the ink mask ``temp`` (B, Hp, Wp) u8, each strip's true
  (h, w) and its sigma = 0.3 h gaussian taps ``k2`` (B, K2) f64
  (``lineest.smoothing_taps``), it computes per strip: the row windowed mean,
  the column windowed mean, the first-max row argmax of ``sm + 0.001 u``, the
  reflect-extended k2 smoothing (float64, in scipy's order) and its
  int-truncated center, and the MAD ink sums. Returns (center (B, Wp) i32,
  dsum (B,) i32, dcnt (B,) i32).
- ``center_from_temp``, the full chain (``TEXT_ALIGNMENT_TPU_TAIL=full``):
  the same from the ink mask alone, with the v-gauss bank ``w0`` (B, Hp, Hp)
  f32 and the h-gauss taps ``k1`` (B, K1) f32 computed first.

:func:`tail` and :func:`center_full` launch the kernels for CUDA tensors,
for every batch and width (no engagement gate), and run :func:`tail_reference`
and :func:`center_full_reference` for CPU tensors. The tail's reference is
the XLA tail of ``lineest_jax.normalize_batch_device`` (lineest_jax.py:514-565)
in plain torch, with the general ``mod 2w`` reflect form; its smoothing is
``scipy.ndimage.gaussian_filter1d``'s arithmetic (the JAX package's runs in
float32, so the two centers can differ by one row on a plateau). Every sum of
the plain versions runs in the order of the kernels, with each product and
sum rounded on its own, so kernel and plain version agree bit for bit on the
card: the argmax and the int truncations are knife edges. Where the kernel
computes otherwise, the result is the same bits for a reason the kernel's
source states: its argmax is a max of 64-bit keys (order-free), its
smoothing skips only taps that are exact zeros, and its MAD sums integers.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _kernels
from .._kernels import SMEM_LIMIT

_NEG = -1e30
_FULL_STATIC_SMEM = 8  # ta_full_vh's static array

_ROW_THREADS = 256  # TA_ROW_THREADS of csrc/lineest_tail.cu
CENTER_TILE = 128   # TA_CENTER_T: columns a CTA of the tail's center pass


def windowed_mean_h(x, size):
    """scipy ``uniform_filter1d`` along rows (axis 1) with a per-strip
    window ``size`` starting at i - size//2, zero padded, divided by size.
    x: (B, H, W); size: (B,). Each window is summed over its rows in
    ascending order, as the kernel's pass A does."""
    B, H, W = x.shape
    s = size.long().clamp(min=1)
    lo = torch.arange(H, device=x.device)[None, :] - s[:, None] // 2
    acc = torch.zeros_like(x)
    for d in range(int(s.max())):
        j = lo + d                                        # (B, H)
        take = (d < s[:, None]) & (j >= 0) & (j < H)
        rows = torch.gather(x, 1, j.clamp(0, H - 1)[:, :, None].expand(
            B, H, W))
        acc = acc + torch.where(take[:, :, None], rows, 0.0)
    return acc / s[:, None, None].to(x.dtype)


def windowed_mean_w(x, size):
    """scipy ``uniform_filter1d`` along columns (axis 2), same contract as
    :func:`windowed_mean_h`, as a difference of prefix sums. Each row is
    centred on its mean before the prefix sum and the mean added back with
    the exact count of in-range taps: uncentred, the f32 prefix cancels at
    large column positions and flips the center argmax downstream.

    The mean and the prefix are summed in the order of the kernel's pass B,
    one row per block of 256 threads: thread t sums columns t, t + 256, ...,
    then a halving tree over the threads; thread t scans the t-th chunk of
    ceil(W / 256) columns, the chunk totals are scanned in order, and each
    chunk adds its offset."""
    B, H, W = x.shape
    nt = _ROW_THREADS
    chunk = -(-W // nt)
    pad = nt * chunk - W
    part = torch.zeros((B, H, nt), dtype=x.dtype, device=x.device)
    strided = F.pad(x, (0, pad)).reshape(B, H, chunk, nt)
    for c in range(chunk):
        part = part + strided[:, :, c]
    k = nt // 2
    while k:
        part = torch.cat([part[..., :k] + part[..., k:2 * k], part[..., k:]],
                         dim=2)
        k //= 2
    mu = (part[..., 0] / torch.full_like(part[..., 0], W))[..., None]

    dev = F.pad(x - mu, (0, pad)).reshape(B, H, nt, chunk)
    S = torch.empty_like(dev)
    run = torch.zeros((B, H, nt), dtype=x.dtype, device=x.device)
    for c in range(chunk):
        run = run + dev[..., c]
        S[..., c] = run
    offs = torch.empty_like(run)
    off = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    for t in range(nt):
        offs[..., t] = off
        off = off + run[..., t]
    S = (S + offs[..., None]).reshape(B, H, nt * chunk)[..., :W]

    s = size.long().clamp(min=1)[:, None, None]
    c1 = s - 1 - s // 2
    c2 = s // 2 + 1
    x_idx = torch.arange(W, device=x.device)[None, None, :]
    hi_v = torch.gather(S, 2, (x_idx + c1).clamp(max=W - 1).expand(B, H, W))
    lo_v = torch.where(
        x_idx >= c2,
        torch.gather(S, 2, (x_idx - c2).clamp(min=0).expand(B, H, W)), 0.0)
    n_in = ((x_idx + c1).clamp(max=W - 1) - (x_idx - s // 2).clamp(min=0)
            + 1).to(x.dtype)
    return (hi_v - lo_v + n_in * mu) / s.to(x.dtype)


def tail_reference(sm, temp, hs, ws, k2):
    """Plain PyTorch tail (the XLA tail's math)."""
    B, Hp, Wp = sm.shape
    r2 = k2.shape[1] // 2
    dev = sm.device
    hs = hs.long()
    ws = ws.long()
    i_idx = torch.arange(Hp, device=dev)
    x_idx = torch.arange(Wp, device=dev)
    row_ok = i_idx[None, :, None] < hs[:, None, None]
    valid = row_ok & (x_idx[None, None, :] < ws[:, None, None])

    sm_z = torch.where(valid, sm, 0.0)
    u = windowed_mean_h(sm_z, (0.5 * hs.float()).long())
    u = windowed_mean_w(u, ws)
    smc = torch.where(row_ok, sm + 0.001 * u, _NEG)
    a = smc.argmax(dim=1).float()                         # first max
    a = torch.where(x_idx[None, :] < ws[:, None], a, 0.0)

    # scipy 'reflect': (d c b a | a b c d | d c b a), period 2w
    ext = torch.arange(-r2, Wp + r2, device=dev)[None, :]
    period = 2 * ws.clamp(min=1)[:, None]
    m = torch.remainder(ext, period)
    src = torch.where(m < ws[:, None], m, period - 1 - m).clamp(0, Wp - 1)
    a_ext = torch.gather(a.double(), 1, src)              # (B, Wp + 2 r2)
    # float64 in scipy's correlate1d order for symmetric taps: the centre
    # term, then (left + right) pairs from the outermost inwards, each
    # product and sum rounded on its own, as the kernel does
    a_s = a_ext[:, r2:r2 + Wp] * k2[:, r2:r2 + 1]
    for j in range(r2, 0, -1):
        pair = a_ext[:, r2 - j:r2 - j + Wp] + a_ext[:, r2 + j:r2 + j + Wp]
        a_s = a_s + pair * k2[:, r2 - j:r2 - j + 1]
    center = a_s.to(torch.int32)                          # truncation

    deltas = (i_idx[None, :, None] - center[:, None, :]).abs()
    ink = (temp != 0) & valid
    dsum = torch.where(ink, deltas, 0).sum(dim=(1, 2)).to(torch.int32)
    dcnt = ink.sum(dim=(1, 2)).to(torch.int32)
    return center, dsum, dcnt


def tail_plan(B, Hp, Wp, K2, device=None):
    """The tail's three launches as ``csrc/lineest_tail.cu`` plans them
    (``ta_lineest_tail_plan``): for pass A, B and C, the grid, the threads
    a CTA, the shared bytes a CTA (dynamic and static) and the registers a
    thread."""
    out = (ctypes.c_int * 15)()
    _kernels.check(_kernels.lib().ta_lineest_tail_plan(
        B, Hp, Wp, K2, torch.device(device or "cuda").index or 0, out),
        "lineest_tail plan")
    return [{"pass": name, "grid": (out[5 * k], out[5 * k + 1]),
             "threads": out[5 * k + 2], "smem": out[5 * k + 3],
             "regs": out[5 * k + 4]} for k, name in enumerate("ABC")]


@functools.lru_cache(maxsize=64)
def _tail_smem(Hp, Wp, K2, index):
    """The most shared bytes a CTA of the tail's launches takes."""
    return max(p["smem"] for p in tail_plan(1, Hp, Wp, K2,
                                            torch.device("cuda", index)))


def _tail_buffers(B, Hp, Wp, dev):
    """(scratch, keys, center, dsum, dcnt): the tail's scratch u (B, Hp, Wp)
    f32 and argmax keys (B, Wp) u64 (int64 storage), and its outputs; the
    caller holds them until the launch has run."""
    return (torch.empty((B, Hp, Wp), dtype=torch.float32, device=dev),
            torch.empty((B, Wp), dtype=torch.int64, device=dev),
            torch.empty((B, Wp), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def tail_cuda(sm, temp, hs, ws, k2):
    """Launch ``csrc/lineest_tail.cu`` on PyTorch's current stream."""
    B, Hp, Wp = sm.shape
    K2 = k2.shape[1] if k2.ndim == 2 else -1
    dev = sm.device
    for name, t, dtype, shape in (
            ("sm", sm, torch.float32, (B, Hp, Wp)),
            ("temp", temp, torch.uint8, (B, Hp, Wp)),
            ("hs", hs, torch.int32, (B,)),
            ("ws", ws, torch.int32, (B,)),
            ("k2", k2, torch.float64, (B, K2))):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lineest_tail: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if B == 0 or K2 % 2 == 0:
        raise ValueError(f"lineest_tail: bad shapes sm {tuple(sm.shape)}, "
                         f"k2 {tuple(k2.shape)}")
    smem = _tail_smem(Hp, Wp, K2, dev.index)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"lineest_tail: (Hp, Wp, K2) = ({Hp}, {Wp}, {K2}) needs {smem} "
            f"bytes of shared memory, over what one block can use")
    scratch, keys, center, dsum, dcnt = _tail_buffers(B, Hp, Wp, dev)
    code = _kernels.lib().ta_lineest_tail(
        sm.data_ptr(), temp.data_ptr(), hs.data_ptr(), ws.data_ptr(),
        k2.data_ptr(), B, Hp, Wp, K2, scratch.data_ptr(), keys.data_ptr(),
        center.data_ptr(), dsum.data_ptr(), dcnt.data_ptr(), dev.index,
        _kernels.stream_handle(dev))
    _kernels.check(code, "lineest_tail launch")
    _kernels.launches["lineest_tail"] += 1
    return center, dsum, dcnt


def tail(sm, temp, hs, ws, k2):
    """(center, dsum, dcnt): the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if sm.device.type == "cuda":
        return tail_cuda(sm, temp, hs, ws, k2)
    if sm.device.type == "cpu":
        return tail_reference(sm, temp, hs, ws, k2)
    raise ValueError(f"lineest_tail: no version for device {sm.device}")


def vgauss_reference(temp, w0):
    """sm1 = w0 @ (temp != 0) per strip, summed over j ascending with one
    rounding a term, as the full kernel's pass V does (each product
    w0 * {0, 1} is exact)."""
    ink = (temp != 0).to(torch.float32)
    acc = torch.zeros(ink.shape, dtype=torch.float32, device=ink.device)
    for j in range(ink.shape[1]):
        acc = acc + w0[:, :, j:j + 1] * ink[:, j:j + 1, :]
    return acc


def hgauss_reference(sm1, k1):
    """sm[p] = sum_t sm1[p - r + t] * k1[t] per strip, zero outside
    [0, Wp), summed over t ascending with the product and the sum each
    rounded, as the full kernel's pass H does. Taps that are zero for every
    strip add exact zeros and are skipped."""
    B, Hp, Wp = sm1.shape
    K1 = k1.shape[1]
    xp = F.pad(sm1, (K1 // 2, K1 // 2))
    acc = torch.zeros_like(sm1)
    for t in torch.nonzero((k1 != 0).any(dim=0)).flatten().tolist():
        acc = acc + xp[:, :, t:t + Wp] * k1[:, t, None, None]
    return acc


def center_full_reference(temp, w0, k1, hs, ws, k2):
    """Plain PyTorch full chain: the v-gauss, the h-gauss, then the tail."""
    sm = hgauss_reference(vgauss_reference(temp, w0), k1)
    return tail_reference(sm, temp, hs, ws, k2)


def center_full_cuda(temp, w0, k1, hs, ws, k2):
    """Launch ``csrc/lineest_full.cu`` on PyTorch's current stream.

    The kernel computes the h-gauss output only inside each strip's (h, w)
    and sums only the rows j < h of the v-gauss: exact where ``temp`` is
    zero outside each strip's (h, w), as on every batch the normalizer
    builds (``lineest._front`` masks it)."""
    B, Hp, Wp = temp.shape
    K1 = k1.shape[1] if k1.ndim == 2 else -1
    K2 = k2.shape[1] if k2.ndim == 2 else -1
    dev = temp.device
    for name, t, dtype, shape in (
            ("temp", temp, torch.uint8, (B, Hp, Wp)),
            ("w0", w0, torch.float32, (B, Hp, Hp)),
            ("k1", k1, torch.float32, (B, K1)),
            ("hs", hs, torch.int32, (B,)),
            ("ws", ws, torch.int32, (B,)),
            ("k2", k2, torch.float64, (B, K2))):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lineest_full: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if B == 0 or K1 % 2 == 0 or K2 % 2 == 0:
        raise ValueError(f"lineest_full: bad shapes temp {tuple(temp.shape)}, "
                         f"k1 {tuple(k1.shape)}, k2 {tuple(k2.shape)}")
    L = _kernels.lib()
    smem = max(int(L.ta_lineest_full_smem(Hp, Wp, K1)) + _FULL_STATIC_SMEM,
               _tail_smem(Hp, Wp, K2, dev.index))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"lineest_full: (Hp, Wp, K1, K2) = ({Hp}, {Wp}, {K1}, {K2}) "
            f"needs {smem} bytes of shared memory, over what one block can "
            f"use")
    scratch, keys, center, dsum, dcnt = _tail_buffers(B, Hp, Wp, dev)
    sm = torch.empty((B, Hp, Wp), dtype=torch.float32, device=dev)
    code = L.ta_lineest_full(
        temp.data_ptr(), w0.data_ptr(), k1.data_ptr(), hs.data_ptr(),
        ws.data_ptr(), k2.data_ptr(), B, Hp, Wp, K1, K2, scratch.data_ptr(),
        sm.data_ptr(), keys.data_ptr(), center.data_ptr(), dsum.data_ptr(),
        dcnt.data_ptr(), dev.index, _kernels.stream_handle(dev))
    _kernels.check(code, "lineest_full launch")
    _kernels.launches["lineest_full"] += 1
    return center, dsum, dcnt


def center_full(temp, w0, k1, hs, ws, k2):
    """(center, dsum, dcnt) from the ink mask: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if temp.device.type == "cuda":
        return center_full_cuda(temp, w0, k1, hs, ws, k2)
    if temp.device.type == "cpu":
        return center_full_reference(temp, w0, k1, hs, ws, k2)
    raise ValueError(f"lineest_full: no version for device {temp.device}")
