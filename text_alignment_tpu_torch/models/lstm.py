"""Batched BiLSTM + softmax line recognizer (inference), in PyTorch.

Counterpart of ``text_alignment_tpu/models/lstm_jax.py``; semantics are
pinned by ``models/lstm_np.py`` of the JAX package (ocropy LSTM with
peepholes and the t = 0 output-peephole skip). Variable-length lines are
padded to a common T; the backward direction runs over each line's
length-reversed frames, so padding never reaches the carry.

The input projection of every frame and the output ``W2`` product are
``torch.matmul``; the recurrence between them is
:func:`.lstm_kernel.bidir_scan` (the CUDA kernel on the card). Float32
throughout; the port's entry points pin full-float32 matmuls
(:func:`pin_float32`), as the reference runs every product at HIGHEST.

Training (:mod:`.train`) differentiates :func:`bilstm_logits`, whose
recurrence is :func:`bidir_scan_train`: plain torch ops that autograd
records, the counterpart of the JAX package's ``_bidir_scan`` (the kernel
has no backward pass; the reference, too, trains through its XLA scan and
not through its kernel). :class:`BiLSTM` holds the trainable weights.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lstm_kernel import bidir_scan

_GATES = ("WGI", "WGF", "WGO", "WCI")  # fused gate order, lstm_jax.py:87


def pin_float32() -> None:
    """Full float32 for cuBLAS and cuDNN: no TF32 (cuDNN's default is TF32,
    which keeps ~3 decimal digits and would move normalizer argmaxes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class LSTMParams(NamedTuple):
    WGI: torch.Tensor  # (ns, na), na = 1 + ni + ns
    WGF: torch.Tensor
    WGO: torch.Tensor
    WCI: torch.Tensor
    WIP: torch.Tensor  # (ns,)
    WFP: torch.Tensor
    WOP: torch.Tensor


class BiLSTMParams(NamedTuple):
    fwd: LSTMParams
    bwd: LSTMParams
    W2: torch.Tensor  # (nout, 2 * ns + 1)

    def to(self, device) -> "BiLSTMParams":
        return BiLSTMParams(
            LSTMParams(*(t.to(device) for t in self.fwd)),
            LSTMParams(*(t.to(device) for t in self.bwd)),
            self.W2.to(device))


def init_params_np(rng, ni: int, ns: int, nout: int,
                   initial_range: float = 0.1):
    """Random weights in the numpy-dict format (uniform in
    +-initial_range, the ocropy init), drawn from the numpy Generator
    ``rng`` so that both packages can be handed the same weights."""
    na = 1 + ni + ns

    def u(*shape):
        return rng.uniform(-initial_range, initial_range,
                           shape).astype(np.float32)

    def lstm():
        return {"WGI": u(ns, na), "WGF": u(ns, na), "WGO": u(ns, na),
                "WCI": u(ns, na), "WIP": u(ns), "WFP": u(ns), "WOP": u(ns)}

    return {"fwd": lstm(), "bwd": lstm(), "W2": u(nout, 2 * ns + 1)}


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under
    ``key`` = (k0, k1), uint32 numpy arrays: the JAX package's PRNG."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _threefry_counts(key, n: int):
    """The two words of ``n`` counters 0..n-1 under ``key`` (JAX's
    partitionable threefry: high word 0, low word the index)."""
    with np.errstate(over="ignore"):
        return _threefry2x32(key, np.zeros(n, np.uint32),
                             np.arange(n, dtype=np.uint32))


def _threefry_split(key, n: int):
    b0, b1 = _threefry_counts(key, n)
    return list(zip(b0, b1))


def _threefry_uniform(key, shape, lo: float, hi: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``, bit for bit:
    23 random mantissa bits as a float in [1, 2), minus 1, then scaled
    and shifted with one rounding (XLA's fused multiply-add on the CPU;
    exact here in float64, since the product of two float32s is)."""
    b0, b1 = _threefry_counts(key, int(np.prod(shape)))
    one = np.float32(1.0).view(np.uint32)
    f = ((b0 ^ b1) >> np.uint32(9) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(lo), np.float32(hi)
    x = (f.astype(np.float64) * np.float64(hi - lo)
         + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, x).reshape(shape)


def init_params_seeded(seed: int, ni: int, ns: int, nout: int,
                       initial_range: float = 0.1):
    """The JAX package's ``init_bilstm(PRNGKey(seed), ni, ns, nout)``
    weights, bit for bit, in the numpy-dict format, drawn with numpy alone
    (Threefry-2x32, JAX's default PRNG with partitionable splits): so a
    trainer of either package starts from the same weights for a seed."""
    na = 1 + ni + ns
    k_fwd, k_bwd, k_w2 = _threefry_split((0, seed & 0xFFFFFFFF), 3)

    def lstm(key):
        ks = _threefry_split(key, 7)
        shapes = [(ns, na)] * 4 + [(ns,)] * 3
        return {name: _threefry_uniform(k, shape, -initial_range,
                                        initial_range)
                for name, k, shape in zip(LSTMParams._fields, ks, shapes)}

    return {"fwd": lstm(k_fwd), "bwd": lstm(k_bwd),
            "W2": _threefry_uniform(k_w2, (nout, 2 * ns + 1),
                                    -initial_range, initial_range)}


def params_from_np(d, device="cpu") -> BiLSTMParams:
    """BiLSTMParams from the numpy-dict format of lstm_np / pyrnn
    ({'fwd': {...}, 'bwd': {...}, 'W2': ...})."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def conv(W):
        return LSTMParams(**{k: t(W[k]) for k in LSTMParams._fields})

    return BiLSTMParams(conv(d["fwd"]), conv(d["bwd"]), t(d["W2"]))


def params_from_jax(d, device="cpu") -> BiLSTMParams:
    """Weights carried across from the JAX package: ``d`` is the output of
    ``lstm_jax.params_to_np`` (the same dict format as pyrnn's)."""
    return params_from_np(d, device)


def params_to_np(p: BiLSTMParams):
    """The numpy-dict format of lstm_np / pyrnn from BiLSTMParams."""
    def conv(W):
        return {k: v.detach().cpu().numpy() for k, v in W._asdict().items()}

    return {"fwd": conv(p.fwd), "bwd": conv(p.bwd),
            "W2": p.W2.detach().cpu().numpy()}


def params_leaves(p: BiLSTMParams) -> list:
    """The 15 weight tensors in BiLSTMParams order: fwd (WGI, WGF, WGO, WCI,
    WIP, WFP, WOP), bwd, W2 (the JAX package's pytree order too)."""
    return [*p.fwd, *p.bwd, p.W2]


def params_from_leaves(leaves) -> BiLSTMParams:
    n = len(LSTMParams._fields)
    return BiLSTMParams(LSTMParams(*leaves[:n]),
                        LSTMParams(*leaves[n:2 * n]), leaves[2 * n])


def _reverse_by_length(xs, lengths):
    """Per-sequence reversal of the valid prefix: out[b, t] = xs[b, L_b-1-t]
    for t < L_b, else 0. The gather's index is a permutation of each row
    (frames past L_b map to themselves before the mask zeroes them), so
    its backward adds into no element twice: no atomics decide an order
    on the card."""
    B, T = xs.shape[0], xs.shape[1]
    t_idx = torch.arange(T, device=xs.device)[None, :]
    src = lengths.long()[:, None] - 1 - t_idx
    valid = src >= 0
    src = torch.where(valid, src, t_idx)
    if xs.ndim == 3:
        gathered = torch.gather(xs, 1, src[..., None].expand(-1, -1,
                                                           xs.shape[2]))
        return torch.where(valid[..., None], gathered, 0.0)
    return torch.where(valid, torch.gather(xs, 1, src), 0)


def _fuse(W: LSTMParams, ni: int):
    """(bias (4ns,), Wx (4ns, ni), Wh (4ns, ns)) of one direction."""
    Wg = torch.cat([getattr(W, k) for k in _GATES], dim=0)  # (4ns, na)
    return Wg[:, 0], Wg[:, 1:1 + ni], Wg[:, 1 + ni:]


def scan_inputs(params: BiLSTMParams, xs, lengths):
    """The recurrence's inputs: gx (2, T, B, 4ns), whT (2, ns, 4ns) and
    peep (2, 3, ns), as :func:`.lstm_kernel.bidir_scan` takes them."""
    ni = xs.shape[2]
    bias_f, Wx_f, Wh_f = _fuse(params.fwd, ni)
    bias_b, Wx_b, Wh_b = _fuse(params.bwd, ni)
    xs2 = torch.stack([xs, _reverse_by_length(xs, lengths)])  # (2,B,T,ni)
    Wx = torch.stack([Wx_f, Wx_b])                             # (2,4ns,ni)
    bias = torch.stack([bias_f, bias_b])                       # (2,4ns)
    gx = (torch.einsum("dbti,dgi->dtbg", xs2, Wx)
          + bias[:, None, None, :]).contiguous()
    whT = torch.stack([Wh_f.T, Wh_b.T]).contiguous()          # (2,ns,4ns)
    peep = torch.stack([
        torch.stack([W.WIP, W.WFP, W.WOP]) for W in (params.fwd, params.bwd)
    ]).contiguous()                                            # (2,3,ns)
    return gx, whT, peep


def _logits(params: BiLSTMParams, hs, lengths):
    """(B, T, nout) logits clipped to +-100 from the recurrence's h
    (2, T, B, ns): [1, forward h, backward h re-reversed] times W2."""
    f = hs[0].transpose(0, 1)                      # (B, T, ns)
    b = _reverse_by_length(hs[1].transpose(0, 1), lengths)
    y = torch.cat([torch.ones_like(f[..., :1]), f, b], dim=2)
    return torch.matmul(y, params.W2.T).clamp(-100, 100)


def bilstm_forward_batched(params: BiLSTMParams, xs, lengths):
    """xs: (B, T, ni) padded frames; lengths: (B,) valid frame counts.
    Returns (B, T, nout) posteriors: softmax over the full padded T, logits
    clipped to +-100 (frames past a line's length are meaningless and
    masked by the decoder)."""
    gx, whT, peep = scan_inputs(params, xs, lengths)
    logits = _logits(params, bidir_scan(gx, whT, peep), lengths)
    e = torch.exp(logits)
    return e / e.sum(dim=2, keepdim=True)


def bidir_scan_train(gx, whT, peep):
    """The recurrence of :func:`.lstm_kernel.bidir_scan` (same layouts:
    gx (2, T, B, 4ns), whT (2, ns, 4ns), peep (2, 3, ns) -> h (2, T, B,
    ns)) in torch ops that autograd differentiates: one batched
    (2, B, ns) @ (2, ns, 4ns) product a step for both directions, then the
    gates, with the peepholes left out at t = 0 as ``lstm_jax._bidir_scan``
    leaves them (its ``not_first``). The training forward; a Python loop
    over T of ten ops, fast enough to train but not to serve."""
    _, _, B, G = gx.shape
    ns = G // 4
    wif = peep[:, None, :2, :]                 # (2, 1, 2, ns): WIP, WFP
    wop = peep[:, None, 2, :]                  # (2, 1, ns)
    h = gx.new_zeros((2, B, ns))
    c = None
    out = []
    # unbind, not gx[:, t]: the backward of T selects would each add into
    # a zeroed copy of the whole gx
    for gx_t in gx.unbind(1):
        g = torch.baddbmm(gx_t, h, whT).view(2, B, 4, ns)  # [gi|gf|go|ci]
        if c is None:
            gif = torch.sigmoid(g[:, :, :2])
            c = torch.tanh(g[:, :, 3]) * gif[:, :, 0]
            go = g[:, :, 2]
        else:
            gif = torch.sigmoid(torch.addcmul(g[:, :, :2], wif,
                                              c[:, :, None]))
            c = torch.addcmul(torch.tanh(g[:, :, 3]) * gif[:, :, 0],
                              gif[:, :, 1], c)
            go = torch.addcmul(g[:, :, 2], wop, c)
        h = torch.tanh(c) * torch.sigmoid(go)
        out.append(h)
    return torch.stack(out, 1)


def bilstm_logits(params: BiLSTMParams, xs, lengths):
    """(B, T, nout) UN-normalized logits, clipped like the reference's
    softmax layer: the training forward (the JAX package's
    ``train.bilstm_logits``), differentiable in ``params``."""
    gx, whT, peep = scan_inputs(params, xs, lengths)
    return _logits(params, bidir_scan_train(gx, whT, peep), lengths)


class BiLSTM(torch.nn.Module):
    """The trainable weights: the 15 tensors of BiLSTMParams as
    ``nn.Parameter``s, in :func:`params_leaves` order (which is also the
    order of ``parameters()``, and so of the optimizer's state)."""

    def __init__(self, params: BiLSTMParams):
        super().__init__()
        self.leaves = torch.nn.ParameterList(
            [torch.nn.Parameter(t.detach().clone())
             for t in params_leaves(params)])

    def forward(self, xs, lengths):
        """Training logits (:func:`bilstm_logits`) of the live weights."""
        return bilstm_logits(params_from_leaves(list(self.leaves)), xs,
                             lengths)

    def params(self) -> BiLSTMParams:
        """A copy of the weights, detached, as :class:`..recognizer.
        SeqRecognizer` takes them: later steps do not change it."""
        return params_from_leaves([t.detach().clone() for t in self.leaves])
