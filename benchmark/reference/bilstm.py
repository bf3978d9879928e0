"""The line recognizer's plain reference, in PyTorch: ocropy 1.3.3's
peephole LSTM (``lstm.py``'s ``LSTM.forward``), stepped in a Python loop
over time in float32, both directions, then the softmax layer with its
logits clipped to +-100. Written from ocropy's equations, not from the
program: the source vector of a step is ``[1, x_t, h_{t-1}]``; the input
and forget peepholes take the previous cell state and the output peephole
the current one, none of them at t = 0; the backward direction runs over
each line's own frames reversed.

``precision(tf32=False)`` is the reference's setting: float32 products
with TF32 off in cuBLAS and cuDNN. ``precision(tf32=True)`` is the
control's, one precision down."""

from __future__ import annotations

import contextlib

import torch

GATES = ("WGI", "WGF", "WGO", "WCI")


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 allowed or not, restored on exit."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(p)
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def reverse(xs, lengths):
    """Each line's first ``lengths[b]`` frames in reverse order, the rest
    left where they are."""
    T = xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    src = lengths.long().to(xs.device)[:, None] - 1 - t
    src = torch.where(src >= 0, src, t)
    return torch.gather(xs, 1, src[..., None].expand(-1, -1, xs.shape[2]))


def direction(W, xs):
    """One direction over (B, T, ni) frames: the (B, T, ns) outputs."""
    B, T, _ = xs.shape
    Wg = torch.cat([W[k] for k in GATES], 0)          # (4 ns, 1 + ni + ns)
    ns = W["WGI"].shape[0]
    h = xs.new_zeros((B, ns))
    c = None
    one = xs.new_ones((B, 1))
    out = []
    for t in range(T):
        source = torch.cat([one, xs[:, t], h], 1)
        gi, gf, go, ci = (source @ Wg.T).split(ns, 1)
        if c is None:
            c = torch.tanh(ci) * torch.sigmoid(gi)
        else:
            c = (torch.tanh(ci) * torch.sigmoid(gi + W["WIP"] * c)
                 + torch.sigmoid(gf + W["WFP"] * c) * c)
            go = go + W["WOP"] * c
        h = torch.tanh(c) * torch.sigmoid(go)
        out.append(h)
    return torch.stack(out, 1)


def hidden(weights, frames, lengths):
    """The softmax layer's input (B, T, 2 ns + 1), [1, forward h, backward
    h], of (B, T, ni) float32 ``frames`` whose line b has ``lengths[b]``
    valid frames; frames past a line's length are meaningless.
    ``weights``: {"fwd": {WGI, WGF, WGO, WCI (ns, 1 + ni + ns), WIP, WFP,
    WOP (ns,)}, "bwd": {...}, "W2": (nout, 2 ns + 1)}."""
    f = direction(weights["fwd"], frames)
    b = reverse(direction(weights["bwd"], reverse(frames, lengths)), lengths)
    return torch.cat([torch.ones_like(f[..., :1]), f, b], 2)


def forward(weights, frames, lengths):
    """Posteriors (B, T, nout) of ``frames`` (see :func:`hidden`)."""
    y = hidden(weights, frames, lengths)
    logits = (y @ weights["W2"].T).clamp(-100, 100)
    return torch.softmax(logits, 2)
