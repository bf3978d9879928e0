"""One training step of kraken's default recognizer, the plain reference of
the ``kraken_train`` configuration, in PyTorch, float32: the loss and the
weights' gradients of ``RECOGNITION_SPEC`` (``kraken/lib/
default_specs.py``) with ``O1c<classes>`` under the loss of ``kraken/lib/
train.py``'s ``RecognitionModel`` (``nn.CTCLoss(reduction="sum",
zero_infinity=True)`` over the log-softmax), given the step's dropout
masks. Written from the spec and the CTC recursion, not from the program;
it imports nothing of the program.

One line at a time, at its own length L, in plain ops:

- the four convolutions (kernel kh x kw, zero padding (kh // 2, kw // 2),
  bias, ReLU), each followed by its dropout site's mask (one value a
  channel), a 2 x 2 max-pool (floor) after the first three;
- the height folded into the features channel-major (feature c * H3 + y),
  L // 8 frames;
- each LSTM layer's two directions as a per-frame loop of ``torch.nn.
  LSTM``'s cell (gate rows i, f, g, o; both biases; no peepholes), the
  backward direction over the line's frames reversed; after layers 1 and
  2 a mask of one value a feature, after layer 3 one a value;
- the head and the log-softmax;
- CTC as the log-space alpha recursion over the label with blanks between
  and around (Graves et al. 2006); an infeasible line (fewer frames than
  the label and its repeated neighbours need) gives loss 0 and no
  gradient, as ``zero_infinity`` does;
- the gradients by autograd;
- the update as Adam's Algorithm 1 (Kingma and Ba 2015) from the moments
  before the step: :func:`adam_update`.

The summed loss is a sum over lines, so the step's loss and gradients are
the sums of the lines'.

Where it departs from kraken, as the program does: kraken's padded
batches do not mask, while here each line is alone at its own width
(the program masks every column past a line's width before each
convolution, which equals kraken at batch 1); the channel-major fold, the
input frames (the port's center normalizer at 120 rows, ink 1) and the
weights' layout are ``reference/vgsl.py``'s.

Weights: ``reference/vgsl.py``'s dict. A line: ``{"x": (L, height)
frames, "labels": [class, ...], "masks": [7 masks]}``, the masks in site
order: four (C,) after the convolutions, two (2 ns,) after LSTM layers 1
and 2, one (L // 8, 2 ns) after layer 3, each 0 or 1 / (1 - p).
``bilstm.precision(tf32=False)`` is the reference's setting, ``True`` the
control's."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bilstm import precision
from .vgsl import KEYS

NEG = -1e30   # log of zero, finite so that no gradient turns into NaN


def leaves(w):
    """The weight tensors of ``w`` in a fixed order: each convolution's
    weight and bias, each layer's forward then backward direction
    (weight_ih, weight_hh, bias_ih, bias_hh), W, b."""
    out = [t for wb in w["conv"] for t in wb]
    for layer in w["lstm"]:
        out += [layer[d][k] for d in ("fwd", "bwd") for k in KEYS]
    return out + [w["W"], w["b"]]


def bilstm(layer, x):
    """One bidirectional layer over (T, nin): (T, 2 ns), [forward;
    backward] a frame; both directions stepped together, frame by frame."""
    f, b = layer["fwd"], layer["bwd"]
    gx = torch.stack([x @ f["weight_ih"].T + f["bias_ih"] + f["bias_hh"],
                      x.flip(0) @ b["weight_ih"].T + b["bias_ih"]
                      + b["bias_hh"]])                       # (2, T, 4 ns)
    whT = torch.stack([f["weight_hh"].T, b["weight_hh"].T])  # (2, ns, 4 ns)
    ns = whT.shape[1]
    h = x.new_zeros((2, 1, ns))
    c = x.new_zeros((2, 1, ns))
    out = []
    for t in range(x.shape[0]):
        g = gx[:, t:t + 1] + torch.bmm(h, whT)               # (2, 1, 4 ns)
        i, fg, gg, o = g.split(ns, dim=2)
        c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    hs = torch.cat(out, dim=1)                               # (2, T, ns)
    return torch.cat([hs[0], hs[1].flip(0)], dim=1)


def log_probs(w, x, masks):
    """(L // 8, classes) log-probabilities of one line's (L, height)
    frames under the step's masks."""
    y = x.T[None, None]
    for i, (wt, bs) in enumerate(w["conv"]):
        y = F.relu(F.conv2d(y, wt, bs, padding=(wt.shape[2] // 2,
                                                wt.shape[3] // 2)))
        y = y * masks[i][None, :, None, None]
        if i < 3:
            y = F.max_pool2d(y, 2)
    _, C, H3, T3 = y.shape
    y = y.reshape(C * H3, T3).T
    for j, layer in enumerate(w["lstm"]):
        y = bilstm(layer, y) * masks[4 + j]
    return torch.log_softmax(y @ w["W"].T + w["b"], dim=1)


def feasible(T, labels):
    """Whether a path of ``T`` frames can emit ``labels``."""
    repeats = sum(a == b for a, b in zip(labels, labels[1:]))
    return T >= len(labels) + repeats


def ctc_nll(logp, labels):
    """-log p(labels | the line): the alpha recursion in log space over
    the extended label [blank, l1, blank, l2, ..., blank], blank 0."""
    ext = [0]
    for c in labels:
        ext += [int(c), 0]
    n = len(ext)
    lp = logp[:, torch.tensor(ext, device=logp.device)]      # (T, 2S + 1)
    skip = torch.tensor([s >= 2 and ext[s] != 0 and ext[s] != ext[s - 2]
                         for s in range(n)], device=logp.device)
    neg = logp.new_full((2,), NEG)
    alpha = torch.where(torch.arange(n, device=logp.device) < 2, lp[0],
                        logp.new_tensor(NEG))
    for t in range(1, lp.shape[0]):
        a1 = torch.cat([neg[:1], alpha[:-1]])
        a2 = torch.where(skip, torch.cat([neg, alpha[:-2]]),
                         logp.new_tensor(NEG))
        alpha = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) + lp[t]
    return -torch.logsumexp(alpha[-2:] if labels else alpha[-1:], dim=0)


def adam_update(grads, mu, nu, count, lr, betas, eps):
    """The change Adam makes to each weight tensor at its step ``count``
    + 1, given the step's ``grads`` and the moments ``mu``, ``nu`` after
    ``count`` steps (lists in one order; zeros before the first step): m
    and v updated, each divided by its bias correction, -lr m / (sqrt(v) +
    eps). No weight decay."""
    b1, b2 = betas
    t = count + 1
    out = []
    for g, m, v in zip(grads, mu, nu):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        out.append(-lr * (m / (1 - b1 ** t))
                   / ((v / (1 - b2 ** t)).sqrt() + eps))
    return out


def step(weights, lines, tf32=False):
    """(summed loss, gradients in ``weights``' dict layout, lines zeroed)
    of one step over ``lines``, each line alone at its own length, on the
    weights' device."""
    w = _leafed(weights)
    flat = leaves(w)
    grads = [torch.zeros_like(t) for t in flat]
    total, zeroed = 0.0, 0
    dev = flat[0].device
    with precision(tf32=tf32):
        for ln in lines:
            x = torch.as_tensor(ln["x"], dtype=torch.float32, device=dev)
            masks = [torch.as_tensor(m, dtype=torch.float32, device=dev)
                     for m in ln["masks"]]
            labels = [int(c) for c in ln["labels"]]
            if not feasible(len(x) // 8, labels):
                zeroed += 1
                continue
            loss = ctc_nll(log_probs(w, x, masks), labels)
            for g, d in zip(grads, torch.autograd.grad(loss, flat)):
                g += d
            total += float(loss.detach())
    return total, _unleafed(weights, grads), zeroed


def _leafed(weights):
    """A copy of ``weights`` whose tensors are float32 leaves that take
    gradients."""
    def leaf(t):
        return t.detach().float().clone().requires_grad_(True)

    return {"conv": [(leaf(a), leaf(b)) for a, b in weights["conv"]],
            "lstm": [{d: {k: leaf(x[d][k]) for k in KEYS}
                      for d in ("fwd", "bwd")} for x in weights["lstm"]],
            "W": leaf(weights["W"]), "b": leaf(weights["b"])}


def _unleafed(weights, ts):
    """``ts``, in :func:`leaves`' order, in ``weights``' dict layout."""
    it = iter(ts)
    return {"conv": [(next(it), next(it)) for _ in weights["conv"]],
            "lstm": [{d: {k: next(it) for k in KEYS}
                      for d in ("fwd", "bwd")} for _ in weights["lstm"]],
            "W": next(it), "b": next(it)}
