"""Numpy oracle of the ocropy-style BiLSTM+softmax line recognizer forward.

Canonical semantics (matching ocropy 1.3.3 ``lstm.py``'s pure-numpy
recognizer that ``ocropus-rpred`` runs, SURVEY.md §2.10):

- per-gate weights WGI/WGF/WGO/WCI of shape (ns, 1+ni+ns); the source vector
  is [1, x_t, out_{t-1}] (bias folded in);
- peephole vectors WIP/WFP (applied with state_{t-1}, skipped at t=0) and
  WOP (applied with the *current* state, also skipped at t=0 — an ocropy
  quirk preserved);
- gates sigmoid, cell input tanh, output nonlinearity tanh;
- bidirectional: forward LSTM ++ reversed LSTM, concatenated, then softmax
  with W2 of shape (nout, 2*ns+1) and logits clipped to [-100, 100].

The port's :mod:`.lstm` (inference and training forward) is tested against
this oracle.
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def lstm_forward_np(W, xs: np.ndarray) -> np.ndarray:
    """One direction. W: dict with WGI,WGF,WGO,WCI (ns, na), WIP,WFP,WOP
    (ns,). xs: (T, ni) float32. Returns (T, ns) outputs."""
    WGI, WGF, WGO, WCI = W["WGI"], W["WGF"], W["WGO"], W["WCI"]
    WIP, WFP, WOP = W["WIP"], W["WFP"], W["WOP"]
    ns = WGI.shape[0]
    T, ni = xs.shape

    out = np.zeros((T, ns), dtype=np.float32)
    state = np.zeros((T, ns), dtype=np.float32)
    for t in range(T):
        prev = np.zeros(ns, np.float32) if t == 0 else out[t - 1]
        source = np.concatenate([[1.0], xs[t], prev]).astype(np.float32)
        gix = WGI @ source
        gfx = WGF @ source
        gox = WGO @ source
        cix = WCI @ source
        if t > 0:
            gix = gix + WIP * state[t - 1]
            gfx = gfx + WFP * state[t - 1]
        gi = _sigmoid(gix)
        gf = _sigmoid(gfx)
        ci = np.tanh(cix)
        s = ci * gi
        if t > 0:
            s = s + gf * state[t - 1]
            gox = gox + WOP * s
        state[t] = s
        go = _sigmoid(gox)
        out[t] = np.tanh(s) * go
    return out


def softmax_forward_np(W2: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """(T, k) -> (T, nout) posteriors, logits clipped to [-100, 100]."""
    T = ys.shape[0]
    inputs = np.concatenate([np.ones((T, 1), np.float32), ys], axis=1)
    logits = inputs @ W2.T
    e = np.exp(np.clip(logits, -100, 100))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def bilstm_forward_np(params, xs: np.ndarray) -> np.ndarray:
    """Full recognizer forward for one line. ``params`` is a dict:
    {'fwd': W, 'bwd': W, 'W2': (nout, 2ns+1)}. xs: (T, ni).
    Returns (T, nout) posteriors."""
    f = lstm_forward_np(params["fwd"], xs)
    b = lstm_forward_np(params["bwd"], xs[::-1])[::-1]
    y = np.concatenate([f, b], axis=1)
    return softmax_forward_np(params["W2"], y)
