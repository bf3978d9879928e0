"""CTC decoding with frame positions (llocs): numpy oracles + batched torch.

Counterpart of ``text_alignment_tpu/models/ctc.py`` (which imports JAX at
module top, so the port carries its pure-numpy part here, verbatim).
Canonical semantics = ocropy's ``lstm.translate_back(outputs, pos=1)``:
label regions are maximal runs of frames whose blank posterior is below
threshold (0.7); each region emits the (frame, class) of its maximum
posterior over the whole frames x classes block (first occurrence in
row-major order on ties, which can be class 0: an ocropy quirk preserved).
``ocropus-rpred --llocs`` then writes ``(frame - pad) * raw_width /
(T - 2*pad)`` with one decimal.

Also the CTC loss of training (:func:`ctc_loss`, ``optax.ctc_loss``'s
recursion in plain torch, differentiated by autograd).
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLD = 0.7


def translate_back_np(outputs: np.ndarray, threshold: float = THRESHOLD):
    """Oracle decode for one line. outputs: (T, C). Returns list of
    (frame, class)."""
    mask = outputs[:, 0] < threshold
    result = []
    t = 0
    T = len(outputs)
    while t < T:
        if not mask[t]:
            t += 1
            continue
        s = t
        while t < T and mask[t]:
            t += 1
        block = outputs[s:t]
        flat = int(np.argmax(block))
        r, c = divmod(flat, outputs.shape[1])
        result.append((s + r, c))
    return result


def region_end_np(outputs: np.ndarray, threshold: float = THRESHOLD):
    """Oracle for decode="region_end": region segmentation and peak class
    as ``translate_back_np``, but the reported frame is the region's LAST
    frame (the right-edge estimate for the llocs box contract)."""
    mask = outputs[:, 0] < threshold
    result = []
    t = 0
    T = len(outputs)
    while t < T:
        if not mask[t]:
            t += 1
            continue
        s = t
        while t < T and mask[t]:
            t += 1
        block = outputs[s:t]
        flat = int(np.argmax(block))
        r, c = divmod(flat, outputs.shape[1])
        result.append((t - 1, c))
    return result


def bestpath_np(outputs: np.ndarray):
    """Best-path oracle decode for one line: maximal runs of a constant
    argmax class != blank each emit (peak frame, class)."""
    path = outputs.argmax(axis=1)
    result = []
    t = 0
    T = len(outputs)
    while t < T:
        c = path[t]
        if c == 0:
            t += 1
            continue
        s = t
        while t < T and path[t] == c:
            t += 1
        result.append((s + int(np.argmax(outputs[s:t, c])), int(c)))
    return result


def translate_back_batched(outputs, lengths, max_regions=256,
                           threshold=THRESHOLD, mode="region"):
    """Batched decode. outputs: (B, T, C); lengths: (B,).

    mode="region": ocropy translate_back (blank-threshold regions);
    mode="bestpath": argmax-path runs (``bestpath_np``); mode="region_end":
    region segmentation + peak class, frame = the region's last frame
    (``region_end_np``). Returns (frames (B, R) int32, classes (B, R)
    int32, counts (B,) int32); entries past counts[b] are padding
    (frame = T). Regions past R are dropped; count is capped at R.
    """
    if mode not in ("region", "bestpath", "region_end"):
        raise ValueError(f"unknown decode mode {mode!r}")
    B, T, C = outputs.shape
    dev = outputs.device
    t_idx = torch.arange(T, device=dev)[None, :].expand(B, T)
    valid = t_idx < lengths.to(dev).long()[:, None]
    fb = outputs.amax(dim=2)      # per-frame best posterior
    fc = outputs.argmax(dim=2)    # its class, first max on ties
    if mode in ("region", "region_end"):
        mask = (outputs[:, :, 0] < threshold) & valid
        prev = torch.cat([torch.zeros_like(mask[:, :1]), mask[:, :-1]], 1)
        starts = mask & ~prev
    else:
        path = torch.where(valid, fc, 0)
        mask = path != 0
        prev_path = torch.cat([torch.zeros_like(path[:, :1]), path[:, :-1]],
                              1)
        starts = mask & (path != prev_path)
    rid = torch.cumsum(starts.long(), dim=1) * mask   # 0 = no region
    R = max_regions
    # slot R + 1 collects every region past R, then is dropped
    slot = rid.clamp(max=R + 1)

    neg = torch.tensor(-torch.inf, dtype=outputs.dtype, device=dev)
    seg_max = torch.full((B, R + 2), -torch.inf, dtype=outputs.dtype,
                         device=dev).scatter_reduce(
        1, slot, torch.where(mask, fb, neg), "amax")
    is_peak = mask & (fb == torch.gather(seg_max, 1, slot))
    frame_of = torch.full((B, R + 2), T, dtype=torch.long,
                          device=dev).scatter_reduce(
        1, slot, torch.where(is_peak, t_idx, T), "amin")
    peak_frames = frame_of[:, 1:R + 1]
    found = peak_frames < T
    cls = torch.where(
        found, torch.gather(fc, 1, peak_frames.clamp(0, T - 1)), 0)
    if mode == "region_end":
        end_of = torch.full((B, R + 2), -1, dtype=torch.long,
                            device=dev).scatter_reduce(
            1, slot, torch.where(mask, t_idx, -1), "amax")
        frames = torch.where(found, end_of[:, 1:R + 1], T)
    else:
        frames = peak_frames
    counts = rid.max(dim=1).values.clamp(max=R)
    return frames.int(), cls.int(), counts.int()


def llocs_positions(frames, raw_width: int, T_total: int, pad: int):
    """Frame indices -> llocs x positions, rounded to 1 decimal exactly as
    ocropus-rpred writes them ("%.1f")."""
    scale = raw_width * 1.0 / (T_total - 2 * pad)
    return [float("%.1f" % ((int(r) - pad) * scale)) for r in frames]


LOG_EPSILON = -1e5  # optax's numerically stable stand-in for log(+0)


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with JAX's derivative, ``exp(x - out)`` for each
    operand (``jax.lax.logaddexp``'s JVP). torch's own backward,
    ``1 / (1 + exp(other - x))``, rounds otherwise where the log-alphas
    lie near ``LOG_EPSILON`` (an infeasible line): ulps of 1e5 are 0.008,
    and the two formulas then part by ~1% of that line's gradient."""

    @staticmethod
    def forward(ctx, x1, x2):
        out = torch.logaddexp(x1, x2)
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        return g * torch.exp(x1 - out), g * torch.exp(x2 - out)


def _logaddexp(x1, x2):
    return _LogAddExp.apply(x1, x2)


def _logaddexp_tail(phi, added):
    """``phi`` with ``added`` log-added into its columns 1: (optax's
    ``update_phi_score``)."""
    return torch.cat([phi[:, :1], _logaddexp(phi[:, 1:], added)], 1)


def ctc_loss(logits, logit_lengths, labels, label_lengths):
    """CTC loss (blank 0) for training, mean over the batch: the semantics
    of the JAX package's ``ctc_loss``, which is ``optax.ctc_loss`` with
    paddings from the lengths, then the mean of the per-line negative
    log-likelihoods (no division by label lengths, unlike
    ``F.ctc_loss(reduction="mean")``).

    logits: (B, T, C) UN-normalized; labels: (B, S) int, padded with 0.

    optax's recursion, step for step: log-alphas of the N + 1 blank states
    (``phi``) and N label states (``emit``) of each line, one step a frame
    over the whole batch, with log(0) as the finite ``LOG_EPSILON``. So an
    infeasible line (fewer frames than its labels need) has a large finite
    loss, where ``F.ctc_loss`` gives inf. The label gather is a one-hot
    product, as optax writes it: its backward is a matmul, with no
    scatter (whose atomics on the card would make a step irreproducible).
    """
    B, T, C = logits.shape
    N = labels.shape[1]
    dev = logits.device
    labels = labels.to(dev).long()
    logit_pad = (torch.arange(T, device=dev)[None, :]
                 >= logit_lengths.to(dev).long()[:, None])
    labellens = label_lengths.to(dev).long()

    logprobs = torch.log_softmax(logits, dim=-1)
    repeat = torch.nn.functional.pad(
        (labels[:, :-1] == labels[:, 1:]).to(logits.dtype), (0, 1))
    one_hot = torch.nn.functional.one_hot(labels, C).to(logits.dtype)
    emit_t = torch.einsum("btk,bnk->tbn", logprobs, one_hot)  # (T, B, N)
    phi_t = logprobs[:, :, 0].T.unsqueeze(2)                  # (T, B, 1)
    pad_t = logit_pad.T.unsqueeze(2)                          # (T, B, 1)
    eps_repeat = LOG_EPSILON * repeat
    eps_other = LOG_EPSILON * (1.0 - repeat)

    phi = torch.full((B, N + 1), LOG_EPSILON, dtype=logits.dtype,
                     device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), LOG_EPSILON, dtype=logits.dtype, device=dev)
    # unbound once: indexing a frame per step would, in the backward, add
    # each frame's gradient into a zeroed copy of the whole (T, B, N)
    for lp_emit, lp_phi, pad in zip(emit_t.unbind(0), phi_t.unbind(0),
                                    pad_t.unbind(0)):
        # emit-to-phi epsilon transition, except into a repeated label
        phi_eps = _logaddexp_tail(phi, emit + eps_repeat)
        # phi-to-emit, then the self-loops
        next_emit = _logaddexp(phi_eps[:, :-1] + lp_emit, emit + lp_emit)
        # emit-to-phi blank transition only before a repeated label
        next_phi = _logaddexp_tail(phi_eps + lp_phi,
                                   emit + lp_phi + eps_other)
        # a padded frame holds the state (optax's pad blend, as a select)
        emit = torch.where(pad, emit, next_emit)
        phi = torch.where(pad, phi, next_phi)
    phi = _logaddexp_tail(phi, emit)  # the last epsilon transition
    per_seq = -phi.gather(1, labellens[:, None])[:, 0]
    return per_seq.mean()
