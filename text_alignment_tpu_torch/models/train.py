"""CTC training for the line recognizer — the ocropus-rtrain equivalent
(reference workflow: README.md:52-56, SURVEY.md §3.5), on one torch device.

Counterpart of ``text_alignment_tpu/models/train.py``: the same fields and
defaults, the same loss (``optax.ctc_loss`` semantics, :func:`.ctc.
ctc_loss`), the same optimizer (Adam after optax's global-norm clipping)
and the same checkpoints: an iteration-stamped ``*-NNNNNNNN.pyrnn.gz``
through :mod:`.pyrnn`, and a pickle-free ``.state`` archive whose leaves
are laid out as the JAX trainer lays out its own, so either package
resumes the other's file. The forward is :func:`.lstm.bilstm_logits`,
plain torch ops differentiated by autograd; the recurrence kernel serves
inference only, as the reference's Pallas kernel does. The card is the
default device; ``device="cpu"`` trains on the CPU.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass

import numpy as np
import torch

from .codec import Codec
from .ctc import _logaddexp, ctc_loss
from .lstm import (BiLSTM, BiLSTMParams, init_params_seeded,
                   params_from_np, params_to_np, pin_float32)
from .pyrnn import save_pyrnn

N_LEAVES = 15  # weight tensors of BiLSTMParams


def clip_by_global_norm(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: each gradient becomes
    ``g / norm * max_norm`` unless the global norm is below ``max_norm``
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and
    multiplies by a clipped factor, which rounds otherwise)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def ground_term(logits, xs, xlens, space_index):
    """The ink-grounding auxiliary loss (the JAX package's
    ``make_train_step``): frames whose normalized input column carries no
    ink (ink=1, background=0; interpolation bleed stays well under 0.05 of
    column mass) should emit blank, or space, since inter-word gaps are
    empty frames. The mean of -log p(blank or space) over those frames."""
    logp = torch.log_softmax(logits, dim=-1)
    ok = logp[..., 0]
    if space_index is not None:
        ok = _logaddexp(ok, logp[..., space_index])
    valid = (torch.arange(xs.shape[1], device=xs.device)[None, :]
             < xlens[:, None])
    empty = (xs.sum(dim=-1) < 0.05) & valid
    n = torch.clamp(empty.sum(), min=1)
    return torch.sum(torch.where(empty, -ok, 0.0)) / n


@dataclass
class Trainer:
    """Minimal CTC trainer over (frames, text) line pairs.

    Global-norm clipping stays on by default: CTC training starts in a
    blank-collapse plateau whose escape gradients are huge, and clipped
    Adam leaves it several times sooner (the JAX package's measurements,
    ``text_alignment_tpu/models/train.py``)."""

    codec: Codec
    ni: int = 48
    ns: int = 100
    lr: float = 1e-3
    seed: int = 0
    clip_norm: float | None = 1.0
    ground_weight: float = 0.0
    device: object = None

    def __post_init__(self):
        from ..align.api import resolve_device

        # TF32 would part the card's trajectory from the CPU's
        pin_float32()
        self.device = resolve_device(self.device)
        init = init_params_seeded(self.seed, self.ni, self.ns,
                                  len(self.codec))
        self.model = BiLSTM(params_from_np(init, self.device))
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.lr, betas=(0.9, 0.999),
            eps=1e-8)
        self.space_index = self.codec.char2code.get(" ")
        self.iteration = 0

    @property
    def params(self) -> BiLSTMParams:
        """The current weights (a detached copy), as SeqRecognizer takes
        them."""
        return self.model.params()

    def tensors(self, xs, xlens, labels, llens):
        """A host batch (:func:`batch_lines`'s arrays) as tensors on the
        trainer's device: frames float32, the rest int64."""
        return tuple(
            torch.as_tensor(np.asarray(a), dtype=dt).to(self.device)
            for a, dt in ((xs, torch.float32), (xlens, torch.int64),
                          (labels, torch.int64), (llens, torch.int64)))

    def loss(self, xs, xlens, labels, llens, ground_weight: float = 0.0):
        """The training loss on device tensors, differentiable in the
        weights. Two programs, as in the JAX trainer: the grounding term
        is computed only when its weight is not 0."""
        logits = self.model(xs, xlens)
        loss = ctc_loss(logits, xlens, labels, llens)
        if ground_weight == 0.0:
            return loss
        return loss + ground_weight * ground_term(logits, xs, xlens,
                                                  self.space_index)

    def step(self, xs, xlens, labels, llens,
             ground_weight: float | None = None) -> float:
        """One update. xs: (B, T, ni) float32; labels: (B, S) int32.
        ``ground_weight`` overrides the trainer default for this step."""
        gw = float(self.ground_weight if ground_weight is None
                   else ground_weight)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(*self.tensors(xs, xlens, labels, llens), gw)
        loss.backward()
        if self.clip_norm is not None:
            clip_by_global_norm([p.grad for p in self.model.parameters()],
                                self.clip_norm)
        self.optimizer.step()
        self.iteration += 1
        return float(loss.detach())

    def save(self, prefix: str) -> str:
        """Write an iteration-stamped checkpoint like ocropus-rtrain."""
        path = f"{prefix}-{self.iteration:08d}.pyrnn.gz"
        save_pyrnn(path, params_to_np(self.params), self.codec, self.ni)
        return path

    # -- full-state checkpointing (resume with optimizer state) --
    #
    # The .pyrnn.gz checkpoint holds the weights only; resuming from it
    # restarts Adam cold. save_state/load_state round-trip params, Adam's
    # count and moments, and the iteration for exact resume. The file is
    # the JAX trainer's: an .npz of leaves arr_000 (Adam's count, int32),
    # arr_001-015 (the first moments), arr_016-030 (the second moments),
    # arr_031-045 (the weights), each group in BiLSTMParams order, plus a
    # JSON config string; loaded with allow_pickle=False, so a .state file
    # cannot execute code.

    def _leaves(self) -> list[np.ndarray]:
        params = list(self.model.parameters())
        count = 0
        mu, nu = [], []
        for p in params:
            st = self.optimizer.state.get(p, {})
            if st:
                count = int(st["step"])
                mu.append(st["exp_avg"])
                nu.append(st["exp_avg_sq"])
            else:
                mu.append(torch.zeros_like(p))
                nu.append(torch.zeros_like(p))
        return ([np.asarray(count, np.int32)]
                + [t.detach().cpu().numpy() for t in (*mu, *nu, *params)])

    def save_state(self, path: str, extra: dict | None = None) -> str:
        """Write the full training state; resuming from it continues the
        trajectory bit-exactly (tested). ``extra`` stores caller-side
        settings exact resume needs (the CLI's batch size and its sampling
        RNG's state); it comes back as ``loaded_extra``."""
        config = json.dumps(
            {"ni": self.ni, "ns": self.ns, "lr": self.lr,
             "seed": self.seed, "clip_norm": self.clip_norm,
             "ground_weight": self.ground_weight,
             "charset": self.codec.charset,
             "iteration": self.iteration,
             "extra": dict(extra or {})})
        buf = io.BytesIO()
        np.savez(buf, config=np.asarray(config),
                 **{f"arr_{i:03d}": x for i, x in enumerate(self._leaves())})
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return path

    @classmethod
    def load_state(cls, path: str, device=None) -> "Trainer":
        """Load a ``save_state`` checkpoint of either package onto
        ``device`` (None: the card)."""
        with np.load(path, allow_pickle=False) as z:
            cfg = json.loads(str(z["config"]))
            leaves = [z[k] for k in sorted(z.files) if k.startswith("arr_")]
        if len(leaves) != 1 + 3 * N_LEAVES:
            raise ValueError(f"{path}: {len(leaves)} state leaves, expected "
                             f"{1 + 3 * N_LEAVES} (Adam's count, moments, "
                             "weights)")
        tr = cls(codec=Codec(cfg["charset"]), ni=cfg["ni"], ns=cfg["ns"],
                 lr=cfg["lr"], seed=cfg["seed"], clip_norm=cfg["clip_norm"],
                 ground_weight=cfg.get("ground_weight", 0.0), device=device)
        count = int(leaves[0])
        mu = leaves[1:1 + N_LEAVES]
        nu = leaves[1 + N_LEAVES:1 + 2 * N_LEAVES]
        weights = leaves[1 + 2 * N_LEAVES:]
        with torch.no_grad():
            for p, w in zip(tr.model.parameters(), weights):
                if tuple(p.shape) != w.shape:
                    raise ValueError(f"{path}: a weight of shape {w.shape}"
                                     f" where {tuple(p.shape)} is expected")
                p.copy_(torch.from_numpy(np.asarray(w, np.float32)))
        if count:
            for p, m, v in zip(tr.model.parameters(), mu, nu):
                tr.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": torch.tensor(m, device=tr.device),
                    "exp_avg_sq": torch.tensor(v, device=tr.device)}
        tr.iteration = cfg["iteration"]
        tr.loaded_extra = cfg.get("extra", {})
        return tr

    @classmethod
    def from_jax_state(cls, path: str, device=None) -> "Trainer":
        """Continue a run of the JAX package's trainer from its
        ``save_state`` file (read with numpy, no JAX). JAX flattens the
        state dict's keys sorted, so ``opt_state`` (Adam's count, mu, nu;
        optax's empty states carry no leaves) comes before ``params``: the
        layout :meth:`save_state` writes, so this is :meth:`load_state`."""
        return cls.load_state(path, device)


def batch_lines(frame_list, text_list, codec: Codec, T: int, S: int):
    """Pack variable-length (frames, text) pairs into fixed (B,T,ni)/(B,S)."""
    B = len(frame_list)
    ni = frame_list[0].shape[1]
    xs = np.zeros((B, T, ni), np.float32)
    xlens = np.zeros(B, np.int32)
    labels = np.zeros((B, S), np.int32)
    llens = np.zeros(B, np.int32)
    for i, (fr, txt) in enumerate(zip(frame_list, text_list)):
        t = min(len(fr), T)
        xs[i, :t] = fr[:t]
        xlens[i] = t
        lab = codec.s2l(txt)[:S]
        labels[i, : len(lab)] = lab
        llens[i] = len(lab)
    return xs, xlens, labels, llens
