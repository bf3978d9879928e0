"""CTC training for the line recognizer — the ocropus-rtrain equivalent
(reference workflow: README.md:52-56, SURVEY.md §3.5), on one torch device,
for either network the recognizer runs.

:class:`Trainer` trains ocropy's BiLSTM (:class:`.lstm.BiLSTMParams`), the
counterpart of ``text_alignment_tpu/models/train.py``: the same fields and
defaults, the same loss (``optax.ctc_loss`` semantics, :func:`.ctc.
ctc_loss`), the same optimizer (Adam after optax's global-norm clipping)
and the same checkpoints: an iteration-stamped ``*-NNNNNNNN.pyrnn.gz``
through :mod:`.pyrnn`, and a pickle-free ``.state`` archive whose leaves
are laid out as the JAX trainer lays out its own, so either package
resumes the other's file. Its forward is :func:`.lstm.bilstm_logits`,
plain torch ops differentiated by autograd; the recurrence kernel serves
inference only, as the reference's Pallas kernel does.

:class:`VGSLTrainer` trains kraken's default network (:class:`.vgsl.
VGSLParams`) as kraken's ``RecognitionModel`` (``kraken/lib/train.py``)
does with ``RECOGNITION_HYPER_PARAMS``: the spec's dropout active
(:class:`.vgsl.VGSLModel`, masks from the trainer's seeded
``torch.Generator``), cuDNN's LSTM on the card, CTC summed over the lines
with ``zero_infinity`` (``torch.nn.functional.ctc_loss``), Adam at lr 1e-3
with no weight decay and no clipping. Its checkpoints are a
``*-NNNNNNNN.vgsl.npz`` of the weights (:func:`.vgsl.save_vgsl`, which
:meth:`..recognizer.SeqRecognizer.from_vgsl` loads) and a ``.state``
archive of its own layout.

The card is the default device; ``device="cpu"`` trains on the CPU.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import span
from . import vgsl
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
        return adam_leaves(list(self.model.parameters()), self.optimizer)

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
        restore_adam(list(tr.model.parameters()), tr.optimizer, count, mu,
                     nu)
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


def adam_leaves(params, optimizer) -> list[np.ndarray]:
    """Adam's count (int32), its first moments, its second moments and
    the weights of ``params``, as host arrays in that order (zeros before
    the first step)."""
    count = 0
    mu, nu = [], []
    for p in params:
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            mu.append(st["exp_avg"])
            nu.append(st["exp_avg_sq"])
        else:
            mu.append(torch.zeros_like(p))
            nu.append(torch.zeros_like(p))
    return ([np.asarray(count, np.int32)]
            + [t.detach().cpu().numpy() for t in (*mu, *nu, *params)])


def restore_adam(params, optimizer, count, mu, nu) -> None:
    """Adam's state of :func:`adam_leaves` put back for ``params`` (none
    for a count of 0)."""
    if not count:
        return
    for p, m, v in zip(params, mu, nu):
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(m, device=p.device),
            "exp_avg_sq": torch.tensor(v, device=p.device)}


# the counters a VGSLTrainer keeps: steps, lines and posterior frames
# trained, and lines whose CTC loss was infinite (fewer frames than the
# label needs) and that ``zero_infinity`` zeroed
COUNTERS = ("steps", "lines", "frames", "ctc_zeroed")


def ctc_infeasible(frames, labels, llens) -> int:
    """Lines of a batch whose CTC loss is infinite: fewer ``frames`` than
    the label's length plus its repeated neighbours, the blanks a path
    must put between them."""
    n = 0
    for t, lab, k in zip(frames, labels, llens):
        lab = np.asarray(lab[:k])
        n += int(t < k + int(np.sum(lab[1:] == lab[:-1])))
    return n


class VGSLTrainer:
    """kraken's default network under kraken's training (module doc).

    ``params``: the starting weights (:class:`.vgsl.VGSLParams`); None
    draws the spec's at ``height`` from ``seed`` (:func:`.vgsl.
    init_params_np`). ``seed`` also seeds the ``torch.Generator`` on the
    trainer's device that every dropout mask comes from."""

    def __init__(self, codec: Codec, params: vgsl.VGSLParams | None = None,
                 lr: float = 1e-3, seed: int = 0, device=None,
                 height: int = vgsl.HEIGHT):
        from ..align.api import resolve_device

        # TF32 would part the card's trajectory from the reference's
        pin_float32()
        self.device = resolve_device(device)
        self.codec, self.lr, self.seed, self.height = codec, lr, seed, height
        if params is None:
            params = vgsl.params_from_np(vgsl.init_params_np(
                np.random.default_rng(seed), len(codec), height=height))
        self.model = vgsl.VGSLModel(params.to(self.device))
        self.optimizer = torch.optim.Adam(self.model.leaves(), lr=lr)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.iteration = 0
        self.counters = dict.fromkeys(COUNTERS, 0)

    @property
    def params(self) -> vgsl.VGSLParams:
        """The current weights (a detached copy), as SeqRecognizer takes
        them."""
        return self.model.params()

    @property
    def grads(self) -> vgsl.VGSLParams:
        """The last step's gradients (a copy), in the weights' layout."""
        return self.model.params(grads=True)

    def step(self, xs, xlens, labels, llens) -> float:
        """One update on :func:`batch_lines`' host arrays: xs (B, T,
        height) float32 frames of ``xlens`` valid columns each, labels
        (B, S) of ``llens`` classes each. Returns the summed loss."""
        xlens, labels, llens = (np.asarray(a, np.int64) for a in (
            xlens, labels, llens))
        n = xlens // vgsl.STRIDE
        if n.min(initial=1) < 1:
            raise ValueError(f"a line of {xlens.min()} columns: the network "
                             f"needs {vgsl.STRIDE}")
        dev = self.device
        frames = torch.as_tensor(np.asarray(xs, np.float32)).to(dev)
        widths = torch.from_numpy(xlens).to(dev)
        targets = torch.from_numpy(labels).to(dev)
        counts = torch.from_numpy(n)
        self.optimizer.zero_grad(set_to_none=True)
        with span("ta.train.forward"):
            logp = self.model(frames, widths, counts, self.generator)
        with span("ta.train.loss"):
            loss = F.ctc_loss(logp.transpose(0, 1), targets, counts,
                              torch.from_numpy(llens), blank=0,
                              reduction="sum", zero_infinity=True)
        with span("ta.train.backward"):
            loss.backward()
        with span("ta.train.update"):
            self.optimizer.step()
        self.iteration += 1
        c = self.counters
        c["steps"] += 1
        c["lines"] += len(n)
        c["frames"] += int(n.sum())
        c["ctc_zeroed"] += ctc_infeasible(n, labels, llens)
        return float(loss.detach())

    def save(self, prefix: str) -> str:
        """Write an iteration-stamped ``.vgsl.npz`` of the weights."""
        return vgsl.save_vgsl(f"{prefix}-{self.iteration:08d}.vgsl.npz",
                              self.params, self.codec.charset, self.height)

    # The .state file: an .npz of arr_000 (Adam's count, int32), then
    # Adam's first moments, its second moments and the weights, each group
    # in vgsl.leaves' order, the dropout generator's state (``rng``) and a
    # JSON config with the spec; loaded with allow_pickle=False.

    def save_state(self, path: str, extra: dict | None = None) -> str:
        """Write the full training state; resuming from it on the same
        kind of device continues the trajectory bit-exactly, dropout
        masks included. ``extra`` comes back as ``loaded_extra``."""
        p = self.params
        config = json.dumps(
            {"network": "vgsl", "spec": vgsl.spec_of(p, self.height),
             "height": self.height, "n_conv": len(p.conv), "lr": self.lr,
             "seed": self.seed, "charset": self.codec.charset,
             "iteration": self.iteration, "counters": self.counters,
             "rng_device": self.device.type, "extra": dict(extra or {})})
        buf = io.BytesIO()
        np.savez(buf, config=np.asarray(config),
                 rng=self.generator.get_state().numpy(),
                 **{f"arr_{i:03d}": x for i, x in enumerate(
                     adam_leaves(self.model.leaves(), self.optimizer))})
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return path

    @classmethod
    def load_state(cls, path: str, device=None) -> "VGSLTrainer":
        """Load a :meth:`save_state` file onto ``device`` (None: the card).
        On another kind of device than the one that wrote it the dropout
        masks start afresh from the seed."""
        with np.load(path, allow_pickle=False) as z:
            cfg = json.loads(str(z["config"]))
            leaves = [z[k] for k in sorted(z.files) if k.startswith("arr_")]
            rng = z["rng"]
        k = (len(leaves) - 1) // 3
        if cfg.get("network") != "vgsl" or len(leaves) != 1 + 3 * k:
            raise ValueError(f"{path}: not a VGSL trainer's state")
        weights = [torch.from_numpy(np.asarray(w, np.float32))
                   for w in leaves[1 + 2 * k:]]
        tr = cls(Codec(cfg["charset"]),
                 vgsl.from_leaves(weights, cfg["n_conv"]), lr=cfg["lr"],
                 seed=cfg["seed"], device=device, height=cfg["height"])
        restore_adam(tr.model.leaves(), tr.optimizer, int(leaves[0]),
                     leaves[1:1 + k], leaves[1 + k:1 + 2 * k])
        if cfg["rng_device"] == tr.device.type:
            tr.generator.set_state(torch.from_numpy(rng))
        tr.iteration = cfg["iteration"]
        tr.counters = dict(cfg["counters"])
        tr.loaded_extra = cfg.get("extra", {})
        return tr


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
