"""Sharded CTC training step: data parallelism over lines, tensor
parallelism over the recognizer's output projection.

Counterpart of ``text_alignment_tpu/parallel/train_dp.py``, with its
layout over a ('data', 'model') mesh of ``torch.distributed`` ranks:

- the batch (frames, lengths, labels) is sharded along 'data': each rank
  takes its data coordinate's contiguous lines;
- the softmax projection W2 (nout, 2ns+1) is sharded along 'model' by
  rows (classes), padded with zero rows to a multiple of the axis (GSPMD
  pads an uneven shard the same way); each rank's logits are all-gathered
  on the class axis, the padded classes dropped, before the loss;
- the LSTM weights are replicated.

XLA inserts the collectives in the JAX package; here they are written
out. The logits gather is an autograd Function whose backward is this
rank's slice of the gradient (every rank of a model group computes the
same loss on the same lines, so the slice is exact). The LSTM weights'
gradients are summed over the model axis (each rank's slice of the
logits reaches them through its own classes) and all gradients are
averaged over the data axis, so the update is that of the global batch's
mean ``ctc.ctc_loss``. Under clipping the squared norm of the W2 shard is
summed over the model axis before optax's global-norm formula.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.codec import Codec
from ..models.ctc import ctc_loss
from ..models.lstm import (BiLSTMParams, _logits, bidir_scan_train,
                           init_params_seeded, params_from_leaves,
                           params_from_np, params_leaves, scan_inputs)
from .mesh import axis_rank, axis_size, mesh_device
from .multihost import all_gather_rows, comm_device

N_LSTM = 14  # replicated leaves of BiLSTMParams: fwd and bwd, 7 each


class Adam(NamedTuple):
    """The optimizer of a sharded step: ``optax.adam(lr)`` (PyTorch's Adam,
    the same update), after optax's ``clip_by_global_norm(clip_norm)``
    when ``clip_norm`` is set: the JAX demo's ``Adam(1e-3)``, or the
    port's ``Trainer`` recipe (:func:`trainer_recipe`)."""

    lr: float = 1e-3
    clip_norm: float | None = None

    def init(self, params: "ShardedParams") -> torch.optim.Adam:
        return torch.optim.Adam(params.leaves, lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8)


def trainer_recipe(trainer) -> Adam:
    """The optimizer of ``models.train.Trainer`` (its lr and clip_norm).
    The grounding term is not sharded: a trainer with a ground weight
    raises."""
    if trainer.ground_weight:
        raise ValueError("the sharded step computes the CTC loss alone; the "
                         "trainer's ground_weight must be 0")
    return Adam(trainer.lr, trainer.clip_norm)


@dataclass
class ShardedParams:
    """This rank's weights: the 14 replicated LSTM leaves, then its rows of
    the padded W2 (``leaves``, trainable), and the real class count."""

    leaves: list
    nout: int


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    buf = t.to(comm_device(group)).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


class _GatherClasses(torch.autograd.Function):
    """(b, T, c) logits of this rank's classes -> (b, T, m c), all ranks'
    classes in rank order; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, m, j):
        ctx.lo, ctx.hi = j * x.shape[-1], (j + 1) * x.shape[-1]
        src = x.to(comm_device(group)).contiguous()
        parts = [torch.empty_like(src) for _ in range(m)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=-1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None, None


def make_sharded_train_step(mesh, optimizer: Adam):
    """Returns (train_step, shard_params, shard_batch) for ``mesh`` (a
    ('data', 'model') or ('data',) mesh):

    - ``shard_params(params)``: a ``BiLSTMParams`` (every rank the same)
      -> this rank's :class:`ShardedParams` on its device;
    - ``shard_batch(xs, xlens, labels, llens)``: the global host batch
      (every rank the same; B a multiple of the data axis) -> this rank's
      lines as tensors;
    - ``train_step(params, opt_state, *batch)`` -> (params, opt_state,
      loss), with ``opt_state = optimizer.init(params)``: one update in
      place; the loss is the global batch's mean before the update, and
      the parameters' ``.grad`` hold the reduced (and clipped) gradients
      the update used (:func:`unshard` with ``grads=True``)."""
    dev = mesh_device(mesh)
    n_d = axis_size(mesh, "data")
    m, j = axis_size(mesh, "model"), axis_rank(mesh, "model")
    data_g = mesh.get_group("data")
    model_g = mesh.get_group("model") if m > 1 else None

    def shard_params(params: BiLSTMParams) -> ShardedParams:
        W2 = params.W2.detach()
        nout = W2.shape[0]
        rows = -(-nout // m)
        padded = torch.zeros((rows * m, W2.shape[1]), dtype=W2.dtype,
                             device=W2.device)
        padded[:nout] = W2
        mine = params_leaves(params)[:N_LSTM] + [padded[j * rows:
                                                        (j + 1) * rows]]
        return ShardedParams(
            [torch.nn.Parameter(t.detach().clone().to(dev)) for t in mine],
            nout)

    def shard_batch(xs, xlens, labels, llens):
        B = np.shape(xs)[0]
        if B % n_d:
            raise ValueError(f"a batch of {B} lines does not shard over "
                             f"{n_d} data ranks")
        d, per = axis_rank(mesh, "data"), B // n_d
        return tuple(
            torch.as_tensor(np.asarray(a)[d * per:(d + 1) * per],
                            dtype=dt).to(dev)
            for a, dt in ((xs, torch.float32), (xlens, torch.int64),
                          (labels, torch.int64), (llens, torch.int64)))

    def local_loss(params: ShardedParams, xs, xlens, labels, llens):
        p = params_from_leaves(list(params.leaves))
        gx, whT, peep = scan_inputs(p, xs, xlens)
        logits = _logits(p, bidir_scan_train(gx, whT, peep), xlens)
        if model_g is not None:
            logits = _GatherClasses.apply(logits, model_g, m, j)
        return ctc_loss(logits[..., :params.nout], xlens, labels, llens)

    def reduce_grads(params: ShardedParams) -> None:
        grads = [p.grad for p in params.leaves]
        lstm = torch.cat([g.reshape(-1) for g in grads[:N_LSTM]])
        if model_g is not None:
            lstm = _all_reduce_sum(lstm, model_g)
        lstm = _all_reduce_sum(lstm, data_g) / n_d
        w2 = _all_reduce_sum(grads[N_LSTM], data_g) / n_d
        off = 0
        for g in grads[:N_LSTM]:
            g.copy_(lstm[off:off + g.numel()].view_as(g))
            off += g.numel()
        grads[N_LSTM].copy_(w2)
        if optimizer.clip_norm is not None:
            sq_w2 = torch.sum(grads[N_LSTM] * grads[N_LSTM])
            if model_g is not None:
                sq_w2 = _all_reduce_sum(sq_w2, model_g)
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads[:N_LSTM])
                              + sq_w2)
            keep = norm < optimizer.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g,
                                    g / norm * optimizer.clip_norm))

    def train_step(params: ShardedParams, opt_state, xs, xlens, labels,
                   llens):
        opt_state.zero_grad(set_to_none=True)
        loss = local_loss(params, xs, xlens, labels, llens)
        loss.backward()
        reduce_grads(params)
        opt_state.step()
        loss = _all_reduce_sum(loss.detach(), data_g) / n_d
        return params, opt_state, float(loss)

    return train_step, shard_params, shard_batch


def unshard(params: ShardedParams, mesh, grads: bool = False
            ) -> BiLSTMParams:
    """The whole weights (``grads=True``: their gradients) from every
    rank's shard: W2's rows all-gathered over the model axis, the padded
    rows dropped. Every rank of the mesh must call it."""
    leaves = [p.grad if grads else p.detach() for p in params.leaves]
    W2 = leaves[N_LSTM]
    if "model" in mesh.mesh_dim_names:
        W2 = all_gather_rows(W2, mesh.get_group("model"),
                             axis_size(mesh, "model"))
    return params_from_leaves(leaves[:N_LSTM] + [W2[:params.nout]])


def sharded_train_demo_step(mesh, batch_per_device: int = 2, T: int = 64,
                            ni: int = 16, ns: int = 16,
                            seed: int = 0) -> float:
    """Build a sharded training step on ``mesh`` and run ONE update on tiny
    shapes from the JAX demo's weights for ``seed`` (``init_bilstm
    (PRNGKey(seed))``, drawn by ``init_params_seeded``) and its batch;
    returns the (finite) loss. Used by the multi-process dry run."""
    codec = Codec(["", "~", " ", "a", "b", "c"])
    B = batch_per_device * axis_size(mesh, "data")
    params = params_from_np(init_params_seeded(seed, ni, ns, len(codec)))
    optimizer = Adam(1e-3)
    train_step, shard_params, shard_batch = make_sharded_train_step(
        mesh, optimizer)
    params = shard_params(params)
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 1, (B, T, ni)).astype(np.float32)
    xlens = np.full(B, T, np.int32)
    labels = np.tile(np.array([[3, 4, 5, 0]], np.int32), (B, 1))
    llens = np.full(B, 3, np.int32)
    params, opt_state, loss = train_step(
        params, opt_state, *shard_batch(xs, xlens, labels, llens))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return loss
