"""Data-parallel OCR inference over a mesh of ranks.

Counterpart of ``text_alignment_tpu/parallel/infer_dp.py``. The batched
recognizer (``models.recognizer._recognize_device_wire``) is a function of
a (B, Hp + 1, Wp/32) bit-packed strip batch, row by row; scaling out is a
row shard: every rank holds the whole batch, pads it to a multiple of the
mesh's ``data`` axis with rows of h = w = 0 (which decode to zero
regions), runs its own contiguous rows through the device path (the
``lstm_scan`` and ``lineest_tail`` kernels on a card) and all-gathers the
wire, so that every rank returns the whole batch's wire. The weights are
replicated. Ranks along a ``model`` axis, if the mesh has one, repeat
their data coordinate's rows.

Every call proves that the batch was partitioned, not replicated: each
rank counts the rows that came out of its device path (the wire rows,
or the BiLSTM's output rows on the host-normalizer branch), the counts
are gathered over the ``data`` axis, and they must be equal, one a rank, and
sum to the padded batch (:func:`_assert_partitioned`; the JAX package's
guard against a silent replication that would do n times the work).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_size, mesh_device
from .multihost import fetch, shard_rows

# the work shares of the most recent sharded dispatch: {"rank<r>:<rank's
# device>": rows}, one entry a rank of the data axis; overwritten per call
LAST_WORK_SHARES: dict = {}


def _assert_partitioned(rows_done: int, mesh, padded: int) -> dict:
    """Gather each data-axis rank's ``rows_done``; raise unless they are
    equal, one a rank, and sum to ``padded``. Returns the shares."""
    n = axis_size(mesh)
    key = f"rank{dist.get_rank()}:{mesh_device(mesh)}"
    parts = [None] * n
    dist.all_gather_object(parts, (key, int(rows_done)),
                           group=mesh.get_group("data"))
    shares = dict(parts)
    if (len(shares) != n or len(set(shares.values())) != 1
            or sum(shares.values()) != padded):
        raise RuntimeError(f"the batch of {padded} rows was not partitioned "
                           f"over {n} ranks: shares {shares}")
    LAST_WORK_SHARES.clear()
    LAST_WORK_SHARES.update(shares)
    return shares


def recognize_sharded_meta(params, packed_meta, mesh, t_max: int,
                           target_height: int, pad: int, max_regions: int,
                           decode: str = "region",
                           device=None) -> np.ndarray:
    """The recognizer's device path with the batch sharded over ``mesh``'s
    ``data`` axis. ``packed_meta``: the one-upload wire format ((B, Hp + 1,
    Wp/32) int32, numpy or tensor, the same on every rank). ``device``:
    this rank's device (None: the mesh's; any other raises). Returns the
    whole batch's uint16 wire rows on every rank, as the one-device path
    (``recognizer._recognize_device_impl``) returns them."""
    from ..models import recognizer as rz

    dev = mesh_device(mesh, device)
    if not isinstance(packed_meta, torch.Tensor):
        packed_meta = torch.from_numpy(np.ascontiguousarray(packed_meta))
    B = packed_meta.shape[0]
    local, padded = shard_rows(packed_meta, mesh, pad="zeros")
    wire = rz._recognize_device_wire(
        params.to(dev), local.to(dev), t_max=t_max,
        target_height=target_height, pad=pad, max_regions=max_regions,
        decode=decode)
    _assert_partitioned(wire.shape[0], mesh, padded)
    return fetch(wire, mesh)[:B].astype(np.uint16)


def recognize_sharded(params, packed_bits: np.ndarray, hs: np.ndarray,
                      ws: np.ndarray, mesh, t_max: int, target_height: int,
                      pad: int, max_regions: int, decode: str = "region",
                      device=None) -> np.ndarray:
    """:func:`recognize_sharded_meta` for callers holding separate bits,
    hs and ws arrays (the dry run)."""
    B, _, Wq = packed_bits.shape
    meta = np.zeros((B, 1, Wq), packed_bits.dtype)
    meta[:, 0, 0] = hs
    meta[:, 0, 1] = ws
    return recognize_sharded_meta(
        params, np.concatenate([packed_bits, meta], axis=1), mesh,
        t_max=t_max, target_height=target_height, pad=pad,
        max_regions=max_regions, decode=decode, device=device)


def decode_frames_sharded(params, xs: np.ndarray, lengths: np.ndarray, mesh,
                          max_regions: int, decode: str = "region",
                          device=None):
    """The BiLSTM and the CTC decode of host-normalized frames ((B, T, ni),
    lengths (B,), rows of length 0 decode to nothing) with the batch
    sharded over ``mesh``'s ``data`` axis: the host-normalizer branch of
    ``SeqRecognizer.recognize_batch`` under a mesh. Returns the whole
    batch's (frames, classes, counts) host arrays on every rank."""
    from ..models.ctc import translate_back_batched
    from ..models.lstm import bilstm_forward_batched

    dev = mesh_device(mesh, device)
    B = xs.shape[0]
    x_loc, padded = shard_rows(xs, mesh, pad="zeros")
    l_loc, _ = shard_rows(lengths, mesh, pad="zeros")
    l_dev = torch.from_numpy(np.ascontiguousarray(l_loc)).to(dev)
    outputs = bilstm_forward_batched(
        params.to(dev), torch.from_numpy(np.ascontiguousarray(x_loc)).to(dev),
        l_dev)
    fr, cl, cnt = translate_back_batched(outputs, l_dev,
                                         max_regions=max_regions, mode=decode)
    _assert_partitioned(outputs.shape[0], mesh, padded)
    return tuple(fetch(t, mesh)[:B] for t in (fr, cl, cnt))
