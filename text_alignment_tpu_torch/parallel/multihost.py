"""Ranks, collectives and the multi-process dry run of the port's mesh.

Counterpart of ``text_alignment_tpu/parallel/multihost.py``. In the JAX
package every process holds the same host data and ``put_global`` turns
it into a global array sharded over the mesh; ``fetch`` replicates a
result on every process. The port works the same way over
``torch.distributed``: every rank holds the same full input, takes its own
contiguous rows (:func:`shard_rows`), computes them, and all-gathers the
shards (:func:`fetch`) so that every rank holds the full result, byte for
byte the same.

Ranks are started by :func:`launch` (``torch.multiprocessing`` with the
spawn method), which meets them at a ``FileStore`` in a directory, gives
the group a timeout, joins the ranks with a deadline and raises when one
rank raises or the deadline passes. A rank's device is the card
``cuda:<rank mod cards>`` or the CPU; the backend is NCCL where every rank
has a card of its own, gloo otherwise (two ranks sharing one card: NCCL
refuses that). Under gloo the collectives go through host tensors, under
NCCL through tensors on the card. A failed collective raises.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_rank, axis_size

# this process's rank device, recorded by init_rank (None: not a rank
# started here; see rank_device)
_RANK_DEVICE: list = [None]


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def default_backend(device, n_processes: int) -> str:
    """NCCL when every rank holds a card of its own, gloo otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and n_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_rank(rank: int, world_size: int, store_path: str, device,
              timeout_s: float = 60.0) -> None:
    """Join the default process group as ``rank`` of ``world_size`` at the
    ``FileStore`` ``store_path``, on ``device`` ("cpu" or "cuda": the
    card ``cuda:<rank mod cards>``), with ``timeout_s`` on every
    collective and the backend of :func:`default_backend`. Pins float32
    matmuls (the port's entry points do)."""
    from ..models.lstm import pin_float32

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: a rank on the card cannot start"
                               " (launch(..., device=\"cpu\") for CPU ranks)")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"a rank runs on a card or on the CPU, not {device}")
    pin_float32()
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        default_backend(device, world_size), store=store, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE[0] = device


def rank_device(device=None) -> torch.device:
    """This rank's device. ``device`` None: the one :func:`init_rank`
    recorded, or, in a group initialized elsewhere, the current card
    (``torch.cuda.set_device``), whatever the backend; it raises when there
    is no card (a CPU rank names ``device="cpu"``). A device that is given
    ("cpu", "cuda", "cuda:<i>") is returned, and raises when it is not the
    one :func:`init_rank` recorded, or is the CPU under NCCL."""
    recorded = _RANK_DEVICE[0]
    if device is None and recorded is not None:
        return recorded
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card (torch.cuda.is_available() is false): a mesh "
                "runs on the card by default; pass device=\"cpu\" for CPU "
                "ranks")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"a rank runs on a card or on the CPU, not {device}")
    if recorded is not None and device != recorded:
        raise ValueError(f"device {device} is not this rank's device "
                         f"{recorded}")
    if (device.type == "cpu" and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        raise ValueError("a CPU mesh in an NCCL group: NCCL has no host "
                         "collectives")
    return device


def leave_rank() -> None:
    """Leave the process group :func:`init_rank` joined."""
    dist.destroy_process_group()
    _RANK_DEVICE[0] = None


def _rank_entry(rank, fn, world_size, store_path, device, timeout_s, args):
    if device == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    init_rank(rank, world_size, store_path, device, timeout_s)
    fn(*args)
    leave_rank()


def launch(fn, n_processes: int, args=(), device=None,
           store_dir: str | None = None, deadline_s: float = 600.0,
           timeout_s: float = 60.0) -> None:
    """Run ``fn(*args)`` in ``n_processes`` spawned ranks of one process
    group (``fn`` must be importable by name: a module-level function).
    ``device``: "cuda" (None: the card; it raises when there is none) or
    "cpu". The ranks meet at a ``FileStore`` in ``store_dir`` (a fresh
    temporary directory when None). Raises when a rank raises or exits
    non-zero, and when the ranks have not all ended ``deadline_s`` seconds
    after the start (the ranks are then killed)."""
    import torch.multiprocessing as mp

    from ..align.api import resolve_device

    device = resolve_device(device).type
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        ctx = mp.start_processes(
            _rank_entry, nprocs=n_processes, join=False,
            start_method="spawn",
            args=(fn, n_processes, os.path.join(tmp, "store"), device,
                  timeout_s, tuple(args)))
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=min(1.0, max(0.0, end
                                                    - time.monotonic())),
                               grace_period=5.0):
                if time.monotonic() >= end:
                    raise TimeoutError(
                        f"{n_processes} ranks of {fn.__name__} still running "
                        f"after {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()


def shard_rows(arr, mesh, axis: str = "data", pad: str = "zeros"):
    """This rank's contiguous rows of ``arr`` (numpy or torch, rows on
    axis 0) along ``axis`` of ``mesh``, after padding the rows to a
    multiple of the axis size: with zero rows (``pad="zeros"``) or copies
    of row 0 (``"first"``). Returns (rows, padded row count)."""
    n = axis_size(mesh, axis)
    B = arr.shape[0]
    Bp = -(-B // n) * n
    if Bp != B:
        if isinstance(arr, torch.Tensor):
            fill = (torch.zeros_like(arr[:1]) if pad == "zeros"
                    else arr[:1]).expand(Bp - B, *arr.shape[1:])
            arr = torch.cat([arr, fill])
        else:
            fill = (np.zeros_like(arr[:1]) if pad == "zeros" else arr[:1])
            arr = np.concatenate([arr, np.repeat(fill, Bp - B, axis=0)])
    per = Bp // n
    r = axis_rank(mesh, axis)
    return arr[r * per:(r + 1) * per], Bp


def comm_device(group=None) -> torch.device:
    """Where a collective's tensors live: this rank's card under NCCL, the
    host under gloo (which has no collectives on CUDA tensors)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(local: torch.Tensor, group, n: int,
                    device=None) -> torch.Tensor:
    """The ``n`` ranks' equal-shaped ``local`` tensors of ``group``
    concatenated on axis 0 in rank order, on ``device`` (None:
    ``local``'s). Each tensor crosses to the collective's device
    (:func:`comm_device`) once, and the result once from it."""
    src = local.to(comm_device(group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(local.device if device is None else device)


def fetch(local, mesh, axis: str = "data") -> np.ndarray:
    """The full result on every rank, as a host array: the all-gather of
    every rank's equal-sized row shard along ``axis`` (the collective runs
    even on a one-rank axis, so a one-rank NCCL mesh goes through NCCL).
    A shard on the card is gathered there under NCCL, then copied to the
    host once."""
    local = torch.as_tensor(local)
    return all_gather_rows(local, mesh.get_group(axis),
                           axis_size(mesh, axis), device="cpu").numpy()


def gather_shares(local_shares: dict) -> dict:
    """Every rank's work shares merged: {key: rows}, the same dict on every
    rank. Keys must differ between ranks."""
    if not dist.is_initialized():
        return dict(local_shares)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, dict(local_shares))
    merged: dict = {}
    for p in parts:
        merged.update(p)
    return merged


def assert_same_across_processes(tag: str, value) -> None:
    """Raise unless ``value`` (any small picklable) is byte-identical on
    every rank: an all-gather of an 8-byte sha256 digest of its pickle.
    No-op outside a process group."""
    if not dist.is_initialized():
        return
    digest = hashlib.sha256(pickle.dumps(value)).digest()[:8]
    mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8)
    dev = comm_device()
    parts = [torch.empty(8, dtype=torch.uint8, device=dev)
             for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine.to(dev))
    rows = [bytes(p.cpu().numpy()).hex() for p in parts]
    if len(set(rows)) != 1:
        raise RuntimeError(f"{tag}: value differs across processes (digests "
                           f"by rank {rows})")


def dryrun_body(n_processes: int) -> None:
    """Body of the multi-process dry run, run in every rank: the sharded
    train step, the sharded OCR batch with its global partition proof, the
    sharded folio batch, and the sharded scoring grid, with meshes over
    all ranks; each result byte-identical to the unsharded run and across
    ranks (the JAX package's ``dryrun_body``; its folio batch runs
    ``backend="hybrid"``, the native host raster, where the JAX package's
    runs its default ``"device"``)."""
    import json

    from ..align.api import align_grid
    from ..models.codec import Codec
    from ..models.lstm import init_params_seeded, params_from_np
    from ..models.recognizer import SeqRecognizer, _unpack_wire_rows
    from ..pipeline.preprocess import PreprocParams
    from ..synth import make_page
    from . import data_model_mesh, infer_dp, make_mesh
    from .batch import process_batch
    from .train_dp import sharded_train_demo_step

    if process_count() != n_processes:
        raise RuntimeError(f"dry run of {n_processes} ranks in a group of "
                           f"{process_count()}")
    rank = dist.get_rank()
    dev = rank_device()

    def say(msg):
        if rank == 0:
            print(f"dryrun_multihost({n_processes} ranks, {dev}): {msg}",
                  flush=True)

    # 1. the sharded train step
    mesh2 = data_model_mesh(n_processes)
    loss = sharded_train_demo_step(mesh2)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    assert_same_across_processes("train loss", loss)
    say(f"train step ok over mesh {dict(zip(mesh2.mesh_dim_names, mesh2.shape))}"
        f" loss={loss:.4f} (identical on all {n_processes} ranks)")

    # 2. the sharded OCR batch: global partition proof
    codec = Codec()
    params = params_from_np(init_params_seeded(0, 48, 100, len(codec)), dev)
    mesh1 = make_mesh(n_processes)
    rng = np.random.default_rng(0)
    B, Hp, Wp = max(8, n_processes), 128, 256
    bits = rng.integers(0, 2**31, (B, Hp, Wp // 32)).astype(np.int32)
    hs = np.full(B, 60, np.int32)
    ws = np.full(B, 200, np.int32)
    wire = infer_dp.recognize_sharded(params, bits, hs, ws, mesh1, t_max=256,
                                      target_height=48, pad=16,
                                      max_regions=64)
    packed = _unpack_wire_rows(wire)
    shares = gather_shares(infer_dp.LAST_WORK_SHARES)
    if len(shares) != n_processes or len(set(shares.values())) != 1:
        raise RuntimeError(f"the OCR batch did not partition evenly across "
                           f"the ranks: {shares}")
    assert_same_across_processes("ocr wire", wire.tobytes())
    say(f"sharded OCR ok, decoded counts={packed[:, 0].tolist()}; work "
        f"shares (strips a rank): {shares}")

    # 3. the sharded folio batch: JSON byte-identical to the unsharded run
    # and across ranks
    rec = SeqRecognizer(params, codec, normalize_on_device=True, device=dev)
    pp = PreprocParams(filter_size=8)
    folios = []
    for i in range(2):
        page = make_page(np.random.default_rng(60 + i), n_lines=3,
                         words_per_line=2)
        folios.append((page.image, page.transcript))
    single = process_batch(folios, rec, backend="hybrid", preproc_params=pp,
                           device=dev)
    sharded = process_batch(folios, rec, backend="hybrid", preproc_params=pp,
                            mesh=mesh1, min_align_device_cells=0)
    blobs = []
    for s, m in zip(single, sharded):
        a = None if s is None else json.dumps(s.json_dict, sort_keys=True)
        b = None if m is None else json.dumps(m.json_dict, sort_keys=True)
        if a != b:
            raise RuntimeError("the sharded folio batch differs from the "
                               "unsharded one")
        blobs.append(b)
    assert_same_across_processes("folio json", blobs)
    shares = gather_shares(infer_dp.LAST_WORK_SHARES)
    if len(shares) != n_processes:
        raise RuntimeError(f"the folio batch's OCR did not shard across the "
                           f"ranks: {shares}")
    say(f"sharded folio batch ok, JSON byte-identical to the unsharded run "
        f"and across ranks; OCR shares: {shares}")

    # 4. the sharded scoring grid
    t = list("dominus vobiscum et cum spiritu tuo")
    o = list("domnus vobiscm et cvm spirjtu tuo")
    grid = [[8, -4, -7, -7, -3, 0], [5, -4, -2, -2, 0, 0],
            [11, -10, -7, -7, -5, -5], [8, -7, -5, -2, -3, 0],
            [5, -7, -7, -5, 0, -3], [11, -4, -2, -7, -5, 0],
            [8, -10, -5, -5, -3, -3], [5, -10, -2, -5, 0, -5]]
    got = align_grid(t, o, grid, mesh=mesh1)
    if got != align_grid(t, o, grid, device=dev):
        raise RuntimeError("the sharded scoring grid differs from the "
                           "unsharded one")
    assert_same_across_processes("grid", got)
    say(f"sharded scoring grid ok ({len(grid)} rows over {n_processes} "
        f"ranks, identical)")


def dryrun_multihost(n_processes: int = 2, device=None,
                     store_dir: str | None = None,
                     deadline_s: float = 900.0) -> None:
    """The multi-process dry run: :func:`dryrun_body` in ``n_processes``
    ranks on ``device`` (None: the card, which must exist; "cpu": gloo
    ranks on the host). Raises when a rank fails or the deadline
    passes."""
    launch(dryrun_body, n_processes, args=(n_processes,), device=device,
           store_dir=store_dir, deadline_s=deadline_s)
