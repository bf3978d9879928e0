"""The port's multi-process launcher and dry run (parallel/multihost.py):
the dry run of the JAX package's ``dryrun_multihost`` on two gloo ranks of
the CPU, and the launcher's failure modes, each within its deadline: a
rank that raises, a collective whose peer is gone, a rank past the
deadline. No JAX here: the ranks import this module by name.
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from text_alignment_tpu_torch.parallel import data_model_mesh, make_mesh
from text_alignment_tpu_torch.parallel.multihost import (
    default_backend, dryrun_multihost, init_rank, launch,
    leave_rank, rank_device, shard_rows)

torch.set_num_threads(1)


def _raise_on_rank1():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def _peer_leaves():
    """Rank 1 leaves without its part of the all-gather; rank 0's
    collective must raise (peer gone, or the group's timeout)."""
    if dist.get_rank() == 1:
        return
    parts = [torch.zeros(1) for _ in range(2)]
    dist.all_gather(parts, torch.ones(1))


def _sleep_past_deadline():
    time.sleep(60)


def test_dryrun_multihost_cpu(tmp_path, capsys):
    """The four checks of the dry run (train step, OCR batch with its
    partition proof, folio batch, scoring grid) on two gloo ranks."""
    dryrun_multihost(2, device="cpu", store_dir=str(tmp_path),
                     deadline_s=300)


def test_launcher_raises_when_a_rank_raises(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(_raise_on_rank1, 2, device="cpu", store_dir=str(tmp_path),
               deadline_s=120, timeout_s=20)
    assert time.monotonic() - t0 < 120


def test_launcher_raises_when_a_collective_fails(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="in all_gather"):
        launch(_peer_leaves, 2, device="cpu", store_dir=str(tmp_path),
               deadline_s=120, timeout_s=10)
    assert time.monotonic() - t0 < 120


def test_launcher_kills_ranks_past_the_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch(_sleep_past_deadline, 2, device="cpu",
               store_dir=str(tmp_path), deadline_s=8)
    assert time.monotonic() - t0 < 40


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process "
                                           "group"):
        make_mesh()


def test_dryrun_needs_a_card(monkeypatch):
    """The card is the default; without one the launcher raises before
    starting a rank, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun_multihost(2)


@pytest.mark.parametrize("device,ranks,cards,backend", [
    ("cpu", 4, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 1, "gloo")])
def test_default_backend(monkeypatch, device, ranks, cards, backend):
    """NCCL when every rank has a card of its own; gloo on the CPU and
    for ranks that share a card (NCCL refuses two ranks on one)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend(device, ranks) == backend


def test_init_rank_on_the_card_needs_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_rank(0, 1, os.path.join(tmp_path, "store"), "cuda")
    assert not dist.is_initialized()


def _card_present(monkeypatch, present):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: present)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_group_started_elsewhere_takes_the_card(tmp_path, monkeypatch):
    """A gloo group that init_rank did not start (a user's own
    init_process_group): the mesh's device is the card, not the CPU, and
    without a card a mesh raises unless the caller names the CPU."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        _card_present(monkeypatch, True)
        assert rank_device() == torch.device("cuda", 0)
        assert rank_device("cpu") == torch.device("cpu")
        _card_present(monkeypatch, False)
        for mesh_fn in (make_mesh, data_model_mesh):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                mesh_fn()
            assert mesh_fn(device="cpu").device_type == "cpu"
    finally:
        dist.destroy_process_group()


def test_mesh_device_must_be_the_ranks(tmp_path, monkeypatch):
    """A rank init_rank started on the CPU: its meshes are CPU meshes, and
    asking for the card there raises."""
    init_rank(0, 1, os.path.join(tmp_path, "store"), "cpu")
    try:
        assert make_mesh().device_type == "cpu"
        _card_present(monkeypatch, True)
        with pytest.raises(ValueError, match="not this rank's device"):
            make_mesh(device="cuda")
        with pytest.raises(ValueError, match="a card or on the CPU"):
            rank_device("meta")
    finally:
        leave_rank()
    assert not dist.is_initialized()


def _stub_mesh(n, r):
    return SimpleNamespace(mesh_dim_names=("data",), shape=(n,),
                           get_local_rank=lambda axis: r)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("pad", ["zeros", "first"])
def test_shard_rows_pads_and_partitions(kind, pad):
    """Seven rows over four ranks: two rows a rank, in rank order, the
    eighth a zero row or a copy of row 0."""
    rows = np.arange(7 * 3, dtype=np.int32).reshape(7, 3) + 1
    arr = torch.from_numpy(rows) if kind == "torch" else rows
    shards = [shard_rows(arr, _stub_mesh(4, r), pad=pad) for r in range(4)]
    assert {p for _, p in shards} == {8}
    got = np.concatenate([np.asarray(s) for s, _ in shards])
    fill = np.zeros(3, np.int32) if pad == "zeros" else rows[0]
    np.testing.assert_array_equal(got, np.vstack([rows, fill]))
