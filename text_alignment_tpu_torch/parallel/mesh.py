"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``text_alignment_tpu/parallel/mesh.py``. A JAX mesh is
devices inside one process; PyTorch has no virtual devices, so here a
device of the mesh is one rank of the initialized default process group,
holding one torch device, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over that group with the
dimension names ``("data",)`` or ``("data", "model")``. The backend is the
group's: gloo on the CPU, NCCL where each rank has a card of its own
(:func:`.multihost.default_backend`). There is no fallback to the CPU: the
mesh's device type is each rank's own device, the card unless the caller
names the CPU (``device="cpu"``, or a rank ``multihost.init_rank`` started
there), whatever the group's backend; a mesh the group cannot hold
raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world_size(n_devices: int | None) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: a mesh spans the ranks of "
            "the default group (parallel.multihost.launch starts them)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"{n_devices} ranks; this group has {world}")
    return world


def _device_type(device) -> str:
    """The device type of this rank's mesh (:func:`.multihost.rank_device`:
    None is the device ``init_rank`` recorded, else the card)."""
    from .multihost import rank_device

    return rank_device(device).type


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device=None) -> DeviceMesh:
    """1-D mesh over every rank of the default group (``n_devices``, when
    given, must be its world size). ``device``: this rank's device (None:
    the one ``multihost.init_rank`` recorded, else the card; it raises
    when there is none, and a CPU mesh is asked for by ``device="cpu"``)."""
    n = _world_size(n_devices)
    return init_device_mesh(_device_type(device), (n,),
                            mesh_dim_names=(axis_name,))


def data_model_mesh(n_devices: int | None = None,
                    model_parallel: int | None = None,
                    device=None) -> DeviceMesh:
    """2-D ('data', 'model') mesh; the model axis defaults to 2 when the
    rank count is even, else 1 (pure data parallelism). ``device`` as in
    :func:`make_mesh`."""
    n = _world_size(n_devices)
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} ranks")
    return init_device_mesh(_device_type(device),
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
    if axis not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh, axis: str = "data") -> int:
    """This rank's coordinate along ``axis`` (0 for an absent axis)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh, device=None) -> torch.device:
    """The device of a call under ``mesh``: the one this rank holds in it
    (None), or ``device`` when it is that one; any other device raises."""
    own = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    if device is None:
        return own
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device != own:
        raise ValueError(f"device {device} is not this rank's device {own} "
                         f"in the mesh")
    return device
