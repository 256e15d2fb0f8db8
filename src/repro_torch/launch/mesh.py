"""Device meshes over the ranks of a ``torch.distributed`` process group
(counterpart of ``repro.launch.mesh``; one process per GPU, where the
reference's mesh holds the devices of one controller).

Single pod: 16 x 16 = 256 ranks, dims ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, dims ("pod", "data", "model") — the
"pod" dim carries only data parallelism, so its collectives are the
low-frequency reductions that tolerate the slower inter-pod links.

Functions, not module constants: importing this module touches no
device and no process group. ``init_group`` starts the group the way
the launchers do under ``torchrun``.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_group(device):
    """Under ``torchrun`` (``WORLD_SIZE`` in the environment): initialise
    the default process group from the environment — NCCL on
    ``cuda:LOCAL_RANK``, or gloo with a CPU ``device`` — and return this
    rank's device and ``True``; else ``(device, False)``."""
    if "WORLD_SIZE" not in os.environ:
        return device, False
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
        return device, True
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local)
    return local, True


def _mesh(device_type, shape, dims) -> DeviceMesh:
    """A ``shape`` mesh over every rank of the initialised group, in
    rank order (``device_type`` None: the group's backend's, ``cuda``
    for NCCL, ``cpu`` for gloo); raises, naming the group's size, where
    the sizes differ."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            "process group (torchrun, or torch.distributed."
            "init_process_group)")
    ranks, need = dist.get_world_size(), math.prod(shape)
    if need != ranks:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {need} ranks; the "
            f"process group has {ranks}")
    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=dims)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The 256- or 512-rank mesh (``device_type`` ``cpu`` for the dry
    run's fake tensors on the CPU)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    dims = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, dims)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the group's ranks; its device type
    is the group's backend's (``cuda`` for NCCL, ``cpu`` for gloo)."""
    return _mesh(None, (data, model), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


__all__ = ["init_group", "make_host_mesh", "make_production_mesh",
           "mesh_name"]
