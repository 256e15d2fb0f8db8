"""Elastic scaling of the PyTorch port (counterpart of
``repro.distributed.elastic``): re-mesh a live training state when the
pool of ranks changes (node failure shrinks it, recovery grows it).

The state tree is moved onto the new ``DeviceMesh`` with the same
PartitionSpecs — legal whenever the new dim sizes still divide (or pad)
the sharded dimensions. A DTensor cannot be redistributed across meshes,
so each leaf is gathered on its old mesh and its blocks of the new
layout taken on the new one: the values are bitwise the same.
``plan_remesh`` computes the new mesh shape and ``remesh`` executes the
transfer.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.models.param_sharding import place
from repro_torch.models.sharding import PartitionSpec


def plan_remesh(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid that fits the surviving device count,
    preserving the model-parallel degree (weights must keep fitting)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{n_devices} devices")
    return (n_devices // model_parallel, model_parallel)


def make_mesh_from(ranks, shape, names=("data", "model"),
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A ``shape`` mesh over the first ``prod(shape)`` of ``ranks`` (every
    rank of the process group calls it, members or not). ``device_type``
    None: the group's backend's, ``cuda`` for NCCL, ``cpu`` for gloo."""
    n = math.prod(shape)
    if len(ranks) < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; {len(ranks)} given")
    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    grid = torch.tensor(list(ranks)[:n], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def _put(x, spec, new_mesh: DeviceMesh):
    if not isinstance(x, torch.Tensor):
        return x
    if isinstance(x, DTensor):
        x = x.full_tensor()          # every rank of the old mesh
    if new_mesh.get_coordinate() is None:
        return None                  # this rank is not in the new mesh
    return place(x, spec, new_mesh)


def remesh(tree, spec_tree, new_mesh: DeviceMesh):
    """Every tensor leaf of ``tree`` (nested dicts) laid out on
    ``new_mesh`` by its mesh-dim spec (``spec_tree``, or one spec for
    every leaf). On a rank outside ``new_mesh`` the tensor leaves are
    None."""
    if isinstance(spec_tree, PartitionSpec):
        return _map(tree, lambda x: _put(x, spec_tree, new_mesh))
    return _zip(tree, spec_tree, lambda x, s: _put(x, s, new_mesh))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _zip(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn) for k, v in tree.items()}
    return fn(tree, specs)


__all__ = ["make_mesh_from", "plan_remesh", "remesh"]
