"""Logical-axis sharding rules of the PyTorch port (counterpart of
``repro.models.sharding``; MaxText-style, trimmed).

Models annotate activations with *logical* axis names via ``constrain``;
a context installed by the caller maps logical names to the dims of a
``torch.distributed.device_mesh.DeviceMesh``. Outside any context
``constrain`` returns its argument itself, so unit tests and
single-device runs never touch a process group.

Inside a context ``constrain`` redistributes a DTensor to the placements
that the translated spec gives (a plain tensor is taken as replicated
on every rank, as each rank of an SPMD program holds the same value).
A tensor dim mapped to several mesh dims (``("pod", "data")``) is
``Shard(d)`` on each of them, major to minor in the mesh's dim order,
which is how JAX lays out ``P(("pod", "data"))``. The context also
turns on DTensor's implicit replication, so plain tensors made inside
the model (positions, masks, index ranges) combine with DTensors as
replicated values.

Logical axes used across the zoo:
  dp   — batch-like (data × pod)
  tp   — tensor-parallel (heads / d_ff / vocab / experts)
  sp   — sequence (long-context KV sharding)
  ep_cap — MoE capacity rows (sharded over dp to bound dispatch memory)
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_rules", default=None)


class PartitionSpec(tuple):
    """A spec per tensor dim: ``None`` (replicated), a name, or a tuple of
    names (one dim over several axes, major to minor); the names are
    logical (``"dp"``) or mesh dims (``"data"``), as the caller says.
    Dims past the spec's length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: DeviceMesh
    mapping: dict  # logical name -> mesh dim | tuple | None


DEFAULT_MAPPING = {
    "dp": ("pod", "data"),        # batch-like activations
    "fsdp": ("pod", "data"),      # weight sharding (ZeRO-3 / row-sharded)
    "tp": "model",
    "sp": "model",
    "ep_cap": ("pod", "data"),
}


def axis_names(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(axis_names(mesh).index(name))


def _translate(rules: ShardingRules, name):
    if name is None:
        return None
    ax = rules.mapping.get(name)
    if ax is None:
        return None
    names = axis_names(rules.mesh)
    if isinstance(ax, tuple):
        present = tuple(a for a in ax if a in names)
        return present or None
    return ax if ax in names else None


def placements(mesh: DeviceMesh, spec) -> list:
    """The DTensor placements (one per mesh dim) of a spec over ``mesh``'s
    dim names: ``Shard(d)`` on every mesh dim that tensor dim ``d`` is
    split over, ``Replicate()`` on the others."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            # DTensor splits major to minor in the mesh's dim order
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, "
                             f"against the mesh's order {names}")
        for i in idx:
            # a split over a mesh dim of size 1 is a replica (and DTensor
            # folds a replicated dim into a product where it refuses a
            # sharded one)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def as_dtensor(x, mesh: DeviceMesh) -> DTensor:
    """``x`` itself if it is a DTensor; a plain tensor as replicated on
    every rank of ``mesh``."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@contextlib.contextmanager
def sharding_rules(mesh: DeviceMesh, mapping: Optional[dict] = None):
    rules = ShardingRules(mesh, dict(DEFAULT_MAPPING, **(mapping or {})))
    token = _RULES.set(rules)
    try:
        with implicit_replication():
            yield rules
    finally:
        _RULES.reset(token)


@contextlib.contextmanager
def _reinstalled(rules: Optional[ShardingRules]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def recompute_context():
    """``context_fn`` of ``torch.utils.checkpoint``: autograd recomputes
    a checkpointed region on its device thread, where the context
    variable is unset; the recomputation re-enters the rules that the
    forward ran under (none outside a context)."""
    return contextlib.nullcontext(), _reinstalled(_RULES.get())


def _redistribute(rules: ShardingRules, x, spec):
    x = as_dtensor(x, rules.mesh)
    want = placements(rules.mesh, spec)
    if list(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def constrain(x, *logical_names):
    """Lay ``x`` out as the logical axis names say; ``x`` itself when no
    rules are installed (CPU tests)."""
    rules = _RULES.get()
    if rules is None:
        return x
    return _redistribute(rules, x,
                         P(*[_translate(rules, n) for n in logical_names]))


def trim(dim: int, axes: list, mesh: DeviceMesh):
    """``axes`` with axes dropped right to left until their product
    divides ``dim``; a spec entry (None, one name or a tuple)."""
    axes = list(axes)
    while axes:
        prod = 1
        for a in axes:
            prod *= axis_size(mesh, a)
        if dim % prod == 0:
            break
        axes.pop()
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def constrain_spec(x, spec):
    """Like ``constrain`` but takes a spec of logical names (entries may
    be tuples of logical names). Drops axes whose size does not divide
    the dimension: DTensor would accept uneven shards where JAX refuses
    them, and lay the tensor out otherwise."""
    rules = _RULES.get()
    if rules is None:
        return x
    out = []
    for dim, entry in zip(x.shape, tuple(spec) + (None,) * (x.ndim
                                                            - len(spec))):
        if entry is None:
            out.append(None)
            continue
        logical = entry if isinstance(entry, tuple) else (entry,)
        axes = []
        for name in logical:
            ax = _translate(rules, name)
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a not in axes:
                    axes.append(a)
        out.append(trim(dim, axes, rules.mesh))
    return _redistribute(rules, x, P(*out))


def logical_ways(name: str) -> int:
    """How many ways the installed rules split a dim named ``name`` (1
    outside a context)."""
    rules = _RULES.get()
    ax = None if rules is None else _translate(rules, name)
    if ax is None:
        return 1
    return math.prod(axis_size(rules.mesh, a)
                     for a in (ax if isinstance(ax, tuple) else (ax,)))


class _PinGrad(torch.autograd.Function):
    """The identity; its backward lays the gradient out as the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, want = ctx.layout
        g = as_dtensor(g, mesh)
        return g if tuple(g.placements) == want else g.redistribute(
            mesh, list(want))


def pin_grad(x):
    """``x``, whose gradient is laid out as ``x`` itself (a DTensor;
    anything else is returned as it is): for a view whose backward cannot
    take the layout the next op's backward gives."""
    return _PinGrad.apply(x) if isinstance(x, DTensor) else x


def current_mesh() -> Optional[DeviceMesh]:
    rules = _RULES.get()
    return rules.mesh if rules else None


def local_blocks(x, *others, dims=(0, 2)):
    """A DTensor ``x`` and tensors of its shape laid out alike, split over
    ``dims`` only (x's other splits gathered): their local blocks, and a
    function that wraps a local result of x's block shape back into a
    DTensor of x's global shape and layout. For work that is local to
    each rank's block (attention over its batch rows and heads)."""
    mesh = x.device_mesh
    want = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]
    blocks = []
    for t in (x,) + others:
        t = as_dtensor(t, mesh)
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        blocks.append(t.to_local())
    shape = x.shape
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))

    def back(y):
        return DTensor.from_local(y.contiguous(), mesh, want,
                                  run_check=False, shape=shape, stride=stride)
    return blocks, back


def block_of(x, dim: int) -> tuple:
    """``(offset, size)`` of this rank's block of a DTensor's ``dim``: the
    splits over mesh dims in mesh order, each as ``torch.chunk`` (plain
    arithmetic, no tensor: it runs under fake tensors too)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    size, offset = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            chunk = -(-size // mesh.size(i))
            offset += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return offset, size


def full(x):
    """A DTensor's whole value on every rank (gathered; gradients flow
    back to its shards), a plain tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


__all__ = ["DEFAULT_MAPPING", "P", "PartitionSpec", "ShardingRules",
           "as_dtensor", "axis_names", "axis_size", "block_of", "constrain",
           "constrain_spec", "current_mesh", "full", "local_blocks",
           "logical_ways", "pin_grad",
           "placements", "recompute_context",
           "sharding_rules", "trim"]
