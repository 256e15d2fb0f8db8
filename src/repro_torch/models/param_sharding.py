"""Parameter / state / cache specs by parameter name, and their placement
over a ``DeviceMesh`` (counterpart of ``repro.models.param_sharding``).

The LM zoo uses hybrid FSDP + TP: weight matrices shard their input dim
over the batch axes ('fsdp' — ZeRO-3 style, required for the 1T config)
and their output/head/expert dim over 'tp'. Optimizer states inherit
parameter sharding (their moments mirror the parameter tree);
Adafactor's factored vectors are replicated (tiny).

Specs are keyed by ``named_parameters()`` names. The reference stacks
the LM's layers into ``(L, ...)`` arrays; the port holds one module per
layer, so the spec of ``layers.<i>.<path>`` is the reference's stacked
rule without its leading layer dim, which is ``lm_layer_slice_rule``.

Specs here are *logical* (dp/tp/sp); ``to_mesh_spec`` translates through
a mapping (see ``models/sharding.py``) into mesh-dim specs for a
concrete mesh, dropping axes the mesh does not have; ``fit`` drops the
axes that do not divide a dim; ``distribute`` places a module's
parameters or a named state tree on the mesh as DTensors.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.sharding import (
    DEFAULT_MAPPING,
    P,
    PartitionSpec,
    axis_names,
    placements,
    trim,
)


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _lm_rule(path: str, ndim: int) -> P:
    last = path.split("/")[-1]
    if "layers" in path:
        # leading stacked-layer dim
        if last in ("wq", "wk", "wv"):
            return P(None, "fsdp", "tp")
        if last == "wo":
            return P(None, "tp", "fsdp")
        if "moe" in path:
            if last == "router":
                return P(None, None, None)
            if "shared" in path:
                if last in ("w_gate", "w_up"):
                    return P(None, "fsdp", "tp")
                return P(None, "tp", "fsdp")
            if last in ("w_gate", "w_up"):        # (L, E, d, f)
                return P(None, "tp", None, "fsdp")
            if last == "w_down":                  # (L, E, f, d)
                return P(None, "tp", "fsdp", None)
        if last in ("w_gate", "w_up"):
            return P(None, "fsdp", "tp")
        if last == "w_down":
            return P(None, "tp", "fsdp")
        if last == "eps":
            return P(None)
        return P(None, None)                      # norms (L, d)
    if last == "embed":
        # rows over tp only: sharding d over fsdp would force the loss
        # matmul to re-shard activations from batch- to d-sharded (the
        # same physical axes), replicating the batch.
        return P("tp", None)
    if last == "unembed":
        return P(None, "tp")
    return P(None)                                # final_norm etc.


def lm_layer_slice_rule(path_in_layer: str) -> P:
    """Spec of ONE layer's parameter (the stacked rule's leading layer
    dim stripped); ``path_in_layer`` is ``/``- or ``.``-joined."""
    full = _lm_rule("layers/" + path_in_layer.replace(".", "/"), 0)
    return P(*tuple(full)[1:])


def lm_param_specs(params) -> dict:
    """``{name: spec}`` for an ``LM`` module (or its named tree):
    ``layers.<i>.<path>`` by ``lm_layer_slice_rule``, the rest by the
    reference's rule."""
    out = {}
    for name, x in _named(params).items():
        parts = name.split(".")
        if parts[0] == "layers":
            out[name] = lm_layer_slice_rule("/".join(parts[2:]))
        else:
            out[name] = _lm_rule("/".join(parts), x.ndim)
    return out


def gnn_param_specs(params) -> dict:
    # GNN weights are tiny — replicate everything.
    return {name: P() for name in _named(params)}


def dlrm_param_specs(params) -> dict:
    # tables: rows over the batch axes (padded to x512 at init), the
    # embedding dim over tp — both always divisible
    return {name: P("fsdp", "tp") if "tables" in name else P()
            for name in _named(params)}


def cache_specs(long_context: bool = False) -> dict:
    """KV cache (L, B, S, Hk, Dh): batch over dp, sequence over sp
    (flash-decoding style partial-softmax combining — KV head counts
    (1/8/16) don't divide a 16-wide tp axis, and head-replicated caches
    would not fit HBM). Long-context (B == 1) maps sp to *all* axes."""
    kv = P(None, None if long_context else "dp", "sp", None, None)
    return {"k": kv, "v": kv, "len": P()}


def state_specs_like(param_specs: dict, state: dict) -> dict:
    """Optimizer-state specs: moment trees mirror the parameter tree and
    inherit its specs (ZeRO for free); Adafactor's factors and the
    counters replicate."""
    out = {}
    for k, v in state.items():
        if k in ("m", "v"):                       # adam/sgd moments
            out[k] = dict(param_specs)
        elif k == "f":                            # adafactor factors
            out[k] = {name: {kk: P() for kk in s} for name, s in v.items()}
        else:                                     # step, grad_norm, ...
            out[k] = P()
    return out


def to_mesh_spec(spec, mesh: DeviceMesh, mapping=None) -> P:
    mapping = dict(DEFAULT_MAPPING, **(mapping or {}))
    names = axis_names(mesh)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        logical = entry if isinstance(entry, tuple) else (entry,)
        axes = []
        for name in logical:
            ax = mapping.get(name, name)
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a in names and a not in axes:
                    axes.append(a)
        out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes
                                                      else None))
    return P(*out)


def _tree_map(fn, spec_tree):
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree)
    return {k: _tree_map(fn, v) for k, v in spec_tree.items()}


def tree_to_mesh(spec_tree, mesh: DeviceMesh, mapping=None):
    return _tree_map(lambda s: to_mesh_spec(s, mesh, mapping), spec_tree)


def tree_to_placements(spec_tree, mesh: DeviceMesh, mapping=None):
    """The counterpart of the reference's ``tree_to_shardings``: each
    leaf's DTensor placements on ``mesh`` (before ``fit``)."""
    return _tree_map(lambda s: placements(mesh, s),
                     tree_to_mesh(spec_tree, mesh, mapping))


def fit(shape, mesh_spec, mesh: DeviceMesh) -> P:
    """Drop sharded axes that do not divide the argument dimension (the
    reference's jit in_shardings require exact divisibility; e.g. 8 KV
    heads on a 16-wide axis, or a batch of 1). Trims axes right-to-left
    per dim."""
    out = []
    for dim, entry in zip(shape, tuple(mesh_spec) + (None,) * (
            len(shape) - len(mesh_spec))):
        if entry is None:
            out.append(None)
            continue
        out.append(trim(dim, entry if isinstance(entry, tuple) else
                        (entry,), mesh))
    return P(*out)


def place(x: torch.Tensor, mesh_spec, mesh: DeviceMesh) -> DTensor:
    """``x`` (the same global value on every rank) as a DTensor laid out
    by the mesh-dim spec ``mesh_spec`` after ``fit``; each rank keeps a
    copy of its own block (not a view that would hold ``x``), no
    collective."""
    place_ = placements(mesh, fit(x.shape, mesh_spec, mesh))
    local = distribute_tensor(x, mesh, place_,
                              src_data_rank=None).to_local().clone()
    return DTensor.from_local(local, mesh, place_, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute(params, spec_tree, mesh: DeviceMesh, mapping=None):
    """Place a model's parameters, or a named state tree, on ``mesh`` by
    the logical ``spec_tree``. A module's parameters are replaced in
    place by DTensor parameters (their ``requires_grad`` kept) and the
    module returned; a tree is returned as a new tree of DTensors (its
    non-tensor leaves kept)."""
    mesh_specs = tree_to_mesh(spec_tree, mesh, mapping)
    if isinstance(params, nn.Module):
        for name, p in list(params.named_parameters()):
            owner, _, attr = name.rpartition(".")
            mod = params.get_submodule(owner) if owner else params
            setattr(mod, attr, nn.Parameter(
                place(p.detach(), mesh_specs[name], mesh),
                requires_grad=p.requires_grad))
        return params

    def put(x, spec):
        if isinstance(spec, dict):
            return {k: put(x[k], spec[k]) for k in x}
        return place(x, spec, mesh) if isinstance(x, torch.Tensor) else x
    return {k: put(v, mesh_specs[k]) for k, v in params.items()}


__all__ = ["cache_specs", "distribute", "dlrm_param_specs", "fit",
           "gnn_param_specs", "lm_layer_slice_rule", "lm_param_specs",
           "place", "state_specs_like", "to_mesh_spec", "tree_to_mesh",
           "tree_to_placements"]
