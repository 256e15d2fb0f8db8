"""Explicit expert-parallel MoE of the PyTorch port (counterpart of
``repro.models.moe_ep``): the reference's shard_map region, written out
on each rank's local tensors with explicit collectives.

Layout inside the region (per rank, mesh dims pod×data×model):
  tokens   — sharded over (pod, data); *replicated* over model (the
             sequence-parallel residual stream is gathered at the
             region's entry, Megatron-SP pattern).
  experts  — E/|model| local experts per model rank ("no-token-movement"
             EP: every rank routes the full local token block but
             computes only its own experts; the final reduce-scatter
             sums the per-rank partial combines AND returns the result
             sequence-sharded — one collective, half an all-reduce).
  weights  — expert dim over model, f dim over (pod, data) [FSDP];
             gathered per layer *inside* the region with an explicit
             all-gather, so exactly one layer's experts are ever live.

Routing uses the same sort + run-length gather dispatch as ``moe.py``
(capacity drop, per model-rank capacity C = T_loc·k·cf/E).

Gradients flow through the region as through the reference's (shard_map
with ``check_vma=False``): the all-gather's backward is a reduce-scatter
and the other way round; the tokens' and the router's gradients are
summed over the ranks that hold them replicated; ``aux`` is each rank's
own (from its dp block of tokens) and declared replicated, so rank 0's
is the value returned, as device 0's is in the reference; the reference
splits its cotangent over every device, so the gradient is that of the
mean of the dp blocks' aux (ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import _act
from repro_torch.models.moe import expert_counts
from repro_torch.models.sharding import (
    _RULES,
    _translate,
    as_dtensor,
    axis_names,
    axis_size,
    placements,
)


def _axes_tuple(ax):
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


# ------------------------------------------------- collectives with autograd

def _gather(x, dim: int, group):
    """Tiled all-gather of ``x`` along ``dim`` over ``group``."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + xs.shape[1:])
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _scatter(x, dim: int, group):
    """Tiled reduce-scatter (sum) of ``x`` along ``dim`` over ``group``."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + xs.shape[1:])
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    """psum of the partial combines; its backward passes the replicated
    cotangent through (the reference splits it over the model ranks and
    its transpose of ``lax.psum`` sums it back)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitGrad(torch.autograd.Function):
    """Identity whose backward divides the cotangent by ``n``: the
    reference's region (``check_vma=False``) splits the cotangent of an
    output declared replicated evenly over the ``n`` devices it is
    replicated on."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _gather_axes(x, dim: int, mesh, axes):
    """Tiled all-gather over the mesh dims ``axes`` (major to minor): the
    minor dim first, so the blocks land in the reference's order."""
    for a in reversed(axes):
        if axis_size(mesh, a) > 1:
            x = _AllGather.apply(x, dim, mesh.get_group(a))
    return x


def _linear_index(mesh, axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


# --------------------------------------------------------------- the region

def _tokens_in(x, mesh, dp_axes, dp_prod):
    """This rank's (T_loc, d) block of tokens: sharded over dp,
    replicated over the other mesh dims; its gradient is summed over the
    ranks that hold it."""
    b, s, d = x.shape
    names = axis_names(mesh)
    split = [a in dp_axes and axis_size(mesh, a) > 1 for a in names]
    grad = [Shard(0) if sp else Partial() for sp in split]
    x = as_dtensor(x, mesh)
    if b % dp_prod == 0:
        want = [Shard(0) if sp else Replicate() for sp in split]
        return x.redistribute(mesh, want).to_local(
            grad_placements=grad).reshape(-1, d)
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim).reshape(-1, d)
    t_loc = full.shape[0] // dp_prod
    i = _linear_index(mesh, dp_axes)
    return full[i * t_loc:(i + 1) * t_loc]


def _tokens_out(y, mesh, shape, dp_axes, model_ax, scattered: bool):
    """The region's output block ``y`` as a (B, S, d) DTensor in the
    reference's layout: rows of the flattened tokens over (dp, model)
    when ``scattered``, else over dp. Where those row blocks are not
    blocks of (B, S) (the batch does not divide over dp, or a data
    rank's rows neither divide over model nor are one sequence), ``y``
    is gathered to the next layout that is."""
    b, s, d = shape
    names = axis_names(mesh)
    dp_prod = math.prod(axis_size(mesh, a) for a in dp_axes)
    p = axis_size(mesh, model_ax)
    b_loc = b // dp_prod
    dp_shard = [Shard(0) if a in dp_axes and axis_size(mesh, a) > 1
                else Replicate() for a in names]
    place, local = None, None
    if scattered and b % dp_prod == 0 and p > 1:
        if b_loc % p == 0:           # whole sequences over (dp, model)
            place = [Shard(0) if a == model_ax else q
                     for a, q in zip(names, dp_shard)]
            local = (b_loc // p, s, d)
        elif b_loc == 1:             # one sequence, split over model
            place = [Shard(1) if a == model_ax else q
                     for a, q in zip(names, dp_shard)]
            local = (1, s // p, d)
        else:
            y = _AllGather.apply(y, 0, mesh.get_group(model_ax))
    if place is None and b % dp_prod == 0:
        place, local = dp_shard, (b_loc, s, d)
    if place is None:
        for a in reversed(dp_axes):
            if axis_size(mesh, a) > 1:
                y = _AllGather.apply(y, 0, mesh.get_group(a))
        place, local = [Replicate()] * mesh.ndim, (b, s, d)
    return DTensor.from_local(y.reshape(local), mesh, place,
                              run_check=False, shape=torch.Size(shape),
                              stride=(s * d, d, 1))


def _weight_in(w, mesh, spec):
    """The local block of ``w`` laid out by the mesh-dim ``spec``."""
    w = as_dtensor(w, mesh)
    want = placements(mesh, spec)
    if list(w.placements) != want:
        w = w.redistribute(mesh, want)
    return w.to_local()


def _replicated_in(w, mesh):
    """A replicated weight's local copy, its gradient summed over every
    rank."""
    w = as_dtensor(w, mesh)
    want = [Replicate()] * mesh.ndim
    if list(w.placements) != want:
        w = w.redistribute(mesh, want)
    return w.to_local(grad_placements=[Partial()] * mesh.ndim)


def moe_apply_ep(p, cfg, x):
    """x: (B, S, d) → (out (B, S, d), aux). Requires an active
    ``sharding_rules`` context with a 'tp' model axis."""
    rules = _RULES.get()
    mesh = rules.mesh
    model_ax = _translate(rules, "tp")
    fsdp_axes = _axes_tuple(_translate(rules, "fsdp"))
    dp_axes = _axes_tuple(_translate(rules, "dp"))
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    p_model = axis_size(mesh, model_ax)
    e_loc = e // p_model
    if e % p_model:
        raise ValueError(f"{e} experts do not divide over {p_model} model "
                         "ranks")
    dp_prod = math.prod(axis_size(mesh, a) for a in dp_axes)
    if (b * s) % dp_prod:
        raise ValueError(f"{b * s} tokens do not divide over {dp_prod} "
                         "data ranks")
    t_local = b * s // dp_prod
    use_scatter = t_local % p_model == 0 and t_local >= p_model
    act = _act(cfg.mlp)

    xt = _tokens_in(x, mesh, dp_axes, dp_prod)
    router = _replicated_in(p.router, mesh)
    fs = fsdp_axes or None
    wg = _weight_in(p.w_gate, mesh, (model_ax, None, fs))
    wu = _weight_in(p.w_up, mesh, (model_ax, None, fs))
    wd = _weight_in(p.w_down, mesh, (model_ax, fs, None))

    t_loc = xt.shape[0]
    tk = t_loc * k
    cap = max(1, int(t_loc * k / e * m.capacity_factor))
    e0 = mesh.get_local_rank(model_ax) * e_loc
    dev = xt.device

    # FSDP: gather this layer's expert weights over the batch axes
    if fsdp_axes:
        wg = _gather_axes(wg, 2, mesh, fsdp_axes)
        wu = _gather_axes(wu, 2, mesh, fsdp_axes)
        wd = _gather_axes(wd, 1, mesh, fsdp_axes)

    # matmul in activation dtype; softmax/top-k stay float32
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # top-k with equal probabilities in index order, as lax.top_k
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    gate = gate.to(x.dtype)       # combine path stays bf16 end-to-end

    ids_flat = ids.reshape(-1)
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    counts = expert_counts(ids_flat, e)
    starts = torch.searchsorted(sorted_ids, torch.arange(e, device=dev))
    aux = m.router_aux_weight * e * torch.sum(
        probs.mean(0) * counts.float() / tk)

    # dispatch: gather the capacity runs of the local experts only
    starts_loc, counts_loc = starts[e0:e0 + e_loc], counts[e0:e0 + e_loc]
    arange_c = torch.arange(cap, device=dev)
    slot_idx = starts_loc[:, None] + arange_c[None, :]
    valid = arange_c[None, :] < torch.clamp_max(counts_loc, cap)[:, None]
    pair = order[torch.clamp(slot_idx, 0, tk - 1)]
    disp = xt[pair // k]                                   # (E_loc, C, d)
    disp = torch.where(valid[..., None], disp, 0)

    h = act(torch.einsum("ecd,edf->ecf", disp, wg)) \
        * torch.einsum("ecd,edf->ecf", disp, wu)
    out_e = torch.einsum("ecf,efd->ecd", h, wd)            # (E_loc, C, d)

    # combine: this rank's contribution to every (token, choice)
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(tk, device=dev)
    slot_flat = rank_of - starts[ids_flat]
    local = (ids_flat >= e0) & (ids_flat < e0 + e_loc) & (slot_flat < cap)
    gathered = out_e[torch.clamp(ids_flat - e0, 0, e_loc - 1),
                     torch.clamp(slot_flat, 0, cap - 1)]
    gathered = torch.where(local[:, None], gathered.to(x.dtype), 0)
    partial = (gathered * gate.reshape(-1, 1)).reshape(t_loc, k, d).sum(1)

    if use_scatter:
        # sum expert ranks AND return sequence-sharded (SP re-entry)
        y = _ReduceScatter.apply(partial, 0, mesh.get_group(model_ax))
    else:
        # decode-sized token blocks (< |model|): plain all-reduce
        y = _AllReduce.apply(partial, mesh.get_group(model_ax))
    y = _tokens_out(y, mesh, (b, s, d), dp_axes, model_ax, use_scatter)
    aux = DTensor.from_local(_SplitGrad.apply(aux, mesh.size()), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    return y, aux


__all__ = ["moe_apply_ep"]
