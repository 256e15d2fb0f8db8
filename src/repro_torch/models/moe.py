"""Mixture-of-Experts FFN of the PyTorch port (counterpart of
``repro.models.moe``): token-choice top-k routing with capacity drop.

Dispatch is gather-based, as in the reference:

  1. stable-sort the flattened (token, choice) expert assignments;
  2. each expert's tokens form a contiguous run — its k-th capacity slot
     is ``order[start_e + k]``;
  3. the (E, C, d) dispatch buffer is a gather from the token array, and
     the combine a gather from the expert outputs.

Tokens overflowing an expert's capacity
``max(1, int(T * k / E * capacity_factor))`` are dropped (their gate
weight contributes nothing). In decode ``T`` is the slot count.

``impl="ep"`` takes the expert-parallel region (``models/moe_ep.py``)
inside a sharding context and the dense formulation outside one, as in
the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import _act, _dense_init
from repro_torch.models.sharding import (
    as_dtensor,
    constrain,
    current_mesh,
    full,
)


class SharedExperts(nn.Module):
    """The always-on experts: one gated MLP of width
    ``d_ff_expert * n_shared_experts``."""

    def __init__(self, d: int, fs: int, dtype, generator, device):
        super().__init__()
        self.w_gate = _dense_init((d, fs), dtype, generator, device)
        self.w_up = _dense_init((d, fs), dtype, generator, device)
        self.w_down = _dense_init((fs, d), dtype, generator, device)


class MoE(nn.Module):
    """``router`` (float32), expert ``w_gate``/``w_up`` ``(E, d, f)`` and
    ``w_down`` ``(E, f, d)``, optional ``shared``."""

    def __init__(self, cfg, dtype, generator: torch.Generator, device):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        self.router = _dense_init((d, e), torch.float32, generator, device)
        self.w_gate = _dense_init((e, d, f), dtype, generator, device)
        self.w_up = _dense_init((e, d, f), dtype, generator, device)
        self.w_down = _dense_init((e, f, d), dtype, generator, device)
        if m.n_shared_experts:
            self.shared = SharedExperts(d, f * m.n_shared_experts, dtype,
                                        generator, device)


def init_moe(cfg, dtype, generator: torch.Generator, device) -> MoE:
    return MoE(cfg, dtype, generator, device)


def expert_counts(ids_flat, e: int):
    """``torch.bincount(ids_flat, minlength=e)`` with a static shape (a
    fake tensor cannot give bincount's data-dependent length)."""
    ones = torch.ones_like(ids_flat, dtype=torch.int64)
    return torch.zeros(e, dtype=torch.int64, device=ids_flat.device
                       ).index_add_(0, ids_flat.long(), ones)


def route(p, cfg, xt):
    """The router and the capacity bookkeeping of ``moe_apply`` for
    tokens ``xt`` (T, d): ``(probs, gate, ids_flat, order, counts,
    starts, cap, slot)``. ``slot`` (T·k,) is each (token, choice) pair's
    place in its expert's run: the pair is kept where ``slot < cap``."""
    m = cfg.moe
    t = xt.shape[0]
    e, k = m.n_experts, m.top_k
    tk = t * k
    logits = (xt @ full(p.router).to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # top-k with equal probabilities in index order, as lax.top_k (a
    # stable descending sort; torch.topk leaves the order of ties open)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]                    # (T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    ids_flat = ids.reshape(-1)                             # (TK,)
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    counts = expert_counts(ids_flat, e)                   # (E,)
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(e, device=xt.device))
    cap = max(1, int(t * k / e * m.capacity_factor))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(tk, device=xt.device)
    slot = rank - starts[ids_flat]
    return probs, gate, ids_flat, order, counts, starts, cap, slot


def moe_apply(p, cfg, x):
    """x: (B, S, d) → (out (B, S, d), aux_loss scalar). Takes the
    explicit expert-parallel region when configured and a sharding
    context is active; the dense formulation otherwise."""
    m = cfg.moe
    if m.impl == "ep" and current_mesh() is not None:
        from repro_torch.models.moe_ep import moe_apply_ep
        out, aux = moe_apply_ep(p, cfg, x)
        if m.n_shared_experts:
            sp = p.shared
            act = _act(cfg.mlp)
            # the whole sequence into the products and out of them
            # (transformer.whole_seq)
            xs = constrain(x, "dp", None, None)
            out = out + constrain(
                (act(xs @ sp.w_gate) * (xs @ sp.w_up)) @ sp.w_down, "dp",
                None, None)
        return out, aux
    # Under sharding rules the routing, the dispatch gather and the
    # combine run on the whole token block on every rank (DTensor has no
    # sharding rule for sort, bincount or searchsorted); the expert
    # products run on DTensors between the constraints.
    b, s, d = x.shape
    t = b * s
    xt = full(x).reshape(t, d)
    e, k = m.n_experts, m.top_k
    tk = t * k
    probs, gate, ids_flat, order, counts, starts, cap, slot = route(
        p, cfg, xt)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    aux = m.router_aux_weight * e * torch.sum(me * counts.float() / tk)

    # --- dispatch: gather each expert's capacity run ------------------
    arange_c = torch.arange(cap, device=x.device)
    slot_idx = starts[:, None] + arange_c[None, :]                 # (E, C)
    valid = arange_c[None, :] < torch.clamp_max(counts, cap)[:, None]
    pair = order[torch.clamp(slot_idx, 0, tk - 1)]                 # (E, C)
    disp = xt[pair // k]                                           # (E, C, d)
    disp = torch.where(valid[..., None], disp, 0)
    disp = constrain(disp, "tp", "ep_cap", None)

    act = _act(cfg.mlp)
    h = act(torch.einsum("ecd,edf->ecf", disp, p.w_gate)) \
        * torch.einsum("ecd,edf->ecf", disp, p.w_up)
    h = constrain(h, "tp", "ep_cap", None)
    out_e = torch.einsum("ecf,efd->ecd", h, p.w_down)              # (E, C, d)
    out_e = constrain(out_e, "tp", "ep_cap", None)

    # --- combine: gather every (token, choice)'s expert output --------
    out_e = full(out_e)
    gathered = out_e[ids_flat, torch.clamp(slot, 0, cap - 1)]      # (TK, d)
    gathered = torch.where((slot < cap)[:, None], gathered, 0)
    w_flat = gate.reshape(-1, 1).to(x.dtype)
    out = (gathered * w_flat).reshape(t, k, d).sum(1)              # (T, d)

    if m.n_shared_experts:
        sp = p.shared
        hs = act(xt @ full(sp.w_gate)) * (xt @ full(sp.w_up))
        out = out + hs @ full(sp.w_down)
    out = out.reshape(b, s, d)
    mesh = current_mesh()
    if mesh is None:
        return out, aux
    return as_dtensor(out, mesh), as_dtensor(aux, mesh)
