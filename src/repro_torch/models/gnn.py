"""GNN zoo of the PyTorch port (counterpart of ``repro.models.gnn``):
GIN, GatedGCN, GAT, SchNet, all built on the edge-index → segment-reduce
message-passing primitive (``models.embedding``'s ``segment_sum`` /
``segment_max``), the SpMM/SDDMM regime of the kernel taxonomy. The
same substrate carries the Δ-stepping scatter-min (DESIGN.md §5).

Graphs arrive as fixed-shape COO edge lists (src, dst int[E]); padding
edges use src == dst == n (rows gather zeros, scatters drop them).
Parameters live in ``nn.Module``s whose attribute names and list
indices are the reference's parameter-tree keys (``layers.0.mlp.1.w``);
every ``apply_*`` is a plain function over them. The reference's
sharding constraints sit where its own do (``models/sharding.py``);
outside a sharding context each returns its argument itself.

API: ``init_gnn(cfg, generator, device)``, ``apply_gnn(params, cfg,
inputs)``, ``gnn_loss(params, cfg, inputs, labels, label_mask)``,
``gnn_params_from_jax(cfg, tree, device)``.
"""
from __future__ import annotations

import math

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import GNNConfig, _torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models.embedding import segment_max, segment_sum, take_fill
from repro_torch.models.layers import _dense_init, check_loaded, load_tree
from repro_torch.models.sharding import _reinstalled, as_dtensor, constrain


class Dense(nn.Module):
    """``w`` (a, b) and ``b`` (b,): one layer of an MLP."""

    def __init__(self, a: int, b: int, dtype, generator, device):
        super().__init__()
        self.w = _dense_init((a, b), dtype, generator, device)
        self.b = nn.Parameter(torch.zeros((b,), dtype=dtype, device=device))


def _mlp_init(dims, dtype, generator, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(a, b, dtype, generator, device)
                         for a, b in zip(dims[:-1], dims[1:]))


def _mlp(params, x, act=F.relu, final_act=False):
    for i, p in enumerate(params):
        x = x @ p.w + p.b
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


# ------------------------------------------------------------------------ GIN

class GINLayer(nn.Module):
    def __init__(self, d_in: int, d: int, dtype, generator, device):
        super().__init__()
        self.mlp = _mlp_init((d_in, d, d), dtype, generator, device)
        self.eps = nn.Parameter(torch.zeros((), dtype=torch.float32,
                                            device=device))


class GIN(nn.Module):
    def __init__(self, cfg: GNNConfig, generator, device):
        super().__init__()
        d, dt = cfg.d_hidden, _torch_dtype(cfg.dtype)
        self.layers = nn.ModuleList(
            GINLayer(cfg.d_in if li == 0 else d, d, dt, generator, device)
            for li in range(cfg.n_layers))
        self.readout = _mlp_init((d, cfg.n_classes), dt, generator, device)


def apply_gin(params, cfg: GNNConfig, x, src, dst):
    n = x.shape[0]
    for lp in params.layers:
        agg = segment_sum(take_fill(x, src), dst, n)      # sum aggregator
        x = _mlp(lp.mlp, (1.0 + lp.eps) * x + agg)
        x = constrain(x, "tp", None)
    return _mlp(params.readout, x)


# -------------------------------------------------------------------- GatedGCN

class GatedGCNLayer(nn.Module):
    def __init__(self, d: int, dtype, generator, device):
        super().__init__()
        for name in ("A", "B", "C", "U", "V"):
            setattr(self, name, _dense_init((d, d), dtype, generator, device))


class GatedGCN(nn.Module):
    def __init__(self, cfg: GNNConfig, generator, device):
        super().__init__()
        d, dt = cfg.d_hidden, _torch_dtype(cfg.dtype)
        self.layers = nn.ModuleList(GatedGCNLayer(d, dt, generator, device)
                                    for _ in range(cfg.n_layers))
        self.embed = _dense_init((cfg.d_in, d), dt, generator, device)
        self.embed_e = _dense_init((1, d), dt, generator, device)
        self.readout = _mlp_init((d, cfg.n_classes), dt, generator, device)


def apply_gatedgcn(params, cfg: GNNConfig, x, src, dst, e_feat=None):
    n = x.shape[0]
    h = x @ params.embed
    if e_feat is None:
        e_feat = torch.ones((src.shape[0], 1), dtype=h.dtype, device=h.device)
    e = e_feat @ params.embed_e
    for lp in params.layers:
        hi, hj = take_fill(h, dst), take_fill(h, src)
        e = e + hi @ lp.A + hj @ lp.B                     # edge update
        e = constrain(e, "nodes", None)
        gate = torch.sigmoid(e)
        msg = gate * (hj @ lp.V)
        denom = segment_sum(gate, dst, n) + 1e-6
        h_new = h @ lp.U + segment_sum(msg, dst, n) / denom
        h = F.relu(h_new) + h                             # residual
        h = constrain(h, "nodes", None)
    return _mlp(params.readout, h)


# ------------------------------------------------------------------------ GAT

class GATLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, hh: int, dtype, generator,
                 device):
        super().__init__()
        self.w = _dense_init((d_in, hh * d_out), dtype, generator, device)
        self.a_src = _dense_init((hh, d_out), dtype, generator, device)
        self.a_dst = _dense_init((hh, d_out), dtype, generator, device)


class GAT(nn.Module):
    def __init__(self, cfg: GNNConfig, generator, device):
        super().__init__()
        d, hh, dt = cfg.d_hidden, cfg.n_heads, _torch_dtype(cfg.dtype)
        self.layers = nn.ModuleList(
            GATLayer(cfg.d_in if li == 0 else d * hh,
                     cfg.n_classes if li == cfg.n_layers - 1 else d, hh, dt,
                     generator, device)
            for li in range(cfg.n_layers))


def _edge_softmax(scores, dst, n):
    """Per-destination softmax over incoming edges (SDDMM → segment
    softmax), padding-safe via segment_max normalization."""
    smax = segment_max(scores, dst, n)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - take_fill(smax, dst))
    denom = segment_sum(ex, dst, n)
    return ex / torch.clamp(take_fill(denom, dst), min=1e-9)


def apply_gat(params, cfg: GNNConfig, x, src, dst):
    w0 = params.layers[0].w
    if isinstance(w0, DTensor):
        # under sharding rules DTensor lays the heads' reshapes out in
        # strided shards that it cannot fold into the next op: every rank
        # runs the whole GAT on whole operands (a replicate detour)
        mesh = w0.device_mesh
        whole = [Replicate()] * mesh.ndim

        def loc(t):
            return as_dtensor(t, mesh).redistribute(mesh, whole).to_local()

        local = SimpleNamespace(layers=[SimpleNamespace(
            w=loc(lp.w), a_src=loc(lp.a_src), a_dst=loc(lp.a_dst))
            for lp in params.layers])
        with _reinstalled(None):
            h = apply_gat(local, cfg, loc(x), loc(src), loc(dst))
        return DTensor.from_local(h, mesh, whole, run_check=False)
    n = x.shape[0]
    n_layers = len(params.layers)
    h = x
    for li, lp in enumerate(params.layers):
        hh = cfg.n_heads
        d_out = lp.w.shape[1] // hh
        z = (h @ lp.w).reshape(n, hh, d_out)
        s_src = (z * lp.a_src).sum(-1)                    # (n, H)
        s_dst = (z * lp.a_dst).sum(-1)
        scores = F.leaky_relu(
            take_fill(s_src, src) + take_fill(s_dst, dst), 0.2)
        alpha = _edge_softmax(scores, dst, n)             # (E, H)
        msg = take_fill(z, src) * alpha[..., None]
        out = segment_sum(msg, dst, n)                    # (n, H, d_out)
        if li < n_layers - 1:
            h = F.elu(out.reshape(n, hh * d_out))
        else:
            h = out.mean(dim=1)                           # avg heads
        h = constrain(h, "tp", None)
    return h


# --------------------------------------------------------------------- SchNet

class Interaction(nn.Module):
    def __init__(self, cfg: GNNConfig, dtype, generator, device):
        super().__init__()
        d = cfg.d_hidden
        self.filter = _mlp_init((cfg.n_rbf, d, d), dtype, generator, device)
        self.w_in = _dense_init((d, d), dtype, generator, device)
        self.w_out = _mlp_init((d, d, d), dtype, generator, device)


class SchNet(nn.Module):
    def __init__(self, cfg: GNNConfig, generator, device):
        super().__init__()
        d, dt = cfg.d_hidden, _torch_dtype(cfg.dtype)
        self.interactions = nn.ModuleList(
            Interaction(cfg, dt, generator, device)
            for _ in range(cfg.n_layers))
        self.embed = _dense_init((100, d), dt, generator, device)  # z < 100
        self.readout = _mlp_init((d, d // 2, 1), dt, generator, device)


def _rbf_expand(dist, n_rbf: int, cutoff: float):
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers) ** 2)


def _ssp(x):  # shifted softplus, SchNet's activation
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device)) - math.log(2.0)


def apply_schnet(params, cfg: GNNConfig, atom_z, pos, src, dst):
    """atom_z int[n] atomic numbers, pos f32[n, 3], edges (src, dst).
    Returns per-graph energy contribution per atom (n, 1); callers
    segment-sum over molecules."""
    n = atom_z.shape[0]
    emb = params.embed
    h = torch.index_select(                               # mode="clip"
        emb, 0, torch.clamp(atom_z.long(), 0, emb.shape[0] - 1))
    diff = take_fill(pos, src) - take_fill(pos, dst)
    dist = torch.sqrt((diff ** 2).sum(-1) + 1e-12)
    rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)        # (E, n_rbf)
    fcut = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                  + 1.0)
    for lp in params.interactions:
        w = _mlp(lp.filter, rbf, act=_ssp, final_act=True)
        w = w * fcut[:, None]                             # smooth cutoff
        m = take_fill(h @ lp.w_in, src) * w               # cfconv messages
        agg = segment_sum(m, dst, n)
        h = h + _mlp(lp.w_out, agg, act=_ssp)
        h = constrain(h, "tp", None)
    return _mlp(params.readout, h, act=_ssp)


# ---------------------------------------------------------------- dispatcher

MODELS = {"gin": GIN, "gatedgcn": GatedGCN, "gat": GAT, "schnet": SchNet}


def init_gnn(cfg: GNNConfig, generator: torch.Generator, device=None):
    """Random weights drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), on ``device`` (default CUDA; raises without one),
    without gradients (the train step turns them on)."""
    return MODELS[cfg.arch](cfg, generator,
                            resolve_device(device)).requires_grad_(False)


def apply_gnn(params, cfg: GNNConfig, inputs):
    """inputs: dict with keys per arch (x/src/dst [+ pos/atom_z])."""
    if cfg.arch == "gin":
        return apply_gin(params, cfg, inputs["x"], inputs["src"],
                         inputs["dst"])
    if cfg.arch == "gatedgcn":
        return apply_gatedgcn(params, cfg, inputs["x"], inputs["src"],
                              inputs["dst"], inputs.get("e_feat"))
    if cfg.arch == "gat":
        return apply_gat(params, cfg, inputs["x"], inputs["src"],
                         inputs["dst"])
    if cfg.arch == "schnet":
        return apply_schnet(params, cfg, inputs["atom_z"], inputs["pos"],
                            inputs["src"], inputs["dst"])
    raise ValueError(cfg.arch)


def gnn_loss(params, cfg: GNNConfig, inputs, labels, label_mask=None):
    out = apply_gnn(params, cfg, inputs)
    if cfg.arch == "schnet":                              # energy regression
        n_mol = labels.shape[0]
        energy = segment_sum(out[:, 0], inputs["mol_id"], n_mol)
        # the reference's metric (a flag, not the value: ROADMAP Queue 3)
        return torch.mean((energy - labels) ** 2), {"mse": True}
    logp = torch.log_softmax(out.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if label_mask is not None:
        return ((nll * label_mask).sum()
                / torch.clamp(label_mask.sum(), min=1)), {}
    return nll.mean(), {}


def gnn_params_from_jax(cfg: GNNConfig, tree, device=None):
    """The port's model holding the reference's parameters: ``tree`` is
    ``repro.models.gnn.init_gnn``'s tree as numpy arrays."""
    model = MODELS[cfg.arch](cfg, None, "meta")
    load_tree(model, tree, resolve_device(device))
    check_loaded(model)
    return model
