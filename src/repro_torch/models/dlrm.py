"""DLRM of the PyTorch port (counterpart of ``repro.models.dlrm``, the
MLPerf config): bottom MLP over dense features, 26 sparse embedding
lookups, dot feature interaction, top MLP → CTR logit. Also the
retrieval-scoring serve path (one query against many candidates as one
batched product, not a loop).

Parameters live in an ``nn.Module`` with the reference's tree keys
(``bot.<i>.w``, ``tables.<i>``, ``top.<i>.b``). Tables hold their rows
padded up to a multiple of 512, as the reference's; a lookup clamps its
ids into the padded table (the reference's ``take(mode="clip")``). The
reference's sharding constraints sit where its own do
(``models/sharding.py``); outside a sharding context each returns its
argument itself.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import DLRMConfig, _torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models.embedding import sharded_lookup
from repro_torch.models.gnn import _mlp, _mlp_init
from repro_torch.models.layers import check_loaded, load_tree
from repro_torch.models.sharding import constrain


class DLRM(nn.Module):
    """``bot`` and ``top`` MLPs, ``tables`` (one per sparse feature)."""

    def __init__(self, cfg: DLRMConfig, generator, device):
        super().__init__()
        dt = _torch_dtype(cfg.dtype)
        scale = 1.0 / math.sqrt(cfg.embed_dim)
        tables = []
        for v in cfg.vocab_sizes:
            # row counts padded to a shardable multiple (standard MLPerf
            # DLRM practice)
            rows = -(-v // 512) * 512
            t = torch.rand((rows, cfg.embed_dim), generator=generator,
                           device=device, dtype=torch.float32)
            tables.append(nn.Parameter(constrain(
                (t * (2 * scale) - scale).to(dt), "fsdp", "tp")))
        self.tables = nn.ParameterList(tables)
        n_feat = 1 + cfg.n_sparse                   # bottom out + embeddings
        d_inter = cfg.embed_dim + n_feat * (n_feat - 1) // 2
        self.bot = _mlp_init((cfg.n_dense,) + cfg.bot_mlp, dt, generator,
                             device)
        self.top = _mlp_init((d_inter,) + cfg.top_mlp, dt, generator, device)


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator, device=None):
    """Random weights drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), on ``device`` (default CUDA; raises without one),
    without gradients (the train step turns them on)."""
    return DLRM(cfg, generator, resolve_device(device)).requires_grad_(False)


def _lookup(table, ids):
    ids = torch.clamp(ids.long(), 0, table.shape[0] - 1)
    if isinstance(table, DTensor):
        # under sharding rules each rank looks up its own block of rows;
        # the partial rows are reduced where the lookup ends
        return constrain(sharded_lookup(table, ids), "dp", None)
    return torch.index_select(table, 0, ids)


def _interact_dot(feats):
    """feats: (B, F, D) → (B, D + F·(F−1)/2): bottom output concatenated
    with the strictly-lower-triangular pairwise dot products (in
    ``tril_indices(F, k=-1)`` order)."""
    b, f, d = feats.shape
    if isinstance(feats, DTensor):
        # on each rank's own batch rows (the card's torch 2.11 has no
        # index_put rule for the pair gather's backward)
        mesh = feats.device_mesh
        want = [p if p == Shard(0) else Replicate() for p in feats.placements]
        out = _interact_dot(feats.redistribute(mesh, want).to_local())
        width = d + f * (f - 1) // 2
        return DTensor.from_local(out, mesh, want, run_check=False,
                                  shape=(b, width), stride=(width, 1))
    z = torch.einsum("bfd,bgd->bfg", feats, feats)
    iu, ju = torch.tril_indices(f, f, offset=-1, device=feats.device)
    return torch.cat([feats[:, 0], z[:, iu, ju]], dim=-1)


def apply_dlrm(params, cfg: DLRMConfig, dense, sparse_ids):
    """dense f32[B, n_dense]; sparse_ids int[B, n_sparse] (single-hot;
    multi-hot callers pre-reduce via embedding_bag). → logits f32[B]."""
    x0 = _mlp(params.bot, dense, final_act=True)          # (B, D)
    embs = [_lookup(t, sparse_ids[:, i]) for i, t in enumerate(params.tables)]
    feats = torch.stack([x0] + embs, dim=1)               # (B, F, D)
    feats = constrain(feats, "dp", None, None)
    z = _interact_dot(feats)
    return _mlp(params.top, z)[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, dense, sparse_ids, labels):
    logits = apply_dlrm(params, cfg, dense, sparse_ids)
    loss = torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))     # stable BCE
    return loss, {"bce": loss}


def retrieval_score(params, cfg: DLRMConfig, dense, sparse_ids,
                    candidate_table, top_k: int = 100):
    """Retrieval cell: embed one (or few) queries through the bottom MLP +
    interaction trunk, score against ``candidate_table`` (N_cand, D) with
    one batched matmul, return top-k (scores, indices)."""
    x0 = _mlp(params.bot, dense, final_act=True)
    embs = [_lookup(t, sparse_ids[:, i]) for i, t in enumerate(params.tables)]
    q = x0 + sum(embs)                                    # (B, D) query vec
    q = constrain(q, "dp", None)
    scores = q @ candidate_table.T                        # (B, N_cand)
    scores = constrain(scores, "dp", "tp")
    return torch.topk(scores, top_k)


def dlrm_params_from_jax(cfg: DLRMConfig, tree, device=None):
    """The port's model holding the reference's parameters: ``tree`` is
    ``repro.models.dlrm.init_dlrm``'s tree as numpy arrays."""
    model = DLRM(cfg, None, "meta")
    load_tree(model, tree, resolve_device(device))
    check_loaded(model)
    return model
