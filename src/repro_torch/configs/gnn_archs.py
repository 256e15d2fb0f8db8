"""The four assigned GNN architectures (exact hyper-parameters from the
cited papers) and their four shape cells. Feature/class dimensions are a
property of the *shape* (dataset), applied via ``with_shape_dims``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import GNNConfig

# GIN [arXiv:1810.00826]: 5 layers, hidden 64, sum aggregator, learnable ε
GIN_TU = GNNConfig(name="gin-tu", arch="gin", n_layers=5, d_hidden=64,
                   eps_learnable=True)

# GatedGCN [arXiv:2003.00982]: 16 layers, hidden 70, gated aggregator
GATEDGCN = GNNConfig(name="gatedgcn", arch="gatedgcn", n_layers=16,
                     d_hidden=70)

# GAT on Cora [arXiv:1710.10903]: 2 layers, 8 hidden units, 8 heads
GAT_CORA = GNNConfig(name="gat-cora", arch="gat", n_layers=2, d_hidden=8,
                     n_heads=8)

# SchNet [arXiv:1706.08566]: 3 interactions, hidden 64, 300 RBF, cutoff 10
SCHNET = GNNConfig(name="schnet", arch="schnet", n_layers=3, d_hidden=64,
                   n_rbf=300, cutoff=10.0)

# (d_feat, n_classes) per shape cell — Cora / Reddit-like / ogbn-products /
# TU-molecule conventions.
SHAPE_DIMS = {
    "full_graph_sm": (1433, 7),
    "minibatch_lg": (602, 41),
    "ogb_products": (100, 47),
    "molecule": (28, 2),
}


def with_shape_dims(cfg: GNNConfig, shape_name: str) -> GNNConfig:
    d_in, n_classes = SHAPE_DIMS[shape_name]
    return dataclasses.replace(cfg, d_in=d_in, n_classes=n_classes)


def smoke(cfg: GNNConfig) -> GNNConfig:
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2), d_hidden=16,
        d_in=12, n_classes=5, n_rbf=16, cutoff=5.0)
