"""The paper's own workloads as launchable configs — the Δ-stepping
engine is a first-class 'architecture' of the framework, with the same
dry-run/roofline treatment as the assigned model zoo.

Production sizes follow the paper's largest experiments (small-world
|V| = 6M k=60; RMat |V| = 2M |E| = 40M; 3000×3000 game map), batched
over 16 sources on the data axis (the multi-source regime of the
paper's betweenness-centrality citation [4]).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SSSPConfig

SSSP_SMALLWORLD = SSSPConfig(
    name="sssp-smallworld", graph="smallworld",
    n_nodes=6_000_000, avg_degree=60, delta=10, n_sources=16,
    combine="reduce_scatter")

SSSP_RMAT = SSSPConfig(
    name="sssp-rmat", graph="rmat",
    n_nodes=2_000_000, avg_degree=20, delta=10, n_sources=16,
    combine="reduce_scatter")

SSSP_GAMEMAP = SSSPConfig(
    name="sssp-gamemap", graph="gamemap",
    n_nodes=9_000_000, avg_degree=8, delta=13, n_sources=16,
    combine="reduce_scatter")


def smoke(cfg: SSSPConfig) -> SSSPConfig:
    return dataclasses.replace(cfg, name=cfg.name + "-smoke",
                               n_nodes=512, avg_degree=6, n_sources=2)
