"""DLRM MLPerf benchmark config (Criteo 1TB) [arXiv:1906.00091].

Table cardinalities are the canonical MLPerf/Criteo-Terabyte day-feature
counts (26 categorical features; the three ~40M tables dominate — these
are the row-sharded ones).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import DLRMConfig

CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)

DLRM_MLPERF = DLRMConfig(
    name="dlrm-mlperf",
    n_dense=13,
    embed_dim=128,
    vocab_sizes=CRITEO_1TB_VOCABS,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot",
)


def smoke(cfg: DLRMConfig) -> DLRMConfig:
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke",
        embed_dim=16,
        vocab_sizes=tuple([97, 13, 211, 5, 53] + [11] * 21),
        bot_mlp=(32, 16), top_mlp=(64, 32, 1))
