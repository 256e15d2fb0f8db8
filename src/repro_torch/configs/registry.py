"""Arch/shape registry: the (architecture × input-shape) matrix.

``--arch <id>`` everywhere resolves through here. Shapes are per-family
(the assignment pairs each arch with its own shape set); LM decode
shapes lower ``serve_step``, everything else lowers ``train_step`` or
the family's serving entry point.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ShapeSpec

ARCH_IDS = [
    "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "granite-20b", "gemma2-9b",
    "yi-34b",
    "gin-tu", "gatedgcn", "gat-cora", "schnet",
    "dlrm-mlperf",
    # the paper's own workloads (extra, not part of the 40 assigned cells)
    "sssp-smallworld", "sssp-rmat", "sssp-gamemap",
]

LM_SHAPES = [
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
]

GNN_SHAPES = [
    ShapeSpec("full_graph_sm", "train",
              extras=(("n_nodes", 2708), ("n_edges", 10556))),
    ShapeSpec("minibatch_lg", "train",
              extras=(("n_nodes", 232965), ("n_edges", 114615892),
                      ("batch_nodes", 1024), ("fanout", (15, 10)))),
    ShapeSpec("ogb_products", "train",
              extras=(("n_nodes", 2449029), ("n_edges", 61859140))),
    ShapeSpec("molecule", "train",
              extras=(("n_nodes", 30), ("n_edges", 64), ("batch", 128))),
]

RECSYS_SHAPES = [
    ShapeSpec("train_batch", "train", global_batch=65536),
    ShapeSpec("serve_p99", "serve", global_batch=512),
    ShapeSpec("serve_bulk", "serve", global_batch=262144),
    ShapeSpec("retrieval_cand", "serve", global_batch=1,
              extras=(("n_candidates", 1_000_000),)),
]

SSSP_SHAPES = [
    ShapeSpec("multi_source", "solve"),
]

_FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                  "recsys": RECSYS_SHAPES, "sssp": SSSP_SHAPES}


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))


def family_of(arch_id: str) -> str:
    return _module(arch_id).FAMILY


def get_config(arch_id: str, smoke: bool = False):
    mod = _module(arch_id)
    return mod.smoke() if smoke else mod.CONFIG


def shapes_for(arch_id: str) -> List[ShapeSpec]:
    return list(_FAMILY_SHAPES[family_of(arch_id)])


def get_shape(arch_id: str, shape_name: str) -> ShapeSpec:
    for s in shapes_for(arch_id):
        if s.name == shape_name:
            return s
    raise KeyError(f"{arch_id} has no shape {shape_name!r}; "
                   f"available: {[s.name for s in shapes_for(arch_id)]}")


def assigned_cells() -> List[tuple]:
    """The 40 assigned (arch, shape) cells (SSSP extras excluded)."""
    out = []
    for a in ARCH_IDS:
        if a.startswith("sssp-"):
            continue
        for s in shapes_for(a):
            out.append((a, s.name))
    return out


def all_cells() -> List[tuple]:
    out = []
    for a in ARCH_IDS:
        for s in shapes_for(a):
            out.append((a, s.name))
    return out
