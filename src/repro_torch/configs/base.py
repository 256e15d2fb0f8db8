"""Config schema for every architecture family the framework supports
(counterpart of ``repro.configs.base``: the same fields, defaults and
properties; ``adtype``/``pdtype`` give ``torch.dtype``s).

Configs are frozen dataclasses (hashable).
Exact assigned-architecture instances live in sibling modules
(one file per arch id); reduced smoke variants are derived with
``dataclasses.replace`` by each arch module's ``smoke()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` named ``name`` (``"bfloat16"``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    impl: str = "dense"          # 'dense' (auto-sharded einsum) | 'ep'
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    mlp: str = "swiglu"                  # 'swiglu' | 'geglu' | 'gelu'
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None         # sliding-attention window size
    window_pattern: int = 1              # 1 = every layer local; 2 = alternate
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "float32"               # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = False                  # per-layer activation checkpointing
    attention_chunk: Optional[int] = None  # query-block size (flash-style)
    max_seq_len: int = 8192              # serving cache length

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def adtype(self):
        return _torch_dtype(self.dtype)

    @property
    def pdtype(self):
        return _torch_dtype(self.param_dtype)

    def layer_is_local(self, layer: int) -> bool:
        """gemma2-style alternating local/global attention."""
        if self.window is None:
            return False
        return layer % self.window_pattern == 0

    def n_params(self) -> int:
        """Total parameter count (used by roofline MODEL_FLOPS)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.moe:
            m = self.moe
            gate_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
            ffn = (m.n_experts + m.n_shared_experts) * gate_mats * d \
                * m.d_ff_expert + d * m.n_experts  # + router
        else:
            gate_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
            ffn = gate_mats * d * f
        per_layer = attn + ffn + 2 * d
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.n_params()
        m = self.moe
        d = self.d_model
        gate_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        dense_ffn = gate_mats * d * m.d_ff_expert
        active_ffn = (m.top_k + m.n_shared_experts) * dense_ffn \
            + d * m.n_experts
        full_ffn = (m.n_experts + m.n_shared_experts) * dense_ffn \
            + d * m.n_experts
        return self.n_params() - self.n_layers * (full_ffn - active_ffn)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                   # 'gin' | 'gatedgcn' | 'gat' | 'schnet'
    n_layers: int
    d_hidden: int
    d_in: int = 128
    n_classes: int = 40
    n_heads: int = 1            # gat
    eps_learnable: bool = True  # gin
    n_rbf: int = 300            # schnet radial basis size
    cutoff: float = 10.0        # schnet
    dtype: str = "float32"

    def head_hidden(self) -> int:
        return self.d_hidden * self.n_heads if self.arch == "gat" \
            else self.d_hidden


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    embed_dim: int = 128
    vocab_sizes: Tuple[int, ...] = ()
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


@dataclasses.dataclass(frozen=True)
class SSSPConfig:
    """The paper's own workload as a launchable 'architecture'."""
    name: str
    graph: str                   # 'smallworld' | 'rmat' | 'gamemap' | 'lattice'
    n_nodes: int
    avg_degree: int
    delta: int = 10
    n_sources: int = 16          # batched multi-source
    combine: str = "reduce_scatter"
    local_steps: int = 1


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the (arch × shape) matrix."""
    name: str
    kind: str                    # 'train' | 'prefill' | 'decode' | ...
    seq_len: int = 0
    global_batch: int = 0
    extras: tuple = ()           # family-specific (sorted key/value pairs)

    def extra(self, key, default=None):
        return dict(self.extras).get(key, default)
