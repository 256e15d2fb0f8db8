"""The five assigned LM-family architectures, exact configs from the
public sources cited in the assignment, plus reduced smoke variants.

Memory-feasibility choices for the production shapes (DESIGN.md §6):
bf16 params + remat + microbatching for the two MoE configs; chunked
attention everywhere (the 4k×4k score tile would otherwise dominate).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LMConfig, MoEConfig

# ---------------------------------------------------------------------------
# kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2]
# 61L d=7168 64H (GQA kv=8) expert d_ff=2048, vocab 163840, MoE 384e top-8.
# Spec lists routed experts only (no shared-expert term), so n_shared = 0.
# Optimizer for this config must be factored (adafactor): unfactored Adam
# would need ~16 bytes/param = 16 TB of state.
KIMI_K2 = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25, impl="ep"),
    mlp="swiglu", rope_theta=50000.0,
    dtype="bfloat16", param_dtype="bfloat16",
    remat=True, attention_chunk=512, max_seq_len=131072,
)

# moonshot-v1-16b-a3b — Moonlight 16B (64e top-6) [hf:moonshotai]
MOONSHOT_16B = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  capacity_factor=1.25, impl="ep"),
    mlp="swiglu", dtype="bfloat16", param_dtype="bfloat16",
    remat=True, attention_chunk=512, max_seq_len=131072,
)

# granite-20b — code model, MQA (kv=1), GELU MLP [arXiv:2405.04324]
GRANITE_20B = LMConfig(
    name="granite-20b",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, mlp="gelu",
    dtype="bfloat16", param_dtype="bfloat16",
    remat=True, attention_chunk=512, max_seq_len=131072,
)

# gemma2-9b — alternating local(4096)/global attention, GeGLU,
# attn softcap 50 / final logit softcap 30, tied embeddings, head_dim 256
# [arXiv:2408.00118]
GEMMA2_9B = LMConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, mlp="geglu",
    window=4096, window_pattern=2,
    attn_softcap=50.0, logit_softcap=30.0, tie_embeddings=True,
    dtype="bfloat16", param_dtype="bfloat16",
    remat=True, attention_chunk=512, max_seq_len=131072,
)

# yi-34b — llama-arch GQA [arXiv:2403.04652]
YI_34B = LMConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, mlp="swiglu", rope_theta=5000000.0,
    dtype="bfloat16", param_dtype="bfloat16",
    remat=True, attention_chunk=512, max_seq_len=131072,
)


def smoke(cfg: LMConfig) -> LMConfig:
    """Reduced same-family config: thin layers, few experts, small vocab —
    runs a CPU train/serve step in seconds."""
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=8,
                                  top_k=min(cfg.moe.top_k, 2),
                                  d_ff_expert=64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab=512, moe=moe,
        window=8 if cfg.window else None,
        dtype="float32", param_dtype="float32",
        remat=False, attention_chunk=16, max_seq_len=256,
    )
