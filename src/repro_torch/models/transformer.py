"""Decoder-only transformer LM of the PyTorch port (counterpart of
``repro.models.transformer``): dense and MoE variants, GQA, sliding
window (gemma2's alternating pattern), attention and logit softcaps,
tied embeddings — the five LM architectures of ``repro_torch.configs``
are instances of this one module.

The reference scans stacked ``(L, ...)`` layer parameters; here the
layers are an ``nn.ModuleList`` of blocks and a Python loop runs them.
The reference's sharding constraints sit where its own do
(``models/sharding.py``): outside a sharding context each returns its
argument itself; inside one (parameters placed by
``param_sharding.lm_param_specs``) the model runs on DTensors, and MoE
layers with ``impl="ep"`` take the expert-parallel region
(``models/moe_ep.py``).

Training differentiates ``lm_loss`` with autograd. Where gradients are
recorded, each block runs under ``torch.utils.checkpoint`` when
``cfg.remat`` is set (the reference's ``jax.checkpoint`` of its scan
body), and each loss chunk always does (as the reference's), so the
backward pass holds no chunk's ``(B, c, V)`` float32 logits but the one
it recomputes. ``init_lm`` returns a model without gradients (serving);
the train step turns them on for the parameters it differentiates.

API (``params`` is the ``LM`` module that ``init_lm`` returns):
  init_lm(cfg, generator, device)        → params
  apply_lm(params, cfg, tokens)          → (logits, aux)    # training
  lm_loss(params, cfg, tokens, labels)   → (loss, metrics)  # chunked xent
  init_cache(cfg, batch, max_len, dtype) → cache
  prefill(params, cfg, tokens, cache)    → (logits_last, cache)
  decode_step(params, cfg, cache, tok)   → (logits, cache)
  params_from_jax(cfg, tree, device)     → params (the reference's tree)

A cache is ``{"k", "v": (L, B, max_len, Hk, Dh) tensors, "len": int}``;
``prefill`` and ``decode_step`` write its ``k``/``v`` in place and return
a dict that shares them.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.embedding import sharded_lookup
from repro_torch.models.layers import (
    _dense_init,
    attention_apply,
    check_loaded,
    init_attention,
    init_mlp,
    init_rms_norm,
    load_tree,
    mlp_apply,
    rms_norm,
)
from repro_torch.models.param_sharding import lm_layer_slice_rule
from repro_torch.models.sharding import (
    constrain,
    constrain_spec,
    current_mesh,
    recompute_context,
)

_BIG_WINDOW = 1 << 30


class Block(nn.Module):
    """One transformer block's parameters: ``attn``, ``attn_norm``,
    ``mlp_norm``, ``moe`` or ``mlp``, and (gemma2 family) the post-block
    norms."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.attn = init_attention(cfg, dt, generator, device)
        self.attn_norm = init_rms_norm(cfg.d_model, dt, device)
        self.mlp_norm = init_rms_norm(cfg.d_model, dt, device)
        if cfg.moe is not None:
            self.moe = moe_lib.init_moe(cfg, dt, generator, device)
        else:
            self.mlp = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dt, generator,
                                device)
        if cfg.attn_softcap is not None:  # gemma2 family: post-block norms
            self.post_attn_norm = init_rms_norm(cfg.d_model, dt, device)
            self.post_mlp_norm = init_rms_norm(cfg.d_model, dt, device)


class LM(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm`` and, untied,
    ``unembed`` (d, V)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        self.embed = _dense_init((cfg.vocab, cfg.d_model), cfg.pdtype,
                                 generator, device, scale=0.02)
        self.layers = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        if not cfg.tie_embeddings:
            self.unembed = _dense_init((cfg.d_model, cfg.vocab), cfg.pdtype,
                                       generator, device)


def init_lm(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random weights drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), on ``device`` (default CUDA; raises without one)."""
    return LM(cfg, generator, resolve_device(device)).requires_grad_(False)


def _layer_window(cfg: LMConfig, idx: int) -> Optional[int]:
    """The layer's attention window (None ⇒ no window mask at all)."""
    if cfg.window is None:
        return None
    if cfg.window_pattern <= 1:
        return cfg.window
    return cfg.window if idx % cfg.window_pattern == 0 else _BIG_WINDOW


def _constrain_layer_slice(lp, prefix: str = ""):
    """This layer's parameters pinned to their layer-slice specs (the
    reference pins its scanned slice, so the FSDP gathers happen per
    layer): a namespace mirroring the block's attributes, or the block
    itself outside a sharding context."""
    if current_mesh() is None:
        return lp
    out = SimpleNamespace()
    for name, p in lp.named_parameters(recurse=False):
        setattr(out, name, constrain_spec(
            p, lm_layer_slice_rule(prefix + name)))
    for name, child in lp.named_children():
        setattr(out, name, _constrain_layer_slice(child, f"{prefix}{name}/"))
    return out


def _block(cfg: LMConfig, lp, x, idx: int, kv=None, cache_len=None):
    """One transformer block. Returns (x, aux, new_kv)."""
    lp = _constrain_layer_slice(lp)
    window = _layer_window(cfg, idx)
    # the residual stream is pinned to its sequence-parallel layout at
    # the block's entry, after attention and after the FFN ('act_seq'
    # maps to the model axis in training)
    x = constrain(x, "dp", "act_seq", None)
    h = whole_seq(rms_norm(lp.attn_norm, x))
    attn_out, new_kv = attention_apply(
        lp.attn, cfg, h, window_arr=window, kv_cache=kv,
        cache_len=cache_len)
    attn_out = whole_seq(attn_out)
    if cfg.attn_softcap is not None:
        attn_out = rms_norm(lp.post_attn_norm, attn_out)
    x = constrain(x + attn_out, "dp", "act_seq", None)
    h = rms_norm(lp.mlp_norm, x)
    if cfg.moe is not None:
        ff, aux = moe_lib.moe_apply(lp.moe, cfg, h)
    else:
        ff = whole_seq(mlp_apply(lp.mlp, whole_seq(h), cfg.mlp))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.attn_softcap is not None:
        ff = rms_norm(lp.post_mlp_norm, ff)
    return constrain(x + ff, "dp", "act_seq", None), aux, new_kv


def _train_block(cfg: LMConfig, lp, x, idx: int):
    x, aux, _ = _block(cfg, lp, x, idx)
    return x, aux


def _stack_scan(cfg: LMConfig, params, x, cache=None, cache_len=None):
    """The layers in order (and the KV cache's layer slices, if
    serving); with ``cfg.remat``, each block is recomputed in the
    backward pass where gradients are recorded."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for idx, lp in enumerate(params.layers):
        if remat:
            x, a = checkpoint(_train_block, cfg, lp, x, idx,
                              use_reentrant=False,
                              context_fn=recompute_context)
        else:
            kv = None if cache is None else (cache["k"][idx],
                                             cache["v"][idx])
            x, a, _ = _block(cfg, lp, x, idx, kv=kv, cache_len=cache_len)
        aux = aux + a
    return x, aux


def whole_seq(x):
    """``x`` (B, S, d) with its sequence whole on every rank. The
    reference's residual stream is sharded over the sequence ('act_seq')
    and GSPMD gathers it into each product and scatters each product's
    sums back; DTensor will not fold a sequence-sharded tensor into a
    product's rows (nor its gradient), so the port gathers a product's
    input, and reduces its output, whole here. ``x`` itself outside a
    sharding context."""
    return constrain(x, "dp", None, None)


def _unembed_weight(params, cfg: LMConfig):
    return params.embed.T if cfg.tie_embeddings else params.unembed


def _softcap_logits(cfg: LMConfig, logits):
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _logits(params, cfg: LMConfig, x):
    x = whole_seq(rms_norm(params.final_norm, x))
    logits = _softcap_logits(
        cfg, x @ _unembed_weight(params, cfg).to(x.dtype))
    return constrain(logits, "dp", None, "tp")


def _embed(params, cfg: LMConfig, tokens):
    table = params.embed
    # under sharding rules each rank looks up its own block of rows
    x = (sharded_lookup(table, tokens) if isinstance(table, DTensor)
         else table[tokens])
    return constrain(x.to(cfg.adtype), "dp", None, None)


def apply_lm(params, cfg: LMConfig, tokens):
    """Training forward: tokens int[B, S] → (logits [B, S, V], aux)."""
    x = _embed(params, cfg, tokens)
    x, aux = _stack_scan(cfg, params, x)
    return _logits(params, cfg, x), aux


def _chunk_xent(cfg: LMConfig, x, w, labels):
    """Summed cross-entropy of one chunk: x (B, c, d), labels (B, c)."""
    logits = constrain(_softcap_logits(cfg, x @ w).float(), "dp", None,
                       "tp")
    lse = torch.logsumexp(logits, dim=-1)
    # under sharding rules the gather from vocab-sharded logits is a
    # masked partial sum; it is reduced before the last dim is dropped
    # (DTensor's mask does not follow the select)
    gold = constrain(torch.gather(logits, -1, labels[..., None].long()),
                     "dp", None, None)[..., 0]
    return (lse - gold).sum()


def lm_loss(params, cfg: LMConfig, tokens, labels, loss_chunk: int = 512):
    """Next-token cross-entropy over sequence chunks, so the (B, S, V)
    logits tensor is never whole (vocab 256k × 4608 tokens would be 4.7
    GB in float32); where gradients are recorded, each chunk is
    recomputed in the backward pass."""
    x = _embed(params, cfg, tokens)
    x, aux = _stack_scan(cfg, params, x)
    x = whole_seq(rms_norm(params.final_norm, x))
    w = _unembed_weight(params, cfg).to(x.dtype)

    b, s, _ = x.shape
    c = min(loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {c}")
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        args = (cfg, x[:, i:i + c], w, labels[:, i:i + c])
        total = total + (checkpoint(_chunk_xent, *args, use_reentrant=False,
                                    context_fn=recompute_context)
                         if grad else _chunk_xent(*args))
    # under sharding rules the chunk sums are partial over the data
    # ranks: they are reduced before ``aux`` (each rank's own, in the
    # expert-parallel region) is added
    total = constrain(total)
    loss = total / (b * s) + aux
    return loss, {"xent": total / (b * s), "aux": aux}


# ------------------------------------------------------------------ serving

def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None):
    dtype = dtype or cfg.adtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": constrain(torch.zeros(shape, dtype=dtype, device=dev),
                           None, "dp", "sp", None, None),
            "v": constrain(torch.zeros(shape, dtype=dtype, device=dev),
                           None, "dp", "sp", None, None),
            "len": 0}


def prefill(params, cfg: LMConfig, tokens, cache):
    """Run the prompt through the model, filling cache[0:S]."""
    x = _embed(params, cfg, tokens)
    x, _ = _stack_scan(cfg, params, x, cache=cache, cache_len=0)
    cache = {"k": cache["k"], "v": cache["v"], "len": int(tokens.shape[1])}
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: LMConfig, cache, tokens):
    """One decode step: tokens int[B, 1] → (logits [B, 1, V], cache)."""
    x = _embed(params, cfg, tokens)
    x, _ = _stack_scan(cfg, params, x, cache=cache, cache_len=cache["len"])
    cache = {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}
    return _logits(params, cfg, x), cache


# ------------------------------------------------- weights of the reference

def params_from_jax(cfg: LMConfig, tree, device=None) -> LM:
    """The port's model holding the reference's parameters: ``tree`` is
    ``repro.models.transformer.init_lm``'s tree as numpy arrays, with
    the stacked ``(L, ...)`` layer arrays."""
    dev = resolve_device(device)
    model = LM(cfg, None, "meta")
    load_tree(model, {k: v for k, v in tree.items() if k != "layers"}, dev)
    for idx, block in enumerate(model.layers):
        load_tree(block, _layer_slice(tree["layers"], idx), dev)
    check_loaded(model)
    return model


def _layer_slice(tree, idx: int):
    return {k: (_layer_slice(v, idx) if isinstance(v, dict) else
                np.asarray(v)[idx]) for k, v in tree.items()}
