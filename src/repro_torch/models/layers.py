"""Transformer building blocks of the PyTorch port (counterpart of
``repro.models.layers``): RMSNorm, RoPE, GQA attention (sliding window,
logit softcap, chunked query blocks), gated MLPs.

Parameters live in ``nn.Module``s whose attribute names are the
reference's parameter-tree keys (``wq``, ``w_gate``, ...); every layer is
a plain function ``f(params, x, ...) -> y`` over them, as in the
reference. Products and attention are plain ``torch`` matmuls and
einsums with the reference's precision choices (scores and softmax in
float32). The reference's sharding constraints sit where its own do
(``models/sharding.py``); outside a sharding context each returns its
argument itself.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.sharding import (
    as_dtensor,
    block_of,
    constrain,
    constrain_spec,
    local_blocks,
    logical_ways,
    pin_grad,
)

# ----------------------------------------------------------------- init utils


def _dense_init(shape, dtype, generator: torch.Generator, device,
                scale: Optional[float] = None) -> nn.Parameter:
    """Normal(0, 1) times ``scale`` (default ``1/sqrt(shape[0])``: for
    expert weights ``(E, d, f)`` that is ``1/sqrt(E)``, as in the
    reference), drawn in float32 from ``generator`` and cast to
    ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter((x * scale).to(dtype))


def tensor_from_numpy(a, device) -> torch.Tensor:
    """An array (bfloat16 ones of ``ml_dtypes`` too: the same bits as
    torch's) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def load_tree(module: nn.Module, tree, device) -> None:
    """Set ``module``'s parameters from a reference tree (nested dicts and
    lists of arrays whose keys and indices are the module's attribute
    names and ``ModuleList``/``ParameterList`` indices), without
    gradients."""
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    for key, value in items:
        name = str(key)
        if isinstance(value, (dict, list, tuple)):
            load_tree(getattr(module, name) if isinstance(key, str)
                      else module[key], value, device)
        else:
            setattr(module, name, nn.Parameter(
                tensor_from_numpy(value, device), requires_grad=False))


def check_loaded(model: nn.Module) -> None:
    """Raise where ``load_tree`` left a parameter of a model built on the
    meta device unset."""
    missing = [n for n, p in model.named_parameters() if p.is_meta]
    if missing:
        raise ValueError(f"the tree has no {missing}")


# --------------------------------------------------------------------- norms

def rms_norm(g, x, eps: float = 1e-6):
    """RMSNorm in float32, scaled by ``1 + g``, cast back to ``x``'s
    dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + g.float())).to(x.dtype)


def init_rms_norm(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((d,), dtype=dtype, device=device))


# ---------------------------------------------------------------------- RoPE

def rope(x, positions, theta: float = 10000.0):
    """Half-split rotary embedding. x: (..., S, H, Dh); positions:
    broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq       # (...,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def _softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _mask(qpos, t: int, device, *, causal: bool, window, kv_len,
          start: int = 0):
    """(..., T) bool: causal order, the window and ``kv_len``, for the
    keys at positions ``start .. start + T - 1``."""
    kpos = start + torch.arange(t, device=device)
    mask = torch.ones(qpos.shape[:-1] + (t,), dtype=torch.bool,
                      device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    if kv_len is not None:
        mask &= kpos < kv_len
    return mask


def gqa_attention(q, k, v, *, q_offset: int, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  kv_len: Optional[int] = None,
                  chunk: Optional[int] = None):
    """Grouped-query attention.

    q: (B, S, H, Dh); k, v: (B, T, Hk, Dh) with H % Hk == 0.
    q_offset: absolute position of q[0] (decode uses the cache length).
    kv_len: valid KV length (entries beyond it are masked; decode with a
    preallocated cache). chunk: query-block size (used only when
    ``chunk < S`` and ``S % chunk == 0``). Scores are float32, the
    softcap comes before the mask, masked entries are ``-1e30``.
    """
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = dh ** -0.5
    if s == 1 and isinstance(k, DTensor):
        return _decode_split_kv(q, k, v, q_offset=q_offset, causal=causal,
                                window=window, softcap=softcap,
                                kv_len=kv_len)
    kf, vf = k.float(), v.float()
    if g > 1 and s == 1:
        # decode: a grouped einsum, K/V never repeated
        qg = q.reshape(b, 1, hk, g, dh).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        scores = _softcap(scores, softcap)
        qpos = torch.full((1, 1), q_offset, device=q.device)
        mask = _mask(qpos, t, q.device, causal=causal, window=window,
                     kv_len=kv_len)
        scores = scores.masked_fill(~mask, -1e30)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        return out.to(q.dtype).reshape(b, 1, h, dh)
    if g > 1:
        kf = constrain_spec(kf.repeat_interleave(g, dim=2),
                            ("dp", None, "tp", None))
        vf = constrain_spec(vf.repeat_interleave(g, dim=2),
                            ("dp", None, "tp", None))

    def attend(q, kf, vf):
        def block(q_blk, off: int):
            # q_blk: (B, c, H, Dh)
            scores = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), kf) \
                * scale
            scores = _softcap(scores, softcap)
            qpos = off + torch.arange(q_blk.shape[1],
                                      device=q.device)[:, None]
            mask = _mask(qpos, t, q.device, causal=causal, window=window,
                         kv_len=kv_len)
            scores = scores.masked_fill(~mask, -1e30)
            p = torch.softmax(scores, dim=-1)
            return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)

        if chunk is None or chunk >= s or s % chunk != 0:
            return block(q, q_offset)
        return torch.cat([block(q[:, i:i + chunk], q_offset + i)
                          for i in range(0, s, chunk)], dim=1)

    if not isinstance(q, DTensor):
        return attend(q, kf, vf)
    # under sharding rules each rank attends over its own block of batch
    # rows and heads, on local tensors (DTensor cannot fold head-sharded
    # scores into a batched product)
    (q, kf, vf), back = local_blocks(q, kf, vf)
    return back(attend(q, kf, vf))


def _decode_split_kv(q, k, v, *, q_offset: int, causal: bool, window,
                     softcap, kv_len):
    """One decode query against a DTensor cache whose sequence is split
    over mesh dims (the reference's flash-decoding layout): each rank
    attends over its own block of the cache on local tensors, and the
    blocks' partial softmaxes (max, sum, weighted values) are combined
    over the dims that split the sequence. The cache's batch split is
    kept, its head split gathered; the query follows the cache's batch
    split. Returns a DTensor laid out as the query block."""
    from torch.distributed import _functional_collectives as funcol

    mesh = k.device_mesh
    seq = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    kv_want = [p if p in (Shard(0), Shard(1)) else Replicate()
               for p in k.placements]
    q_want = [p if p == Shard(0) else Replicate() for p in k.placements]
    kl = k.redistribute(mesh, kv_want).to_local().float()
    vl = v.redistribute(mesh, kv_want).to_local().float()
    ql = as_dtensor(q, mesh).redistribute(mesh, q_want).to_local()
    first, t = block_of(k, 1)
    b, _, h, dh = ql.shape
    hk = kl.shape[2]
    qg = ql.reshape(b, 1, hk, h // hk, dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kl) * dh ** -0.5
    scores = _softcap(scores, softcap)
    qpos = torch.full((1, 1), q_offset, device=ql.device)
    mask = _mask(qpos, t, ql.device, causal=causal, window=window,
                 kv_len=kv_len, start=first)
    scores = scores.masked_fill(~mask, -1e30)
    m = scores.amax(dim=-1, keepdim=True)                 # (b, hk, g, 1, 1)
    top = m
    for i in seq:
        top = funcol.all_reduce(top, "max", mesh.get_group(i))
    p = torch.exp(scores - top)
    num = torch.einsum("bhgqk,bkhd->bqhgd", p, vl)
    den = p.sum(dim=-1, keepdim=True).permute(0, 3, 1, 2, 4)
    for i in seq:
        num = funcol.all_reduce(num, "sum", mesh.get_group(i))
        den = funcol.all_reduce(den, "sum", mesh.get_group(i))
    out = (num / den).to(ql.dtype).reshape(b, 1, h, dh)
    shape = (q.shape[0], 1, h, dh)
    return DTensor.from_local(out.contiguous(), mesh, q_want,
                              run_check=False, shape=shape,
                              stride=(h * dh, h * dh, dh, 1))


# ---------------------------------------------------------------------- MLPs

def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def _act(kind: str):
    return F.silu if kind == "swiglu" else _gelu


class MLP(nn.Module):
    """``w_up``, ``w_down`` and, for gated kinds, ``w_gate``."""

    def __init__(self, d_model: int, d_ff: int, kind: str, dtype,
                 generator: torch.Generator, device):
        super().__init__()
        self.w_up = _dense_init((d_model, d_ff), dtype, generator, device)
        self.w_down = _dense_init((d_ff, d_model), dtype, generator, device)
        if kind in ("swiglu", "geglu"):
            self.w_gate = _dense_init((d_model, d_ff), dtype, generator,
                                      device)


def mlp_apply(p, x, kind: str):
    if kind in ("swiglu", "geglu"):
        h = _act(kind)(x @ p.w_gate) * (x @ p.w_up)
        return h @ p.w_down
    return _gelu(x @ p.w_up) @ p.w_down


def init_mlp(d_model: int, d_ff: int, kind: str, dtype,
             generator: torch.Generator, device) -> MLP:
    return MLP(d_model, d_ff, kind, dtype, generator, device)


# ----------------------------------------------------------- attention block

class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (``x @ w`` layout, as the
    reference)."""

    def __init__(self, cfg, dtype, generator: torch.Generator, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        self.wq = _dense_init((d, cfg.n_heads * hd), dtype, generator, device)
        self.wk = _dense_init((d, cfg.n_kv_heads * hd), dtype, generator,
                              device)
        self.wv = _dense_init((d, cfg.n_kv_heads * hd), dtype, generator,
                              device)
        self.wo = _dense_init((cfg.n_heads * hd, d), dtype, generator, device)


def init_attention(cfg, dtype, generator: torch.Generator,
                   device) -> Attention:
    return Attention(cfg, dtype, generator, device)


def _split_heads(x, n: int, hd: int):
    """(B, S, n·hd) → (B, S, n, hd). Under sharding rules a last dim
    split over more ranks than divide ``n`` is gathered first (DTensor
    cannot unflatten an uneven split of the heads)."""
    b, s, _ = x.shape
    if isinstance(x, DTensor):
        ways = 1
        for place, size in zip(x.placements, x.device_mesh.shape):
            if place == Shard(2):
                ways *= size
        if n % ways:
            x = constrain(x, "dp", None, None)
    return x.reshape(b, s, n, hd)


def _write_cache(c, start: int, new):
    """``c[:, start:start + S] = new`` in place. A DTensor cache is
    written on each rank's own block of its sequence (DTensor writes a
    slice of a split dim into a copy, not into the cache)."""
    s = new.shape[1]
    if not isinstance(c, DTensor):
        c[:, start:start + s] = new.to(c.dtype)
        return
    mesh = c.device_mesh
    want = [Replicate() if p == Shard(1) else p for p in c.placements]
    rows = as_dtensor(new.to(c.dtype), mesh).redistribute(mesh,
                                                          want).to_local()
    first, size = block_of(c, 1)
    lo, hi = max(start, first), min(start + s, first + size)
    if lo < hi:
        c.to_local()[:, lo - first:hi - first] = rows[:, lo - start:hi - start]


def _merge_heads(x):
    """(B, S, n, hd) → (B, S, n·hd). Under sharding rules, where the
    heads do not divide over tp the gradient of the merged dim (split
    over tp by the output product) is laid out as the forward's before
    it reaches the view's backward (DTensor cannot unflatten an uneven
    split)."""
    b, s, n, hd = x.shape
    y = x.reshape(b, s, n * hd)
    if isinstance(y, DTensor) and n % logical_ways("tp"):
        y = pin_grad(y)
    return y


def attention_apply(p, cfg, x, *, window_arr: Optional[int] = None,
                    kv_cache=None, cache_len: Optional[int] = None):
    """Returns ``(out, new_kv)``: ``new_kv`` is ``(k, v)`` of this call's
    tokens when ``kv_cache`` is None, else the cache tuple, whose
    ``(B, T, Hk, Dh)`` tensors this call writes in place at
    ``cache_len`` (the start clamped to ``T - S``, as the reference's
    ``dynamic_update_slice``). ``window_arr`` None disables windowing."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    offset = cache_len if cache_len is not None else 0
    q = _split_heads(x @ p.wq, cfg.n_heads, hd)
    k = _split_heads(x @ p.wk, cfg.n_kv_heads, hd)
    v = _split_heads(x @ p.wv, cfg.n_kv_heads, hd)
    # heads split over tp only where it divides them (yi-34b's 56 heads
    # and MQA's one K/V head stay whole on a 16-wide tp: DTensor cannot
    # fold an uneven split of the heads into a later view)
    q = constrain_spec(q, ("dp", None, "tp", None))
    k = constrain_spec(k, ("dp", None, "tp", None))
    v = constrain_spec(v, ("dp", None, "tp", None))
    positions = offset + torch.arange(s, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        start = max(0, min(cache_len, ck.shape[1] - s))
        _write_cache(ck, start, k)
        _write_cache(cv, start, v)
        out = gqa_attention(q, ck, cv, q_offset=offset,
                            window=window_arr, softcap=cfg.attn_softcap,
                            kv_len=cache_len + s,
                            chunk=cfg.attention_chunk)
        new_kv = (ck, cv)
    else:
        out = gqa_attention(q, k, v, q_offset=0, window=window_arr,
                            softcap=cfg.attn_softcap,
                            chunk=cfg.attention_chunk)
        new_kv = (k, v)
    out = _merge_heads(out) @ p.wo
    return out, new_kv
