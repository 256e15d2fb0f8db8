"""Gradient compression with error feedback (counterpart of
``repro.distributed.compression``): the residual of the compression is
carried to the next step (Karimireddy et al. 2019).

* int8 quantization: a per-tensor scale, round half to even (as
  ``jnp.round``), clipped to [-127, 127];
* top-k sparsification: keep every entry whose magnitude is at least
  the k-th largest (ties included).

Gradient trees are named ``{name: tensor}`` dicts. On the CPU both
schemes equal the reference bitwise.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(g):
    """g → (q int8, scale float32)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def topk_sparsify(g, frac: float):
    """Keep the top-|frac| fraction of entries (by magnitude); returns the
    sparsified dense tensor and the residual (error feedback)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    mask = (torch.abs(flat) >= thresh).to(g.dtype)
    kept = (flat * mask).reshape(g.shape)
    return kept, g - kept


def compress_grads(grads, residuals, *, scheme: str = "int8",
                   topk_frac: float = 0.01) -> Tuple:
    """Apply error-feedback compression to a named gradient tree.

    Returns (compressed_grads, new_residuals). ``residuals`` may be None
    on the first step."""
    if scheme == "int8":
        def comp(g):
            dq = dequantize_int8(*quantize_int8(g))
            return dq, g - dq
    elif scheme == "topk":
        def comp(g):
            return topk_sparsify(g, topk_frac)
    elif scheme == "none":
        def comp(g):
            return g, torch.zeros_like(g)
    else:
        raise ValueError(scheme)
    comp_g, new_res = {}, {}
    for k, g in grads.items():
        # g + 0 as the reference adds its zero residuals (-0.0 → +0.0)
        fed = g + (torch.zeros_like(g) if residuals is None
                   else residuals[k])
        comp_g[k], new_res[k] = comp(fed)
    return comp_g, new_res
