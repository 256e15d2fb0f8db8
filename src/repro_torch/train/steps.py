"""Train-step factory of the PyTorch port (counterpart of
``repro.train.steps``): autograd + optimizer + optional microbatch
gradient accumulation and gradient compression with error feedback.

``params`` is an ``nn.Module`` (or a named ``{name: tensor}`` dict); the
optimizer sees ``dict(module.named_parameters())``. The step turns
gradients on for those tensors while it differentiates and restores
their flags after, then writes the optimizer's new values into them in
place under ``torch.no_grad()``. ``donate`` and ``jit`` are taken for
call compatibility: the update is in place whatever ``donate`` says,
and nothing is compiled (``jit`` changes nothing).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.distributed.compression import compress_grads
from repro_torch.optim.optimizers import Optimizer


def named_params(params) -> dict:
    """The named tree of ``params``: a module's ``named_parameters()`` or
    the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _grads(loss_fn, params, named, batch):
    """(loss, metrics, {name: gradient}) of one batch: a parameter the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    leaves = list(named.values())
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    return loss.detach(), _detached(metrics), grads


def _detached(metrics):
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    microbatch: Optional[int] = None,
                    compression: str = "none", topk_frac: float = 0.01,
                    donate: bool = True, jit: bool = True):
    """loss_fn(params, batch) -> (loss, metrics dict).

    microbatch: number of accumulation chunks; every tensor in the batch
    is split along dim 0 and the float32 gradients are averaged (bounds
    activation memory). The loss is the chunks' mean, the metrics the
    last chunk's."""

    def compute_grads(params, named, batch):
        if not microbatch or microbatch <= 1:
            return _grads(loss_fn, params, named, batch)

        def split(x):
            b = x.shape[0]
            assert b % microbatch == 0, (b, microbatch)
            return x.reshape(microbatch, b // microbatch, *x.shape[1:])

        chunks = {k: split(v) for k, v in batch.items()}
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in named.items()}
        loss_acc = None
        for i in range(microbatch):
            loss, metrics, grads = _grads(
                loss_fn, params, named, {k: v[i] for k, v in chunks.items()})
            for k, g in grads.items():
                acc[k] += g.float()
            del grads
            loss_acc = (torch.zeros((), dtype=torch.float32,
                                    device=loss.device)
                        if loss_acc is None else loss_acc) + loss
        inv = 1.0 / microbatch
        return loss_acc * inv, metrics, {k: g * inv for k, g in acc.items()}

    def step(params, opt_state, residuals, batch):
        named = named_params(params)
        loss, metrics, grads = compute_grads(params, named, batch)
        if compression != "none":
            grads, residuals = compress_grads(
                grads, residuals, scheme=compression, topk_frac=topk_frac)
        new, opt_state = optimizer.update(grads, opt_state, named)
        del grads
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])
        metrics = dict(metrics, loss=loss,
                       grad_norm=opt_state.get("grad_norm", 0.0))
        return params, opt_state, residuals, metrics

    return step


def init_residuals(params, compression: str):
    if compression == "none":
        return None
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_params(params).items()}
