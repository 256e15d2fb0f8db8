"""Optimizers of the PyTorch port as pure ``(init, update)`` pairs
(counterpart of ``repro.optim.optimizers``): AdamW, Adafactor (factored
second moment), SGD-momentum, global-norm clipping, the warmup-cosine
schedule. No ``torch.optim``: its AdamW orders its rounding otherwise
(decay first, ``lr / bc1`` folded into the step size), and the state
here is a tree of tensors that the trainer checkpoints and restores
bitwise.

The trees are **named**: ``{name: tensor}`` dicts, e.g.
``dict(module.named_parameters())``. ``update(grads, state, params)``
returns new tensors (``new_params``, ``new_state``) and leaves its
arguments untouched; the train step copies the new parameters into the
module in place. The clip scale is applied inside each leaf's float32
update, where the reference's clipped gradient is float32 too (a bf16
gradient times a float32 scale promotes there), so no clipped copy of
the whole gradient tree is made.

The reference's LM stacks its layers along a leading dim; the port's
leaves are per layer. Adafactor's update clip (the RMS of a leaf's
update) and its slice-at-a-time path therefore act per layer here, as
the reference's chunked path does for stacks past 256 MiB.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.layers import tensor_from_numpy

# a leaf of ndim >= 3 with more float32 bytes than this is updated one
# leading slice at a time (the reference's lax.map path)
_CHUNK_BYTES = 1 << 28


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf of a named tree, in
    float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree.values()))


def _clip_scale(grads, max_norm):
    """(scale or None, the gradients' global norm)."""
    norm = global_norm(grads)
    if max_norm is None:
        return None, norm
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped, norm)``: every leaf times ``min(1, max_norm / norm)``,
    promoted to float32 as the reference promotes it."""
    scale, norm = _clip_scale(grads, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, norm


def _f32(g, scale):
    g = g.float()
    return g if scale is None else g * scale


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    """lr(step): linear warmup to ``base_lr``, then a cosine to
    ``final_frac * base_lr`` at ``total``; ``step`` an integer tensor,
    the result a float32 tensor."""
    def lr(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def _counters(params):
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "grad_norm": torch.zeros((), dtype=torch.float32, device=dev)}


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          clip_norm: float | None = 1.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"m": zeros,
                "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
                **_counters(params)}

    def update(grads, state, params):
        scale, gnorm = _clip_scale(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = _f32(grads[k], scale)
            # m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) * g * g;
            # written with in-place steps on fresh tensors (the same
            # roundings) so a leaf holds few float32 temporaries at once
            m = state["m"][k] * b1
            m.add_(g * (1 - b1))
            v = state["v"][k] * b2
            gg = g * (1 - b2)
            v.add_(gg.mul_(g))
            del gg
            den = v / bc2
            den.sqrt_().add_(eps)
            u = m / bc1
            u.div_(den)
            del den
            p32 = p.float()
            if weight_decay:
                u.add_(weight_decay * p32)
            new_p[k] = (p32 - u.mul_(lr_t)).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "step": step,
                       "grad_norm": gnorm}

    return Optimizer(init, update)


def adafactor(lr, decay=0.8, eps=1e-30, clip_norm: float | None = 1.0,
              min_dim_size_to_factor: int = 128):
    """Factored second moment (Shazeer & Stern): matrices keep only row
    and column RMS statistics, O(n + m) state instead of O(n·m)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"f": {k: st(p) for k, p in params.items()},
                **_counters(params)}

    def upd(p, g, s, beta, lr_t):
        g2 = g * g + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                   min=eps))
            u = g * torch.rsqrt(denom + eps)
            ns = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(v + eps)
            ns = {"v": v}
        del g2
        # relative step clipping (RMS-1 trunc) as in the paper
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u)), min=1.0)
        return (p.float() - lr_t * u).to(p.dtype), ns

    def update(grads, state, params):
        scale, gnorm = _clip_scale(grads, clip_norm)
        step = state["step"] + 1
        beta = 1.0 - step.float() ** -decay
        lr_t = lr_fn(step)
        new_p, new_f = {}, {}
        for k, p in params.items():
            s = state["f"][k]
            if _chunked(p):
                # one leading slice at a time: the elementwise float32
                # temporaries of an (E, d, f) expert stack are a slice's
                # size, not the stack's. Factoring is over the last two
                # dims, so slicing the leading dim is exact.
                outs = [upd(p[i], _f32(grads[k][i], scale),
                            {n: t[i] for n, t in s.items()}, beta, lr_t)
                        for i in range(p.shape[0])]
                new_p[k] = torch.stack([o[0] for o in outs])
                new_f[k] = {n: torch.stack([o[1][n] for o in outs])
                            for n in s}
            else:
                new_p[k], new_f[k] = upd(p, _f32(grads[k], scale), s, beta,
                                         lr_t)
        return new_p, {"f": new_f, "step": step, "grad_norm": gnorm}

    return Optimizer(init, update)


def _chunked(p) -> bool:
    return p.ndim >= 3 and p.numel() * 4 > _CHUNK_BYTES


def sgdm(lr, momentum=0.9, clip_norm: float | None = None):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                **_counters(params)}

    def update(grads, state, params):
        scale, gnorm = _clip_scale(grads, clip_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        new_m = {k: momentum * state["m"][k] + _f32(grads[k], scale)
                 for k in params}
        new_p = {k: (p.float() - lr_t * new_m[k]).to(p.dtype)
                 for k, p in params.items()}
        return new_p, {"m": new_m, "step": step, "grad_norm": gnorm}

    return Optimizer(init, update)


BY_NAME = {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}


# ------------------------------------------------ state of the reference

def named_from_tree(tree, prefix: str = "") -> dict:
    """A reference parameter tree (nested dicts and lists of arrays) as
    ``{name: array}`` with the port's module names: keys and list
    indices joined by ``"."``; under a ``"layers"`` dict (the LM's
    stacked layers) each leaf is split along its leading dim into
    ``layers.<i>.<path>``."""
    out = {}
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    for key, value in items:
        name = f"{prefix}{key}"
        if key == "layers" and isinstance(value, dict):
            for sub, arr in named_from_tree(value).items():
                for i, layer in enumerate(np.asarray(arr)):
                    out[f"{name}.{i}.{sub}"] = layer
        elif isinstance(value, (dict, list, tuple)):
            out.update(named_from_tree(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def state_from_jax(state, device=None) -> dict:
    """The reference optimizer state ``state`` (arrays) as the port's:
    each parameter-shaped tree (``m``, ``v``) as a named tree
    (``named_from_tree``), adafactor's ``f`` as ``{name: {"vr", "vc"}
    or {"v"}}``, the counters as 0-dim tensors; on ``device`` (default
    CPU: the tests' helper)."""
    dev = torch.device("cpu" if device is None else device)
    out = {}
    for key, value in state.items():
        if key == "f":
            grouped = {}
            for name, a in named_from_tree(value).items():
                pname, stat = name.rsplit(".", 1)
                grouped.setdefault(pname, {})[stat] = tensor_from_numpy(
                    a, dev)
            out[key] = grouped
        elif isinstance(value, (dict, list, tuple)):
            out[key] = {n: tensor_from_numpy(a, dev)
                        for n, a in named_from_tree(value).items()}
        else:
            out[key] = tensor_from_numpy(value, dev)
    return out
