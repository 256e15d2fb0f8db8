"""One rank of the 4-rank gloo group of ``tests/test_torch_mesh.py``.

    python tests/_torch_mesh_ranks.py RANK WORLD STORE INPUTS OUT

Joins the group (``file://STORE``), builds a ``(2, 2)`` ``("data",
"model")`` mesh and runs the port's mesh path as one SPMD program on the
reference test's MoE LM (8 experts, top-2, 2 layers, d 32), its weights
and tokens read from ``INPUTS`` (an ``.npz`` the test wrote from the JAX
package's ``init_lm``): the parameters placed by ``lm_param_specs``;
``apply_lm`` under ``sharding_rules`` with ``impl="ep"`` at capacity
factors 4.0 and 1.25 and with ``impl="dense"``; the gradient of
``lm_loss`` through the region; ``moe_apply_ep`` on one layer at a
sequence-parallel and a decode-sized token block, with its gradients;
the yi-34b smoke LM (the port's own seeded weights) under the rules
against the unsharded model; a gemma2-9b smoke decode step against a
cache whose sequence is split over ranks (flash-decoding) against the
plain step; one AdamW train step under the rules and
its state re-meshed onto ``(1, 2)``. Saves the results (numpy arrays)
to ``OUT`` (pickle). Imports no JAX. Every collective times out after
``COLLECTIVE_TIMEOUT``, so a hang fails fast.
"""
import datetime
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LMConfig, MoEConfig  # noqa: E402
from repro_torch.distributed import make_mesh_from, remesh  # noqa: E402
from repro_torch.models.moe_ep import moe_apply_ep  # noqa: E402
from repro_torch.models.param_sharding import (  # noqa: E402
    cache_specs,
    distribute,
    lm_param_specs,
    state_specs_like,
    tree_to_mesh,
)
from repro_torch.models.sharding import constrain, sharding_rules  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    apply_lm,
    decode_step,
    init_cache,
    init_lm,
    prefill,
    lm_loss,
    params_from_jax,
)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
MESH = (2, 2)
NAMES = ("data", "model")
NEW_MESH = (1, 2)
# the reference test's (tests/test_models_extra.py) config and mapping
LM = dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
          head_dim=8, d_ff=32, vocab=128)
MOE = dict(n_experts=8, top_k=2, d_ff_expert=32)
MAPPING = {"dp": ("pod", "data"), "fsdp": ("pod", "data"), "tp": "model",
           "sp": "model", "ep_cap": ("pod", "data"), "act_seq": "model"}
CFS = (4.0, 1.25)
TOKENS = (4, 16)
LOSS_CHUNK = 16
LAYER_CF = 1.25
LAYER_SHAPES = {"scatter": (4, 16), "allreduce": (2, 1)}
DECODE_SLOTS = 64
SEED = 0


def lm_config(cls_lm, cls_moe, impl: str, cf: float):
    """The reference test's LM (``cls_lm``/``cls_moe``: either package's
    ``LMConfig``/``MoEConfig``)."""
    return cls_lm(**LM, moe=cls_moe(**MOE, capacity_factor=cf, impl=impl))


def unflatten(data, prefix: str) -> dict:
    """The ``"/"``-joined keys under ``prefix`` of an ``.npz`` as a tree."""
    tree = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        node = tree
        *path, last = key[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = data[key]
    return tree


def full(x):
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().numpy().copy()


def own(x):
    """This rank's own value of a replicated DTensor (the reference's
    device value at this mesh coordinate)."""
    x = x.to_local() if isinstance(x, DTensor) else x
    return x.detach().numpy().copy()


def grads_of(model, loss_fn):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(params.values()))
    for p in params.values():
        p.requires_grad_(False)
    return own(loss), {k: full(g) for k, g in zip(params, grads)}


def ep_lm(mesh, data, tree, toks, out):
    cfg_d = lm_config(LMConfig, MoEConfig, "dense", CFS[0])
    dense = params_from_jax(cfg_d, tree, "cpu")
    logits, aux = apply_lm(dense, cfg_d, toks)
    out["dense"] = (full(logits), own(aux))
    model = distribute(params_from_jax(cfg_d, tree, "cpu"),
                       lm_param_specs(dense), mesh, MAPPING)
    out["shards"] = {k: own(p) for k, p in model.named_parameters()}
    with sharding_rules(mesh, MAPPING):
        logits, aux = apply_lm(model, cfg_d, toks)
        out["dense_rules"] = (full(logits), own(aux))
        for cf in CFS:
            cfg = lm_config(LMConfig, MoEConfig, "ep", cf)
            logits, aux = apply_lm(model, cfg, toks)
            out[f"ep/{cf}"] = (full(logits), own(aux))
        cfg = lm_config(LMConfig, MoEConfig, "ep", CFS[0])
        out["grads"] = grads_of(model, lambda: lm_loss(
            model, cfg, toks, toks, loss_chunk=LOSS_CHUNK)[0])
    # the layer-level region, its gradients, and the dense formulation
    # on each data rank's own block of tokens (the kept pairs)
    cfg = lm_config(LMConfig, MoEConfig, "ep", LAYER_CF)
    layer = model.layers[0].moe
    for name in LAYER_SHAPES:
        x = torch.from_numpy(data[f"x/{name}"]).requires_grad_(True)
        cot = torch.from_numpy(data[f"cot/{name}"])
        for p in layer.parameters():
            p.requires_grad_(True)
        with sharding_rules(mesh, MAPPING):
            y, aux = moe_apply_ep(layer, cfg, constrain(
                x, "dp", "act_seq", None))
            loss = (y * cot).sum() + aux
            g = torch.autograd.grad(loss, [x] + list(layer.parameters()))
        names = ["x"] + [k for k, _ in layer.named_parameters()]
        out[f"layer/{name}"] = (full(y), own(aux), {
            k: full(v) for k, v in zip(names, g)})
        for p in layer.parameters():
            p.requires_grad_(False)
    return model


def dense_smoke(mesh, out):
    cfg = get_config("yi-34b", smoke=True)
    toks = torch.randint(0, cfg.vocab, (4, 32),
                         generator=torch.Generator().manual_seed(SEED))
    model = init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
    logits, _ = apply_lm(model, cfg, toks)
    loss = lm_loss(model, cfg, toks, toks, loss_chunk=LOSS_CHUNK)[0]
    out["smoke"] = (full(logits), own(loss))
    distribute(model, lm_param_specs(model), mesh, MAPPING)
    with sharding_rules(mesh, MAPPING):
        logits, _ = apply_lm(model, cfg, toks)
        loss = lm_loss(model, cfg, toks, toks, loss_chunk=LOSS_CHUNK)[0]
        out["smoke_rules"] = (full(logits), own(loss))


def decode_smoke(mesh, out):
    """The gemma2-9b smoke LM (grouped heads, windows, softcaps): one
    decode step at the last slot of a seeded cache under the rules, the
    cache's sequence split over ``model`` and its batch over ``data``
    (``decode``), then long-context, the sequence over every mesh dim and
    the batch whole (``decode_long``), against the plain step."""
    cfg = get_config("gemma2-9b", smoke=True)
    gen = torch.Generator().manual_seed(SEED)
    for name, batch, mapping in (
            ("decode", 2, MAPPING),
            ("decode_long", 1, dict(MAPPING, dp=None, sp=NAMES))):
        model = init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
        cache = init_cache(cfg, batch, DECODE_SLOTS, device="cpu")
        for key in ("k", "v"):
            cache[key].copy_(torch.randn(cache[key].shape, generator=gen))
        cache["len"] = DECODE_SLOTS - 1
        tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen)
        plain = decode_step(model, cfg, dict(
            cache, k=cache["k"].clone(), v=cache["v"].clone()), tok)[0]
        distribute(model, lm_param_specs(model), mesh, mapping)
        placed = distribute(cache, cache_specs(name == "decode_long"), mesh,
                            mapping)
        with sharding_rules(mesh, mapping):
            got = decode_step(model, cfg, placed, tok)[0]
        out[name] = (full(plain), full(got))
    # a prefill writes its prompt's K/V into the split cache
    model = init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    cache = init_cache(cfg, 2, DECODE_SLOTS, device="cpu")
    plain, plain_cache = prefill(model, cfg, prompt, dict(
        cache, k=cache["k"].clone(), v=cache["v"].clone()))
    distribute(model, lm_param_specs(model), mesh, MAPPING)
    placed = distribute(cache, cache_specs(), mesh, MAPPING)
    with sharding_rules(mesh, MAPPING):
        got, got_cache = prefill(model, cfg, prompt, placed)
    out["prefill"] = ((full(plain), full(plain_cache["k"]),
                       full(plain_cache["v"])),
                      (full(got), full(got_cache["k"]), full(got_cache["v"])))


def train_and_remesh(mesh, model, toks, out):
    """One AdamW step under the rules, then its state onto ``NEW_MESH``."""
    cfg = lm_config(LMConfig, MoEConfig, "ep", CFS[0])
    opt = adamw(1e-3)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(lambda p, b: lm_loss(
        p, cfg, b["tokens"], b["tokens"], loss_chunk=LOSS_CHUNK), opt)
    with sharding_rules(mesh, MAPPING):
        _, state, _, metrics = step(model, state, None, {"tokens": toks})
    out["train_loss"] = own(metrics["loss"])
    before = {k: full(v) for k, v in state["m"].items()}
    before.update({f"v/{k}": full(v) for k, v in state["v"].items()})
    new_mesh = make_mesh_from(list(range(dist.get_world_size())), NEW_MESH,
                              NAMES)
    specs = tree_to_mesh(state_specs_like(
        lm_param_specs(model), state), new_mesh, MAPPING)
    moved = remesh(state, specs, new_mesh)
    if new_mesh.get_coordinate() is None:
        out["remesh"] = None
        return
    after = {k: full(v) for k, v in moved["m"].items()}
    after.update({f"v/{k}": full(v) for k, v in moved["v"].items()})
    out["remesh"] = (before, after, {
        k: (tuple(v.placements), v.to_local().shape)
        for k, v in moved["m"].items()}, int(full(moved["step"])))


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=NAMES)
    data = np.load(inputs)
    tree = unflatten(data, "params/")
    toks = torch.from_numpy(data["tokens"])
    res = {"coord": tuple(mesh.get_coordinate())}
    model = ep_lm(mesh, data, tree, toks, res)
    dense_smoke(mesh, res)
    decode_smoke(mesh, res)
    train_and_remesh(mesh, model, toks, res)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
