"""The JAX package's mesh path on 4 forced CPU devices, for
``tests/test_torch_mesh.py``: the same ``(2, 2)`` ``("data", "model")``
mesh, mapping, weights and inputs as ``tests/_torch_mesh_ranks.py``.

    python tests/_jax_mesh_p4.py INPUTS OUT

Saves to ``OUT`` (pickle): ``apply_lm`` under ``sharding_rules`` with
``impl="ep"`` at each capacity factor (logits, and ``aux`` per mesh
coordinate); the value and gradient of ``lm_loss`` through the region;
``moe_apply_ep`` on one layer at each token block with its gradients;
and the parameter shard that ``device_put`` places on each device under
``lm_param_specs`` (trimmed by ``cells._fit``), by mesh coordinate. The
device count must be forced before JAX initialises, hence a process of
its own.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compat import make_mesh  # noqa: E402
from repro.configs.base import LMConfig, MoEConfig  # noqa: E402
from repro.launch.cells import _fit  # noqa: E402
from repro.models.moe_ep import moe_apply_ep  # noqa: E402
from repro.models.param_sharding import (  # noqa: E402
    lm_param_specs,
    tree_to_shardings,
)
from repro.models.sharding import sharding_rules  # noqa: E402
from repro.models.transformer import apply_lm, lm_loss  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_ranks as ranks  # noqa: E402


def by_coord(mesh, arr):
    """{mesh coordinate: the device's buffer} of a global array."""
    return {tuple(int(i) for i in np.argwhere(mesh.devices == s.device)[0]):
            np.asarray(s.data) for s in arr.addressable_shards}


def main(inputs: str, out: str) -> None:
    mesh = make_mesh(ranks.MESH, ranks.NAMES)
    data = np.load(inputs)
    params = jax.tree.map(jnp.asarray, ranks.unflatten(data, "params/"))
    toks = jnp.asarray(data["tokens"])
    res = {}
    with sharding_rules(mesh, ranks.MAPPING):
        for cf in ranks.CFS:
            cfg = ranks.lm_config(LMConfig, MoEConfig, "ep", cf)
            logits, aux = jax.jit(lambda p, t: apply_lm(p, cfg, t))(
                params, toks)
            res[f"ep/{cf}"] = (np.asarray(logits), by_coord(mesh, aux))
        cfg = ranks.lm_config(LMConfig, MoEConfig, "ep", ranks.CFS[0])
        loss, grads = jax.jit(jax.value_and_grad(lambda p: lm_loss(
            p, cfg, toks, toks, loss_chunk=ranks.LOSS_CHUNK)[0]))(params)
        res["grads"] = (by_coord(mesh, loss), jax.tree.map(np.asarray, grads))
        cfg = ranks.lm_config(LMConfig, MoEConfig, "ep", ranks.LAYER_CF)
        layer = jax.tree.map(lambda x: x[0], params["layers"]["moe"])
        for name in ranks.LAYER_SHAPES:
            cot = jnp.asarray(data[f"cot/{name}"])

            def f(x, p):
                y, aux = moe_apply_ep(p, cfg, x)
                return (y * cot).sum() + aux, (y, aux)

            (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(
                    jnp.asarray(data[f"x/{name}"]), layer)
            res[f"layer/{name}"] = (np.asarray(y), by_coord(mesh, aux),
                                    dict(x=np.asarray(g[0]), **jax.tree.map(
                                        np.asarray, g[1])))
    shardings = _fit(params, tree_to_shardings(
        lm_param_specs(params), mesh, ranks.MAPPING))
    placed = jax.device_put(params, shardings)
    res["shards"] = jax.tree.map(lambda a: by_coord(mesh, a), placed)
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
