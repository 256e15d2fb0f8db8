"""The JAX package's dry-run cells on 8 forced CPU devices, for
``tests/test_torch_dryrun.py``.

    python tests/_jax_dryrun_p8.py OUT

For each smoke cell of ``CELLS`` on a ``(2, 2)`` ``("data", "model")``
mesh (the first 4 devices) and a ``(2, 2, 2)`` ``("pod", "data",
"model")`` mesh: ``build_cell(..., smoke=True)``, lowered and compiled;
each argument leaf's per-device shard shape and dtype (from the
compiled input shardings; names are the tree path joined by ".",
prefixed by the argument's position), ``model_flops`` and
``cost_analysis``'s flops. Also ``estimate_model_flops`` for every
``(arch, shape)`` of ``all_cells()``, and ``cost_analysis``'s flops of
the gemma2-9b smoke ``train_4k`` cell on the ``(2, 2)`` mesh at each of
``LAYERS`` layers. Writes ``OUT`` (JSON). The device
count must be forced before JAX initialises, hence a process of its
own.
"""
import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.analysis.roofline import estimate_model_flops  # noqa: E402
from repro.compat import cost_analysis_dict  # noqa: E402
from repro.configs import all_cells, family_of, get_config  # noqa: E402
from repro.configs import get_shape  # noqa: E402
from repro.launch import cells as jax_cells  # noqa: E402
from repro.launch.cells import build_cell  # noqa: E402

CELLS = [("gemma2-9b", "train_4k"), ("gemma2-9b", "decode_32k"),
         ("gin-tu", "full_graph_sm"), ("gin-tu", "minibatch_lg"),
         ("dlrm-mlperf", "train_batch"), ("dlrm-mlperf", "retrieval_cand"),
         ("sssp-smallworld", "multi_source")]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LAYERS = (1, 4)


def _name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path)


def cell_record(arch: str, shape: str, mesh) -> dict:
    cell = build_cell(arch, shape, mesh, smoke=True)
    lowered = cell.lower()
    compiled = lowered.compile()
    # XLA prunes arguments the step never reads (the optimizer's
    # grad_norm): those keep their whole shape
    kept = sorted(lowered._lowering.compile_args["kept_var_idx"])
    shardings = dict(zip(kept, jax.tree_util.tree_leaves(
        compiled.input_shardings[0])))
    leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    assert len(shardings) == len(kept), (arch, shape)
    args = {}
    for i, (path, sds) in enumerate(leaves):
        shard = (shardings[i].shard_shape(sds.shape) if i in shardings
                 else sds.shape)
        args[_name(path)] = (list(shard), np.dtype(sds.dtype).name)
    return {"args": args, "model_flops": cell.model_flops,
            "flops": float(cost_analysis_dict(compiled).get("flops", 0.0))}


def main(out: str) -> None:
    res = {"cells": {}, "model_flops": {}}
    for mname, (shape, names) in MESHES.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
        for arch, sname in CELLS:
            res["cells"][f"{arch}/{sname}/{mname}"] = cell_record(
                arch, sname, mesh)
    for arch, sname in all_cells():
        res["model_flops"][f"{arch}/{sname}"] = estimate_model_flops(
            family_of(arch), get_config(arch), get_shape(arch, sname))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    res["layer_flops"] = {}
    for n in LAYERS:
        jax_cells.get_config = lambda a, smoke=False, n=n: dataclasses.replace(
            get_config(a, smoke=smoke), n_layers=n)
        res["layer_flops"][str(n)] = cell_record(
            "gemma2-9b", "train_4k", mesh)["flops"]
    jax_cells.get_config = get_config
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
