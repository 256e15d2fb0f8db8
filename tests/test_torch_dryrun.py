"""The port's dry-run cells (``repro_torch.launch.cells``) and driver
(``repro_torch.launch.dryrun``) against the JAX package's, on the CPU.

One JAX process forced to 8 host devices (``tests/_jax_dryrun_p8.py``)
starts once per test session (``_torch_fixtures.SpawnedGroup``) and
lowers and compiles the reference's smoke cells of ``CELLS`` on a
``(2, 2)`` and a ``(2, 2, 2)`` mesh. The port builds the same cells on
``DeviceMesh``es over a fake 8-rank process group and traces each step
once on fake tensors. For each cell and mesh:

* every argument's per-device shard shape and dtype equals the
  reference's compiled input sharding's (the port's per-layer LM leaves
  against the reference's stacked leaf, layer by layer), but for the
  reference's cache ``len`` (the port's is a host int) and the
  minibatch's ``seed_key`` (the port's sampler seed is a host int);
* ``argument_size_in_bytes`` equals the sum of those shard bytes;
* ``model_flops`` is exactly equal;
* the traced FLOPs per device lie within ``FLOP_FACTOR`` of XLA's
  ``cost_analysis`` (which counts elementwise operations too, and the
  body of a scanned layer stack once; the SSSP step has no matrix
  product, so the port counts 0); the ratio is printed;
* tracing allocates nothing: every stand-in, and every tensor the step
  returns, is a FakeTensor or a DTensor over one.

Also: XLA counts the reference's scanned layer stack once (its FLOPs at
1 and 4 layers), the trace every layer; ``estimate_model_flops``
exactly equals the reference's for every
``(arch, shape)`` of ``all_cells()``; ``build_cell`` without a device
asks for CUDA; ``python -m repro_torch.launch.dryrun`` runs a smoke cell
end to end in a process of its own and writes a report that
``repro_torch.analysis.report_md`` renders.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._pytree import tree_leaves

from _torch_fixtures import SpawnedGroup, fresh_caches_one_thread, spawn
from repro.analysis.roofline import estimate_model_flops as jax_model_flops
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro_torch.analysis.roofline import estimate_model_flops
from repro_torch.configs import all_cells, family_of, get_config, get_shape
from repro_torch.launch.cells import build_cell

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
LIMIT_S = 300
CELLS = [("gemma2-9b", "train_4k"), ("gemma2-9b", "decode_32k"),
         ("gin-tu", "full_graph_sm"), ("gin-tu", "minibatch_lg"),
         ("dlrm-mlperf", "train_batch"), ("dlrm-mlperf", "retrieval_cand"),
         ("sssp-smallworld", "multi_source")]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# reference argument leaves the port holds as host ints
HOST_INTS = {"1.len", "2.seed_key"}
FLOP_FACTOR = 8.0


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX process's results, waited for on first use (so a test
    traces the port's cell while the process runs)."""
    grp = SpawnedGroup(
        tmp_path_factory, "torch_dryrun_jax",
        lambda root: [spawn(HERE / "_jax_dryrun_p8.py", root / "jax.json")],
        LIMIT_S)
    got = {}

    def load():
        if not got:
            with open(grp.wait() / "jax.json") as f:  # the process's
                got.update(json.load(f))
        return got
    try:
        yield load
    finally:
        grp.close()


@pytest.fixture(scope="module")
def meshes():
    """DeviceMeshes over a fake 8-rank group (no collective runs)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield {k: DeviceMesh("cpu", torch.arange(int(np.prod(shape)))
                             .reshape(shape), mesh_dim_names=names)
               for k, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


def _port_args(args) -> dict:
    """{name: (local shape, dtype)} of every tensor leaf: the argument's
    position, then module parameter names and dict keys, joined by "."."""
    out = {}

    def walk(name, x):
        if isinstance(x, nn.Module):
            for n, p in x.named_parameters():
                walk(f"{name}.{n}", p)
        elif isinstance(x, DTensor):
            out[name] = (list(x.to_local().shape), _dtype(x))
        elif isinstance(x, torch.Tensor):
            out[name] = (list(x.shape), _dtype(x))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{name}.{k}", v)

    for i, a in enumerate(args):
        walk(str(i), a)
    return out


_STACKED = re.compile(r"^(\d+(?:\.[mv])?)\.layers\.(?!\d)(.*)$")


def _per_layer(ref_args: dict, n_layers: int) -> dict:
    """The reference's stacked ``layers.<path>`` leaves as the port's
    ``layers.<i>.<path>``, the (unsplit) layer dim dropped."""
    out = {}
    for name, (shape, dt) in ref_args.items():
        m = _STACKED.match(name)
        if m:
            assert shape[0] == n_layers, name
            for i in range(n_layers):
                out[f"{m.group(1)}.layers.{i}.{m.group(2)}"] = (shape[1:], dt)
        elif name not in HOST_INTS:
            out[name] = (shape, dt)
    return out


def _all_fake(tree) -> bool:
    leaves = []
    for x in tree_leaves(tree, is_leaf=lambda x: isinstance(x, nn.Module)):
        if isinstance(x, nn.Module):
            leaves.extend(x.parameters())
        elif isinstance(x, torch.Tensor):
            leaves.append(x)
    return bool(leaves) and all(
        isinstance(t.to_local() if isinstance(t, DTensor) else t, FakeTensor)
        for t in leaves)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(reference, meshes, arch, shape, mesh_name):
    cell = build_cell(arch, shape, meshes[mesh_name], smoke=True,
                      device="cpu")
    trace = cell.trace()
    ref = reference()["cells"][f"{arch}/{shape}/{mesh_name}"]
    ours = _port_args(cell.args)
    n_layers = (get_config(arch, smoke=True).n_layers
                if family_of(arch) == "lm" else 0)
    theirs = _per_layer(ref["args"], n_layers)
    assert ours == theirs
    assert cell.model_flops == ref["model_flops"]
    assert trace.argument_bytes == sum(
        int(np.prod(shape)) * np.dtype(dt).itemsize
        for shape, dt in theirs.values())
    assert _all_fake(cell.args) and _all_fake(trace.returned)
    ratio = trace.flops / ref["flops"]
    print(f"{arch} {shape} {mesh_name}: traced FLOPs/dev {trace.flops:.4g},"
          f" XLA's {ref['flops']:.4g}, ratio {ratio:.3f}")
    if family_of(arch) == "sssp":
        assert trace.flops == 0 and ref["flops"] > 0
    else:
        assert 1 / FLOP_FACTOR <= ratio <= FLOP_FACTOR, ratio


def test_reference_counts_a_scanned_layer_stack_once(reference, meshes):
    """XLA's ``cost_analysis`` counts the reference's scanned layer body
    once (a reference-side caveat): its FLOPs barely move from 1 to 4
    layers, where the port's trace grows with every layer."""
    ref = reference()["layer_flops"]
    ours = {}
    for n in (1, 4):
        cell = build_cell("gemma2-9b", "train_4k", meshes["2x2"], smoke=True,
                          device="cpu", layers=n)
        ours[n] = cell.trace().flops
    print(f"gemma2-9b smoke train_4k on (2, 2): XLA's FLOPs/dev {ref}, the "
          f"trace's {ours}")
    assert ref["4"] < 1.05 * ref["1"]
    assert ours[4] > 2 * ours[1]


@pytest.mark.parametrize("arch,shape", all_cells())
def test_model_flops_equal_reference(arch, shape):
    ours = estimate_model_flops(family_of(arch), get_config(arch),
                                get_shape(arch, shape))
    assert ours == jax_model_flops(family_of(arch), jax_get_config(arch),
                                   jax_get_shape(arch, shape))


def test_build_cell_asks_for_cuda(meshes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cell("sssp-smallworld", "multi_source", meshes["2x2"],
                   smoke=True)


def test_dryrun_cli_writes_a_report_that_renders(tmp_path):
    out = tmp_path / "dryrun_reports.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
         "--smoke", "--arch", "gemma2-9b", "--shape", "decode_32k",
         "--mesh", "single", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=LIMIT_S)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "[dryrun] gemma2-9b × decode_32k × 16x16 ..." in run.stdout
    assert "  ok: compile 0.0s, hbm/dev " in run.stdout
    (report,) = json.loads(out.read_text())
    assert report["mesh"] == "16x16" and report["n_devices"] == 256
    assert report["flops_per_dev"] > 0 and report["fits_hbm"]
    md = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.report_md", str(out)],
        capture_output=True, text=True, env=env, timeout=60)
    assert md.returncode == 0, md.stderr
    assert "| gemma2-9b | decode_32k |" in md.stdout
