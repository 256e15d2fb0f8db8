"""The port's sharding specs against the JAX package's, leaf by leaf, on
the CPU without a process group of real ranks.

``lm_param_specs`` for the five LM architectures at full size (the port's
model built on the meta device, the reference's tree by
``jax.eval_shape``; each of the port's per-layer specs is the
reference's stacked rule without its leading layer dim);
``dlrm_param_specs``, ``gnn_param_specs``, ``cache_specs`` (both
modes), ``state_specs_like`` for AdamW and Adafactor; ``to_mesh_spec``
and ``_translate`` on meshes with and without ``pod`` (``DeviceMesh``es
over a fake 8-rank process group, which runs no collective);
``constrain_spec``'s divisibility trim and ``fit`` against the
reference's ``cells._fit``; ``constrain`` returning its argument
itself outside a context; the reference's ``plan_remesh`` cases.
Tolerance: none (specs are equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.testing._internal.distributed.fake_pg import FakeStore

from _torch_fixtures import fresh_caches_one_thread
from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.configs.registry import ARCH_IDS, family_of
from repro.launch.cells import _fit as jax_fit
from repro.models import dlrm as jax_dlrm
from repro.models import gnn as jax_gnn
from repro.models import param_sharding as jps
from repro.models import sharding as jsh
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.distributed import plan_remesh
from repro_torch.models import param_sharding as ps
from repro_torch.models import sharding as sh
from repro_torch.models.dlrm import DLRM
from repro_torch.models.gnn import init_gnn
from repro_torch.models.transformer import LM

LM_ARCHS = [a for a in ARCH_IDS if family_of(a) == "lm"]
MESHES = {"data-model": ((4, 2), ("data", "model")),
          "pod-data-model": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


@pytest.fixture(scope="module")
def meshes():
    """DeviceMeshes over a fake 8-rank group (no collective runs)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield {k: torch.distributed.device_mesh.init_device_mesh(
            "cpu", shape, mesh_dim_names=names)
            for k, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _jax_named(tree):
    """{port name: spec} of a reference spec tree (keys and list indices
    joined by '.')."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in kp): spec for kp, spec in leaves}


def _per_layer(named_ref, n_layers):
    """The reference's stacked ``layers.<path>`` specs as the port's
    ``layers.<i>.<path>``, the leading layer dim stripped."""
    out = {}
    for name, spec in named_ref.items():
        if name.startswith("layers."):
            for i in range(n_layers):
                out[f"layers.{i}.{name[7:]}"] = tuple(spec)[1:]
        else:
            out[name] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_match_reference_per_layer(arch):
    cfg = get_config(arch)
    model = LM(cfg, None, "meta")
    ours = ps.lm_param_specs(model)
    shapes = jax.eval_shape(lambda k: jax_init_lm(jax_get_config(arch), k),
                            jax.random.key(0))
    theirs = _per_layer(_jax_named(jps.lm_param_specs(shapes)),
                        cfg.n_layers)
    assert ours.keys() == theirs.keys()
    for name, spec in ours.items():
        assert isinstance(spec, sh.PartitionSpec)
        assert tuple(spec) == theirs[name], name
        if name.startswith("layers."):
            path = name.split(".", 2)[2]
            assert tuple(ps.lm_layer_slice_rule(path)) == tuple(
                jps.lm_layer_slice_rule(path.replace(".", "/"))), path


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "gin-tu", "gatedgcn",
                                  "gat-cora", "schnet"])
def test_dlrm_and_gnn_specs_match_reference(arch):
    family = family_of(arch)
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    if family == "recsys":
        ours = ps.dlrm_param_specs(DLRM(cfg, None, "meta"))
        theirs = jps.dlrm_param_specs(jax.eval_shape(
            lambda k: jax_dlrm.init_dlrm(jcfg, k), jax.random.key(0)))
    else:
        ours = ps.gnn_param_specs(init_gnn(cfg, None, "meta"))
        theirs = jps.gnn_param_specs(jax.eval_shape(
            lambda k: jax_gnn.init_gnn(jcfg, k), jax.random.key(0)))
    theirs = _jax_named(theirs)
    assert ours.keys() == theirs.keys()
    for name, spec in ours.items():
        assert tuple(spec) == tuple(theirs[name]), name
    assert any(tuple(s) == ("fsdp", "tp") for s in ours.values()) == (
        family == "recsys")


@pytest.mark.parametrize("long_context", [False, True])
def test_cache_specs_match_reference(long_context):
    ours, theirs = ps.cache_specs(long_context), jps.cache_specs(long_context)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k]) == tuple(theirs[k]), k


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_specs_like_match_reference(name):
    arch = "moonshot-v1-16b-a3b"
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, None, "meta")
    state = getattr(optim, name)(1e-3).init(dict(model.named_parameters()))
    ours = ps.state_specs_like(ps.lm_param_specs(model), state)
    shapes = jax.eval_shape(lambda k: jax_init_lm(
        jax_get_config(arch, smoke=True), k), jax.random.key(0))
    jstate = jax.eval_shape(getattr(jax_optim, name)(1e-3).init, shapes)
    theirs = jps.state_specs_like(jps.lm_param_specs(shapes), jstate)
    assert ours.keys() == theirs.keys()
    for key in ours:
        if isinstance(theirs[key], JP):
            assert tuple(ours[key]) == tuple(theirs[key]) == (), key
            continue
        mine = {f"{n}.{k}" if isinstance(v, dict) else n: s
                for n, v in ours[key].items()
                for k, s in (v.items() if isinstance(v, dict) else [(n, v)])}
        want = _per_layer(_jax_named(theirs[key]), cfg.n_layers)
        assert mine.keys() == want.keys(), key
        for n, spec in mine.items():
            assert tuple(spec) == want[n], (key, n)
    if name == "adafactor":
        assert all(tuple(s) == () for v in ours["f"].values()
                   for s in v.values())


SPECS = [(), (None,), ("dp", None, "tp"), (("dp", "tp"), None),
         ("fsdp", ("tp", "sp")), (None, "ep_cap", "act_seq"),
         ("nodes", "data"), (("pod", "model"),)]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_to_mesh_spec_and_translate_match_reference(meshes, mesh_name):
    mesh = meshes[mesh_name]
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    for mapping in (None, {"act_seq": "model", "nodes": ("pod", "data")}):
        for spec in SPECS:
            ours = ps.to_mesh_spec(sh.P(*spec), mesh, mapping)
            theirs = jps.to_mesh_spec(JP(*spec), jmesh, mapping)
            assert tuple(ours) == tuple(theirs), (spec, mapping)
        full = dict(jsh.DEFAULT_MAPPING, **(mapping or {}))
        assert sh.DEFAULT_MAPPING == jsh.DEFAULT_MAPPING
        rules = sh.ShardingRules(mesh, full)
        jrules = jsh.ShardingRules(jmesh, full)
        for name in (None, "dp", "fsdp", "tp", "sp", "ep_cap", "act_seq",
                     "nodes", "nope"):
            assert sh._translate(rules, name) == jsh._translate(jrules, name)
    placed = ps.tree_to_placements({"w": sh.P(("pod", "data"), "tp")}, mesh)
    want = {"data-model": ["S(0)", "S(1)"],
            "pod-data-model": ["S(0)", "S(0)", "S(1)"]}[mesh_name]
    assert [str(p) for p in placed["w"]] == want


@pytest.mark.parametrize("mesh_name", MESHES)
def test_divisibility_trim_matches_reference_fit(meshes, mesh_name):
    """``fit`` against the reference's ``cells._fit``; ``trim`` (the
    trim of ``constrain_spec``) on the same entries."""
    mesh = meshes[mesh_name]
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    cases = [((8, 3), (("data", "model"), None)),
             ((2, 6), ("data", "model")),
             ((1, 16), (names[:-1], "model")),
             ((6, 4, 5), (names[:-1], None, "model")),
             ((6, 4), (tuple(names), None)),
             ((4,), ((names[0], "model"),)),
             ((12, 2, 7), ("model", None))]
    for dims, spec in cases:
        ours = ps.fit(dims, sh.P(*spec), mesh)
        sds = jax.ShapeDtypeStruct(dims, jnp.float32)
        theirs = jax_fit({"a": sds}, {"a": NamedSharding(jmesh, JP(*spec))})
        assert tuple(ours) == tuple(theirs["a"].spec), (dims, spec)
        for i, (dim, entry) in enumerate(zip(dims, spec)):
            axes = [] if entry is None else list(
                entry if isinstance(entry, tuple) else (entry,))
            assert sh.trim(dim, axes, mesh) == ours[i], (dims, spec, i)


def test_constrain_outside_a_context_returns_its_argument():
    x = torch.arange(12.0).reshape(3, 4)
    assert sh.current_mesh() is None
    assert sh.constrain(x, "dp", "tp") is x
    assert sh.constrain_spec(x, sh.P(("dp", "tp"), None)) is x
    assert sh.full(x) is x


def test_plan_remesh_matches_reference_cases():
    assert plan_remesh(512, 16) == (32, 16)
    assert plan_remesh(480, 16) == (30, 16)   # lost a node: shrink data dim
    with pytest.raises(ValueError):
        plan_remesh(8, 16)


def test_placements_follow_mesh_order(meshes):
    mesh = meshes["pod-data-model"]
    assert [str(p) for p in sh.placements(mesh, ("model", ("pod", "data")))
            ] == ["S(1)", "S(1)", "S(0)"]
    with pytest.raises(ValueError, match="order"):
        sh.placements(mesh, (("data", "pod"),))
    x = np.zeros((4, 6))
    assert tuple(ps.fit(x.shape, sh.P("data", "model"), mesh)) == (
        "data", "model")
