"""The port's configs registry (``repro_torch.configs``) and mesh helpers
(``repro_torch.launch.mesh``) against the JAX package's.

Every architecture id's config, full and smoke, must equal the
reference's field by field (nested ``MoEConfig`` too), dtypes compared
by name (``adtype``/``pdtype`` are ``torch.dtype``s in the port,
``jnp.dtype``s in the reference), and so must every derived property
and the registry's shapes and cells. The mesh helpers run in the 4-rank
gloo group of ``tests/test_torch_sharded.py`` (``_torch_sharded_ranks.py``
records what they built there); the distributed engine's answers on
their meshes are held to the reference by that module's tests.
"""
import dataclasses

import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as configs
from _torch_fixtures import SpawnedGroup
from repro.configs import gnn_archs as jgnn_archs
from repro.configs import sssp_archs as jsssp_archs
from repro_torch.configs import gnn_archs, sssp_archs
from repro_torch.launch.mesh import (
    make_host_mesh,
    make_production_mesh,
    mesh_name,
)
from test_torch_sharded import RANK_LIMIT_S, WORLD, _start, group_results


def _same_config(ours, ref, tag):
    assert type(ours).__name__ == type(ref).__name__, tag
    assert dataclasses.is_dataclass(ours), tag
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            _same_config(a, b, f"{tag}.{f.name}")
        else:
            assert type(a) is type(b) and a == b, (tag, f.name, a, b)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)], tag
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours, dataclasses.fields(ours)[0].name, None)


def _dtype_name(d):
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_reference(arch, smoke):
    ours = configs.get_config(arch, smoke=smoke)
    ref = jconfigs.get_config(arch, smoke=smoke)
    _same_config(ours, ref, f"{arch} smoke={smoke}")
    assert hash(ours) == hash(dataclasses.replace(ours))
    assert configs.family_of(arch) == jconfigs.family_of(arch)
    if isinstance(ours, configs.LMConfig):
        for d in (ours.adtype, ours.pdtype):
            assert isinstance(d, torch.dtype)
        assert _dtype_name(ours.adtype) == str(ref.adtype)
        assert _dtype_name(ours.pdtype) == str(ref.pdtype)
        assert ours.head_dim_ == ref.head_dim_
        assert ours.n_params() == ref.n_params()
        assert ours.n_active_params() == ref.n_active_params()
        assert [ours.layer_is_local(i) for i in range(4)] == \
            [ref.layer_is_local(i) for i in range(4)]
    elif isinstance(ours, configs.GNNConfig):
        assert ours.head_hidden() == ref.head_hidden()
        for shape in jgnn_archs.SHAPE_DIMS:
            _same_config(gnn_archs.with_shape_dims(ours, shape),
                         jgnn_archs.with_shape_dims(ref, shape),
                         f"{arch} {shape}")
    elif isinstance(ours, configs.DLRMConfig):
        assert ours.n_sparse == ref.n_sparse


def test_registry_shapes_and_cells_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.__all__ == jconfigs.__all__
    for arch in configs.ARCH_IDS:
        ours, ref = configs.shapes_for(arch), jconfigs.shapes_for(arch)
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            _same_config(a, b, f"{arch} {b.name}")
            assert configs.get_shape(arch, b.name) == a
            for key, value in b.extras:
                assert a.extra(key) == b.extra(key) == value
            assert a.extra("missing", 7) == 7
        with pytest.raises(KeyError) as ours_err:
            configs.get_shape(arch, "nope")
        with pytest.raises(KeyError) as ref_err:
            jconfigs.get_shape(arch, "nope")
        assert str(ours_err.value) == str(ref_err.value)
    assert configs.assigned_cells() == jconfigs.assigned_cells()
    assert len(configs.assigned_cells()) == 40
    assert configs.all_cells() == jconfigs.all_cells()
    from repro.configs import registry as jregistry
    from repro_torch.configs import registry
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "SSSP_SHAPES"):
        assert [dataclasses.astuple(s) for s in getattr(registry, name)] == \
            [dataclasses.astuple(s) for s in getattr(jregistry, name)], name


def test_sssp_and_gnn_helpers_equal_reference():
    for name in ("SSSP_SMALLWORLD", "SSSP_RMAT", "SSSP_GAMEMAP"):
        ours, ref = getattr(sssp_archs, name), getattr(jsssp_archs, name)
        _same_config(ours, ref, name)
        _same_config(sssp_archs.smoke(ours), jsssp_archs.smoke(ref),
                     f"{name} smoke")
    assert gnn_archs.SHAPE_DIMS == jgnn_archs.SHAPE_DIMS
    with pytest.raises(KeyError):
        gnn_archs.with_shape_dims(gnn_archs.GIN_TU, "nope")
    with pytest.raises(ValueError, match="unknown dtype"):
        dataclasses.replace(configs.get_config("yi-34b"), dtype="nope").adtype


def test_meshes_need_an_initialised_group():
    for make in (lambda: make_host_mesh(1, 1), make_production_mesh):
        with pytest.raises(RuntimeError, match="initialised process group"):
            make()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    grp = SpawnedGroup(tmp_path_factory, "torch_sharded_group", _start,
                       RANK_LIMIT_S)
    try:
        yield group_results(grp)[0]
    finally:
        grp.close()


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_host_mesh_over_the_group(group, shape):
    for r in range(WORLD):
        got = group[r][f"mesh/{shape[0]}x{shape[1]}"]
        assert got["name"] == f"{shape[0]}x{shape[1]}"
        assert got["dims"] == "data,model" and got["device_type"] == "cpu"
        assert torch.equal(got["ranks"],
                           torch.arange(WORLD).reshape(shape))
    for r in range(WORLD):
        assert group[r]["mesh_error/(2, 4)"] == (
            "a 2x4 mesh needs 8 ranks; the process group has 4")
        assert group[r]["mesh_error/(3, 1)"] == (
            "a 3x1 mesh needs 3 ranks; the process group has 4")
        assert group[r]["production_error/False"] == (
            "a 16x16 mesh needs 256 ranks; the process group has 4")
        assert group[r]["production_error/True"] == (
            "a 2x16x16 mesh needs 512 ranks; the process group has 4")


def test_mesh_name_reads_the_mesh_shape():
    class _Fake:
        mesh = torch.zeros(2, 16, 16)

    assert mesh_name(_Fake()) == "2x16x16"
