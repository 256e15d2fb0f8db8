"""The port's multi-GPU path against the JAX package, on the CPU: the
vertex partitions, the sharded strategies (``sharded_edge|ell|fused``)
and the distributed engine over ``torch.distributed``, and the tuner's
sharded axis.

One 4-rank gloo group runs the port (``tests/_torch_sharded_ranks.py``,
one process per rank, one torch thread each, no JAX), once per test
session (``_torch_fixtures.SpawnedGroup``: the first worker to need it
spawns it under a file lock and the others read its results). Every rank must return the same answer,
and that answer is held to the JAX package. Answers that do not depend
on the shard count are held to the JAX package in-process (its
single-device strategies, and its sharded strategies at
``n_shards=1``); the ones that do — the per-shard overflow flag of a
capped ``sharded_ell``, the distributed engine's counters — to one JAX
process forced to 4 host devices (``tests/_jax_sharded_p4.py``), as
``tests/test_sharded.py`` forces 8. Tolerance: none (bitwise). Each
spawned process has a hard time limit, and each collective a 60 s
timeout, so a hang fails the module within a minute.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_fixtures import SpawnedGroup, fresh_caches_one_thread, spawn
from repro.api import Engine as JEngine
from repro.api import MultiSource as JMultiSource
from repro.api import SingleSource as JSingleSource
from repro.api import UpdateBatch as JUpdateBatch
from repro.compat import enable_x64
from repro.core import DeltaConfig as JDeltaConfig
from repro.core.distributed import DistDeltaConfig as JDistDeltaConfig
from repro.core.distributed import build_distributed_solver as jbuild
from repro.graphs import generators as jgen
from repro.graphs import partition_edges as jpartition_edges
from repro.graphs import partition_ell as jpartition_ell
from repro.tune import candidate_configs as jcandidate_configs
from repro.tune import graph_stats as jgraph_stats
from repro_torch.core import (
    DeltaConfig,
    ShardedEdgeBackend,
    ShardedEllBackend,
    ShardedFusedBackend,
    make_backend,
    resolve_n_shards,
)
from repro_torch.core.distributed import DistDeltaConfig
from repro_torch.graphs import coo_from_numpy, partition_edges, partition_ell
from repro_torch.tune import candidate_configs, default_strategies, graph_stats

import _torch_sharded_ranks as ranks

HERE = Path(__file__).resolve().parent
WORLD = 4
RANK_LIMIT_S = 300           # each spawned process's hard time limit


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _jgraphs():
    """The three families, from the JAX package's generators: a
    small-world and a lattice whose vertex counts are no multiple of 4
    (the last shard is padded), and an R-MAT."""
    return {"smallworld": (jgen.watts_strogatz(301, 6, 0.05, seed=0), 10),
            "rmat": (jgen.rmat(256, 2500, seed=2), 10),
            "lattice": (jgen.square_lattice(15, seed=1, weighted=True), 10)}


def _port(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _update_batch(jg):
    rng = np.random.default_rng(4)
    ids = rng.choice(jg.n_edges, size=jg.n_edges // 10, replace=False)
    w = np.clip(np.asarray(jg.w)[ids] + rng.integers(-5, 6, ids.size), 1, 20)
    return ids.astype(np.int64), w.astype(np.int32)


def _write_inputs(path: Path) -> None:
    arrays = {}
    for name, (jg, delta) in _jgraphs().items():
        arrays.update({f"{name}_src": np.asarray(jg.src),
                       f"{name}_dst": np.asarray(jg.dst),
                       f"{name}_w": np.asarray(jg.w),
                       f"{name}_n": jg.n_nodes, f"{name}_delta": delta})
    arrays["update_ids"], arrays["update_w"] = _update_batch(
        _jgraphs()["smallworld"][0])
    np.savez(path, **arrays)


def _start(root: Path):
    """The 4 ranks and the 4-device JAX process, started without
    waiting, so they run while this worker compiles its JAX
    references."""
    inputs = root / "inputs.npz"
    _write_inputs(inputs)
    return [spawn(HERE / "_torch_sharded_ranks.py", r, WORLD, root / "store",
                  inputs, root / f"rank{r}.pt") for r in range(WORLD)] + [
        spawn(HERE / "_jax_sharded_p4.py", inputs, root / "jax_p4.npz")]


def group_results(grp: SpawnedGroup):
    """Every rank's results and the 4-device JAX process's."""
    root = grp.wait()
    got = [torch.load(root / f"rank{r}.pt", weights_only=True)
           for r in range(WORLD)]
    return got, dict(np.load(root / "jax_p4.npz"))


@pytest.fixture(scope="module", autouse=True)
def _group_started(tmp_path_factory):
    grp = SpawnedGroup(tmp_path_factory, "torch_sharded_group", _start,
                       RANK_LIMIT_S)
    yield grp
    grp.close()


@pytest.fixture(scope="module")
def group(_group_started):
    return group_results(_group_started)


def _same(a, b, tag):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), tag
        for k in a:
            _same(a[k], b[k], f"{tag}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), tag
    else:
        assert a == b, (tag, a, b)


def _replicated(got, key):
    """Rank 0's result for ``key``, after checking every rank has it."""
    for r in range(1, WORLD):
        _same(got[0][key], got[r][key], f"rank {r}: {key}")
    return got[0][key]


def _jfields(res):
    t = res.telemetry
    return {"dist": np.asarray(res.dist), "pred": np.asarray(res.pred),
            "buckets": np.asarray(t.buckets),
            "inner_iters": np.asarray(t.inner_iters),
            "overflow": np.asarray(t.overflow), "fallback": bool(t.fallback),
            "warm": bool(t.warm),
            "repaired": -1 if t.repaired is None else int(t.repaired)}


def _assert_bitwise(ours, ref, tag):
    for k, v in ref.items():
        a = ours[k]
        if isinstance(v, np.ndarray):
            a = a.numpy()
            if k in ("dist", "pred"):
                assert a.dtype == v.dtype == np.int32, (tag, k)
            np.testing.assert_array_equal(a, v.astype(a.dtype),
                                          err_msg=f"{tag}: {k}")
        else:
            assert a == v, (tag, k, a, v)


_JSOLVES = {}


def _jsolve(name, query, **cfg):
    """The JAX package's answer, once per worker for each (graph, query,
    config)."""
    key = (name, repr(query), tuple(sorted(cfg.items())))
    if key not in _JSOLVES:
        _JSOLVES[key] = _jsolve_once(name, query, **cfg)
    return _JSOLVES[key]


def _jsolve_once(name, query, **cfg):
    jg, delta = _jgraphs()[name]
    cfg.setdefault("delta", delta)
    if cfg.get("pred_mode") == "packed":
        with enable_x64():
            return _jfields(JEngine(jg, JDeltaConfig(**cfg)).plan().solve(
                query))
    return _jfields(JEngine(jg, JDeltaConfig(**cfg)).plan().solve(query))


# ---------------------------------------------------------------------------
# host side: partitions, routing, candidate grid (no group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["edges", "ell"])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_partitions_bitwise_equal_reference(kind, p):
    for name, (jg, delta) in _jgraphs().items():
        g = _port(jg)
        if kind == "edges":
            ours, ref = partition_edges(g, p), jpartition_edges(jg, p)
            fields = ("src", "dst", "w", "vstart")
            meta = ("n_nodes", "n_shards", "shard_nodes", "edges_per_shard")
        else:
            ours, ref = partition_ell(g, p, delta), jpartition_ell(jg, p,
                                                                   delta)
            fields = ("light_nbr", "light_w", "heavy_nbr", "heavy_w")
            meta = ("n_nodes", "n_shards", "shard_nodes", "light_deg",
                    "heavy_deg")
        for f in fields:
            a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
            assert a.dtype == b.dtype == np.int32, (name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {f}")
        for m in meta:
            assert getattr(ours, m) == getattr(ref, m), (name, m)


def test_routing_and_shard_validation_without_a_group():
    jg, _ = _jgraphs()["smallworld"]
    g = _port(jg)
    for strategy, cls in (("sharded_edge", ShardedEdgeBackend),
                          ("sharded_ell", ShardedEllBackend),
                          ("sharded_fused", ShardedFusedBackend)):
        for n_shards in (None, 1):
            b = make_backend(g, DeltaConfig(strategy=strategy,
                                            n_shards=n_shards))
            assert type(b) is cls
            assert (b.n_shards, b.rank, b.group) == (1, 0, None)
    assert resolve_n_shards(None) == 1 and resolve_n_shards(1) == 1
    for bad in (2, 4, 10_000):
        with pytest.raises(ValueError, match="process group has 1 rank"):
            resolve_n_shards(bad)
        with pytest.raises(ValueError, match="process group has 1 rank"):
            make_backend(g, DeltaConfig(strategy="sharded_edge",
                                        n_shards=bad))
    with pytest.raises(ValueError):
        DeltaConfig(strategy="sharded_edge", n_shards=0)
    with pytest.raises(ValueError):
        DistDeltaConfig(combine="nope")
    with pytest.raises(ValueError):
        DistDeltaConfig(local_steps=0)
    assert default_strategies() == ("edge", "ell", "fused")


def test_candidate_configs_with_sharded_strategies_equal_reference():
    jg, _ = _jgraphs()["smallworld"]
    stats, jstats = graph_stats(_port(jg)), jgraph_stats(jg)
    axes = dict(strategies=("edge", "ell", "fused", "sharded_edge",
                            "sharded_ell", "sharded_fused"),
                deltas=(3, 6, 12), cap_fractions=(1.0, 0.25))
    ours = candidate_configs(stats, **axes)
    assert ours == jcandidate_configs(jstats, **axes)
    # one sharded candidate per Δ (and per policy) at full width
    assert [c for c in ours if c[1] == "sharded_ell"] == [
        (d, "sharded_ell", None, p) for p in ("delta", "rho", "radius")
        for d in ((3, 6, 12) if p == "delta" else (6,))]


def test_distributed_engine_without_a_mesh_equals_reference():
    jg, delta = _jgraphs()["rmat"]
    g = _port(jg)
    from repro_torch.core.distributed import build_distributed_solver
    import jax
    jsolve = jbuild(jpartition_edges(jg, 1), jax.make_mesh((1, 1),
                                                           ("data", "model")),
                    JDistDeltaConfig(delta=delta))
    jd, jo, ji = jsolve(np.asarray([0, 5], np.int32))
    d, o, i = build_distributed_solver(
        partition_edges(g, 1), None, DistDeltaConfig(delta=delta),
        device="cpu")([0, 5])
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert (o, i) == (int(jo), int(ji))


# ---------------------------------------------------------------------------
# the 4-rank group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred_mode", ranks.PRED_MODES)
@pytest.mark.parametrize("strategy", ranks.STRATEGIES)
@pytest.mark.parametrize("name", ranks.GRAPHS)
def test_sharded_solve_bitwise_equal_reference(group, name, strategy,
                                               pred_mode):
    got, _ = group
    ours = _replicated(got, f"solve/{name}/{strategy}/{pred_mode}")
    single = strategy.removeprefix("sharded_")
    ref = _jsolve(name, JSingleSource(0), strategy=single,
                  pred_mode=pred_mode)
    _assert_bitwise(ours, ref, f"{name} {strategy} {pred_mode} vs {single}")
    explain = _replicated(got, f"explain/{name}/{strategy}/{pred_mode}")
    assert "'n_shards': None" in explain and f"'{strategy}'" in explain
    if name == "smallworld" and pred_mode == "argmin":
        ref1 = _jsolve(name, JSingleSource(0), strategy=strategy, n_shards=1)
        _assert_bitwise(ours, ref1, f"{strategy} vs its reference at P=1")


@pytest.mark.parametrize("strategy", ranks.STRATEGIES)
def test_multisource_and_rho_bitwise_equal_reference(group, strategy):
    got, _ = group
    ref = _jsolve("smallworld", JMultiSource(list(ranks.MULTI_SOURCES)),
                  strategy="edge")
    _assert_bitwise(_replicated(got, f"multi/{strategy}"), ref,
                    f"{strategy} MultiSource")
    ref = _jsolve("smallworld", JSingleSource(0), strategy="edge",
                  policy="rho")
    _assert_bitwise(_replicated(got, f"rho/{strategy}"), ref,
                    f"{strategy} rho")


def test_update_batch_warm_resolve_bitwise_equal_reference(group):
    got, _ = group
    jg, delta = _jgraphs()["smallworld"]
    plan = JEngine(jg, JDeltaConfig(delta=delta, strategy="sharded_ell",
                                    n_shards=1)).plan()
    plan.solve(JSingleSource(0))
    ref = _jfields(plan.solve(JUpdateBatch(*_update_batch(jg))))
    assert ref["warm"] and ref["repaired"] > 0
    _assert_bitwise(_replicated(got, "update/sharded_ell"), ref,
                    "sharded_ell warm UpdateBatch")


def test_capped_sharded_ell_overflows_per_shard_as_reference(group):
    got, jax_p4 = group
    ours = _replicated(got, "capped/sharded_ell")
    assert bool(ours["overflow"])
    np.testing.assert_array_equal(ours["dist"].numpy(),
                                  jax_p4["capped/dist"])
    np.testing.assert_array_equal(ours["pred"].numpy(),
                                  jax_p4["capped/pred"])
    assert [int(ours["buckets"]), int(ours["inner_iters"]),
            int(bool(ours["overflow"]))] == jax_p4["capped/counters"].tolist()
    # with fallback the full-width twin answers, as the uncapped plan
    fb = _replicated(got, "capped_fallback/sharded_ell")
    full = _replicated(got, "capped_full/sharded_ell")
    assert fb["fallback"] and _replicated(got, "capped_fallback/taken")
    ref = _jsolve("smallworld", JSingleSource(0), strategy="edge",
                  delta=ranks.CAPPED["delta"])
    _assert_bitwise(full, ref, "full-width sharded_ell")
    _assert_bitwise(fb, dict(ref, fallback=True), "fallback sharded_ell")


@pytest.mark.parametrize("local_steps", ranks.LOCAL_STEPS)
@pytest.mark.parametrize("combine", ranks.COMBINES)
@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_distributed_engine_bitwise_equal_reference(group, shape, combine,
                                                    local_steps):
    got, jax_p4 = group
    key = f"dist/rmat/{shape}/{combine}/{local_steps}"
    ours = _replicated(got, key)
    np.testing.assert_array_equal(ours["dist"].numpy(), jax_p4[f"{key}/dist"])
    assert [ours["outer"], ours["inner"]] == \
        jax_p4[f"{key}/counters"].tolist()
    if local_steps == 1:
        # padded shards (301 vertices over 4 and 2 ranks): one shard
        # count's answer is every count's at one local step
        import jax
        jg, delta = _jgraphs()["smallworld"]
        jd, jo, ji = jbuild(jpartition_edges(jg, 1),
                            jax.make_mesh((1, 1), ("data", "model")),
                            JDistDeltaConfig(delta=delta))(
            np.asarray(ranks.DIST_SOURCES, np.int32))
        ours = _replicated(got, f"dist/smallworld/{shape}/{combine}/1")
        np.testing.assert_array_equal(ours["dist"].numpy(), np.asarray(jd))
        assert (ours["outer"], ours["inner"]) == (int(jo), int(ji))


def test_tuner_ends_with_the_same_record_on_every_rank(group):
    got, _ = group
    assert _replicated(got, "default_strategies") == ",".join(
        ("edge", "ell", "fused", "sharded_edge", "sharded_ell",
         "sharded_fused"))
    assert _replicated(got, "fingerprint").endswith(":dev=torch-cpu1-r4")
    injected = _replicated(got, "tune/injected")
    # the slowest rank's times: sharded_edge at Δ = 10 takes 6.03 s on
    # rank 1, so Δ = 5 wins, pinned to the 4 shards it was measured on
    assert (injected["delta"], injected["strategy"], injected["n_shards"]) \
        == (5, "sharded_edge", 4)
    assert injected["us_per_solve"] == pytest.approx(1.53e6)
    measured = _replicated(got, "tune/measured")
    assert measured["source"] == "measured" and measured["trials"]
    if measured["strategy"] == "sharded_edge":
        assert measured["n_shards"] == 4
    else:
        assert measured["n_shards"] is None


def test_dataclass_fields_mirror_reference():
    """The port's configs keep the reference's field names, so one
    config drives both packages."""
    names = [f.name for f in dataclasses.fields(DistDeltaConfig)]
    assert names == [f.name for f in dataclasses.fields(JDistDeltaConfig)]
