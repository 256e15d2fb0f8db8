"""The port's batched queries against the JAX package: ``MultiSource``,
``ManyToMany`` and the overflow fallback.

``repro_torch.api.Engine(g, cfg, device="cpu")`` (the kernels' plain
twins) and ``repro.api.Engine(g, cfg)`` (Pallas kernels in interpret
mode, x64 for packed words) answer the same queries on instances made
from fixed seeds. Tolerance: none — ``dist``, ``pred``, the per-lane
``buckets`` / ``inner_iters`` / ``overflow``, a ``ManyToMany`` matrix
and ``telemetry.fallback`` must be bitwise equal. Every lane must also
equal the port's own ``SingleSource`` of its source, counters included.
Two graph shapes are used, so each JAX program compiles once per
config.
"""
import contextlib

import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
from repro.api import Engine as JEngine
from repro.api import ManyToMany as JManyToMany
from repro.api import MultiSource as JMultiSource
from repro.api import SingleSource as JSingleSource
from repro.compat import enable_x64
from repro.core import DeltaConfig as JDeltaConfig
from repro.graphs import generators as jgen
from repro.graphs.structures import COOGraph as JCOOGraph
from repro_torch.api import (
    BoundedRadius,
    Engine,
    ManyToMany,
    MultiSource,
    PointToPoint,
    SingleSource,
)
from repro_torch.core import DeltaConfig, dijkstra
from repro_torch.core.delta_stepping import (_run_lanes, _run_many_vmapped,
                                             _run_one)
from repro_torch.graphs import coo_from_numpy

from test_torch_solve import adversarial_coo

STRATEGIES = ("edge", "ell", "pallas", "fused")
PRED_MODES = ("none", "argmin", "packed")
INF = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _graph(name):
    """(JAX graph, sources): a duplicate source in each batch, and on the
    adversarial graph a lane from the disconnected tail, which ends
    after one bucket while the others still sweep."""
    if name == "adversarial":
        jg, s = adversarial_coo(7)
        return jg, [s, 0, s, jg.n_nodes - 1]
    jg = jgen.watts_strogatz(48, 4, 0.2, seed=3)
    return jg, [5, 40, 5, 0, 17]


def _port_graph(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _ctx(pred_mode):
    return enable_x64() if pred_mode == "packed" else contextlib.nullcontext()


def _jax_multi(jg, sources, **cfg):
    with _ctx(cfg.get("pred_mode", "argmin")):
        r = JEngine(jg, JDeltaConfig(interpret=True, **cfg)).plan().solve(
            JMultiSource(sources))
        t = r.telemetry
        return (np.asarray(r.dist), np.asarray(r.pred),
                np.asarray(t.buckets), np.asarray(t.inner_iters),
                np.asarray(t.overflow))


def _port_multi(plan, sources):
    r = plan.solve(MultiSource(sources))
    t = r.telemetry
    assert t.buckets.dtype == torch.int32 and t.overflow.dtype == torch.bool
    return tuple(x.numpy() for x in (r.dist, r.pred, t.buckets,
                                     t.inner_iters, t.overflow))


def _assert_same(ours, ref, tag):
    for name, a, b in zip(("dist", "pred", "buckets", "inner_iters",
                           "overflow"), ours, ref):
        assert a.dtype == b.dtype, (tag, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {name}")


def _assert_lanes_are_single_solves(plan, ours, sources, tag):
    for b, s in enumerate(sources):
        one = plan.solve(SingleSource(s))
        t = one.telemetry
        np.testing.assert_array_equal(ours[0][b], one.dist.numpy(),
                                      err_msg=f"{tag} lane {b}: dist")
        np.testing.assert_array_equal(ours[1][b], one.pred.numpy(),
                                      err_msg=f"{tag} lane {b}: pred")
        assert (int(ours[2][b]), int(ours[3][b]), bool(ours[4][b])) == (
            t.buckets, t.inner_iters, t.overflow), (tag, b)


@pytest.mark.parametrize("pred_mode", PRED_MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("graph", ["adversarial", "watts_strogatz"])
def test_multisource_bitwise_equals_reference(graph, strategy, pred_mode):
    jg, sources = _graph(graph)
    cfg = dict(delta=7, strategy=strategy, pred_mode=pred_mode)
    plan = Engine(_port_graph(jg), DeltaConfig(**cfg), device="cpu").plan()
    ours = _port_multi(plan, sources)
    tag = (graph, strategy, pred_mode)
    _assert_same(ours, _jax_multi(jg, sources, **cfg), tag)
    _assert_lanes_are_single_solves(plan, ours, sources, tag)
    for b, s in enumerate(sources):
        dref, _ = dijkstra(_port_graph(jg), s)
        np.testing.assert_array_equal(ours[0][b].astype(np.int64), dref)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_lane_batch_is_the_single_solve(strategy):
    jg, sources = _graph("watts_strogatz")
    plan = Engine(_port_graph(jg), DeltaConfig(delta=7, strategy=strategy),
                  device="cpu").plan()
    ours = _port_multi(plan, sources[:1])
    assert ours[0].shape == (1, jg.n_nodes)
    _assert_lanes_are_single_solves(plan, ours, sources[:1], strategy)


@pytest.mark.parametrize("pred_mode", PRED_MODES)
@pytest.mark.parametrize("strategy", ["edge", "pallas"])
def test_empty_batch_like_reference(strategy, pred_mode):
    """``MultiSource([])`` answers ``[0, n]`` arrays and empty counters,
    as the reference's ``vmap`` / ``lax.map`` over no sources does."""
    jg, _ = _graph("watts_strogatz")
    cfg = dict(delta=7, strategy=strategy, pred_mode=pred_mode)
    plan = Engine(_port_graph(jg), DeltaConfig(**cfg), device="cpu").plan()
    ours = _port_multi(plan, [])
    assert ours[0].shape == ours[1].shape == (0, jg.n_nodes)
    _assert_same(ours, _jax_multi(jg, [], **cfg), (strategy, "empty"))


@pytest.mark.parametrize("strategy,batched", [
    ("edge", True), ("ell", True), ("pallas", False), ("fused", False)])
def test_edge_and_ell_solve_a_batch_as_one_loop(strategy, batched):
    """``edge`` and ``ell`` bind the ``[B, n]`` loop and make fewer host
    syncs than their lanes' single solves together; the kernel
    strategies run lane by lane and make exactly as many."""
    jg, sources = _graph("watts_strogatz")
    plan = Engine(_port_graph(jg), DeltaConfig(delta=7, strategy=strategy),
                  device="cpu").plan()
    bound = plan._run_many
    if batched:
        assert bound.func is _run_many_vmapped
    else:
        assert bound.func is _run_lanes and bound.args == (_run_one,)
    plan.solve(MultiSource(sources))
    batch_syncs = plan.host_syncs
    singles = 0
    for s in sources:
        res = plan.solve(SingleSource(s))
        t = res.telemetry
        assert plan.host_syncs == 2 * t.buckets + t.inner_iters + 1
        singles += plan.host_syncs
    if batched:
        assert batch_syncs < singles
    else:
        assert batch_syncs == singles


@pytest.mark.parametrize("strategy", ["ell", "pallas", "fused"])
def test_multisource_overflow_is_per_lane(strategy):
    """A lane whose frontier exceeds the cap flags overflow without
    poisoning the other lanes (a lane from the disconnected tail never
    overflows)."""
    jg, s = adversarial_coo(7)
    sources = [s, jg.n_nodes - 1, s]
    cfg = dict(delta=31, strategy=strategy, pred_mode="argmin",
               frontier_cap=2)
    plan = Engine(_port_graph(jg), DeltaConfig(**cfg), device="cpu").plan()
    ours = _port_multi(plan, sources)
    assert ours[4].tolist() == [True, False, True]
    _assert_same(ours, _jax_multi(jg, sources, **cfg), (strategy, "capped"))
    _assert_lanes_are_single_solves(plan, ours, sources, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_many_to_many_equals_reference(strategy):
    """A short last tile (five sources, tile 2) and a target in the
    disconnected tail: the matrix and the aggregated telemetry equal the
    JAX package's."""
    jg, s = adversarial_coo(7)
    n = jg.n_nodes
    sources, targets = [s, 0, 3, s, 1], [n - 1, 0, s, 5, 9]
    q = dict(sources=sources, targets=targets, tile=2)
    plan = Engine(_port_graph(jg), DeltaConfig(delta=7, strategy=strategy),
                  device="cpu").plan()
    r = plan.solve(ManyToMany(**q))
    j = JEngine(jg, JDeltaConfig(delta=7, strategy=strategy,
                                 interpret=True)).plan().solve(
        JManyToMany(**q))
    assert r.matrix.dtype == torch.int64 and r.matrix.shape == (5, 5)
    np.testing.assert_array_equal(r.matrix.numpy(), np.asarray(j.matrix))
    assert (r.telemetry.buckets, r.telemetry.inner_iters,
            r.telemetry.overflow) == (int(j.telemetry.buckets),
                                      int(j.telemetry.inner_iters),
                                      bool(j.telemetry.overflow))
    assert r.matrix[0, 0] == INF                # disconnected target
    multi = plan.solve(MultiSource(sources))
    np.testing.assert_array_equal(r.matrix.numpy(),
                                  multi.dist[:, targets].numpy())


def test_many_to_many_default_tile_and_disconnected():
    jg, s = adversarial_coo(7)
    g = _port_graph(jg)
    plan = Engine(g, DeltaConfig(delta=7), device="cpu").plan()
    r = plan.solve(ManyToMany([s], [jg.n_nodes - 1], tile=1))
    dref, _ = dijkstra(g, s)
    assert r.matrix[0, 0] == int(dref[jg.n_nodes - 1])
    srcs = list(range(10))
    r = plan.solve(ManyToMany(srcs, [0, 1]))       # default tile: 8
    for row, src in enumerate(srcs):
        dref, _ = dijkstra(g, src)
        assert r.matrix[row].tolist() == [int(dref[0]), int(dref[1])]


@pytest.mark.parametrize("strategy", ["ell", "pallas", "fused"])
def test_fallback_reanswers_and_demotes(strategy):
    """A capped plan with fallback=True re-answers an overflowing query
    full-width, marks the telemetry and demotes for good, as the JAX
    package does; with fallback=False the flag is only reported."""
    jg = jgen.watts_strogatz(300, 6, 0.05, seed=0)
    g = _port_graph(jg)
    dref, _ = dijkstra(g, 0)
    cfg = dict(delta=100, strategy=strategy, frontier_cap=2,
               pred_mode="none")
    plan = Engine(g, DeltaConfig(**cfg), device="cpu").plan(fallback=True)
    jplan = JEngine(jg, JDeltaConfig(interpret=True, **cfg)).plan(
        fallback=True)
    assert not plan.explain()["fallback_taken"]
    res = plan.solve(SingleSource(0))
    jres = jplan.solve(JSingleSource(0))
    assert res.telemetry.fallback and jres.telemetry.fallback
    np.testing.assert_array_equal(res.dist.numpy().astype(np.int64), dref)
    np.testing.assert_array_equal(res.dist.numpy(), np.asarray(jres.dist))
    assert (res.telemetry.buckets, res.telemetry.inner_iters,
            res.telemetry.overflow) == (int(jres.telemetry.buckets),
                                        int(jres.telemetry.inner_iters),
                                        bool(jres.telemetry.overflow))
    ours, ref = plan.explain(), jplan.explain()
    assert ours["fallback_taken"] and ours["resident_source"] == 0
    assert ours == ref
    # demoted: later queries answer full-width directly
    res2 = plan.solve(MultiSource([0, 1]))
    jres2 = jplan.solve(JMultiSource([0, 1]))
    assert res2.telemetry.fallback and jres2.telemetry.fallback
    np.testing.assert_array_equal(res2.dist.numpy(), np.asarray(jres2.dist))
    np.testing.assert_array_equal(res2.dist[0].numpy().astype(np.int64), dref)
    assert not res2.telemetry.overflow.any()
    p2p = plan.solve(PointToPoint(0, 7))
    assert p2p.telemetry.fallback and p2p.distance == int(dref[7])
    # parity default: flag reported, answer left to the caller
    raw = Engine(g, DeltaConfig(**cfg), device="cpu").plan().solve(
        SingleSource(0))
    assert raw.telemetry.overflow and not raw.telemetry.fallback


def test_fallback_needs_a_cap():
    """Without a frontier cap nothing can overflow: fallback stays
    unarmed, as in the reference."""
    jg = jgen.watts_strogatz(60, 4, 0.1, seed=0)
    plan = Engine(_port_graph(jg), DeltaConfig(delta=5, strategy="ell"),
                  device="cpu").plan(fallback=True, sources=[0, 1])
    assert not plan._fallback
    res = plan.solve(MultiSource([0, 1]))
    assert not res.telemetry.fallback
    assert not plan.explain()["fallback_taken"]


def test_explain_reports_the_operating_point():
    jg = jgen.watts_strogatz(60, 4, 0.1, seed=0)
    cfg = dict(delta=5, strategy="fused", pred_mode="packed",
               frontier_cap=9, policy="rho", rho=4)
    ours = Engine(_port_graph(jg), DeltaConfig(**cfg),
                  device="cpu").plan().explain()
    with enable_x64():
        ref = JEngine(jg, JDeltaConfig(interpret=True, **cfg)).plan(
        ).explain()
    assert ours == ref


def _line(n):
    src = np.arange(n - 1, dtype=np.int32)
    return coo_from_numpy(src, src + 1, np.full(n - 1, 3, np.int32), n)


BAD_QUERIES = {
    "sources_2d": MultiSource(np.zeros((2, 2), np.int32)),
    "sources_high": MultiSource([0, 16]),
    "sources_negative": MultiSource([-1, 2]),
    "m2m_source_high": ManyToMany([16], [0]),
    "m2m_target_high": ManyToMany([0], [16]),
    "m2m_no_sources": ManyToMany([], [1]),
    "m2m_no_targets": ManyToMany([0], []),
    "m2m_tile_0": ManyToMany([0], [1], tile=0),
    "bounded_negative": BoundedRadius(0, -1),
}


@pytest.mark.parametrize("name", sorted(BAD_QUERIES))
def test_bad_queries_raise_value_error_like_reference(name):
    from repro.api import BoundedRadius as JBoundedRadius
    q = BAD_QUERIES[name]
    jq = {MultiSource: JMultiSource, ManyToMany: JManyToMany,
          BoundedRadius: JBoundedRadius}[type(q)](**vars(q))
    g = _line(16)
    jg = JCOOGraph(src=np.asarray(g.src), dst=np.asarray(g.dst),
                       w=np.asarray(g.w), n_nodes=16)
    with pytest.raises(ValueError) as ours:
        Engine(g, DeltaConfig(delta=10), device="cpu").plan().solve(q)
    with pytest.raises(ValueError) as ref:
        JEngine(jg, JDeltaConfig(delta=10)).plan().solve(jq)
    assert str(ours.value) == str(ref.value)
