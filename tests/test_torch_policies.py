"""The port's frontier policies (ρ- and radius-stepping) against the JAX
package.

``repro_torch.api.Engine(g, cfg, device="cpu")`` and
``repro.api.Engine(g, cfg)`` (Pallas kernels in interpret mode, x64 for
packed words) answer ``SingleSource``, ``MultiSource``,
``PointToPoint`` and ``BoundedRadius`` under ``policy='rho'`` (ρ ∈ {1,
3, default}) and ``policy='radius'`` (k ∈ {1, 4}) on every strategy and
pred mode. Tolerance: none — ``dist``, ``pred``, the round and step
counters, ``overflow`` and ``telemetry.fallback`` must be bitwise
equal. The preprocessing (``compute_radii``, ``graph_weight_hash``),
the thresholds, ``RadiiStore`` and ``make_policy`` are held against the
reference the same way. All solves run on one adversarial instance, so
each JAX program compiles once per config.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import BoundedRadius as JBoundedRadius
from repro.api import Engine as JEngine
from repro.api import MultiSource as JMultiSource
from repro.api import PointToPoint as JPointToPoint
from repro.api import SingleSource as JSingleSource
from repro.compat import enable_x64
from repro.core import DeltaConfig as JDeltaConfig
from repro.core import policies as jpol
from repro.graphs import generators as jgen
from repro_torch.api import (
    BoundedRadius,
    Engine,
    MultiSource,
    PointToPoint,
    SingleSource,
)
from repro_torch.core import DeltaConfig, dijkstra
from repro_torch.core import policies as pol
from repro_torch.core.delta_stepping import POLICIES
from repro_torch.graphs import coo_from_numpy, grid_map

from test_torch_solve import adversarial_coo

STRATEGIES = ("edge", "ell", "pallas", "fused")
PRED_MODES = ("none", "argmin", "packed")
VARIANTS = {"rho1": dict(policy="rho", rho=1),
            "rho3": dict(policy="rho", rho=3),
            "rho_default": dict(policy="rho"),
            "radius1": dict(policy="radius", radius_k=1),
            "radius4": dict(policy="radius", radius_k=4)}
INF = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    # leave no compiled executables behind for the modules that follow
    jax.clear_caches()
    yield
    jax.clear_caches()


def _port_graph(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _tel(t):
    return (np.asarray(t.buckets).tolist(), np.asarray(t.inner_iters).tolist(),
            np.asarray(t.overflow).tolist(), bool(t.fallback))


def _answers(plan, queries, multi):
    """Every query's answer as host arrays and lists; ``multi`` is the
    query kinds' module (``repro.api`` or ``repro_torch.api``)."""
    s, t, sources, radius = queries
    out = {}
    r = plan.solve(multi.SingleSource(s))
    out["single"] = (np.asarray(r.dist), np.asarray(r.pred), _tel(r.telemetry))
    r = plan.solve(multi.MultiSource(sources))
    out["multi"] = (np.asarray(r.dist), np.asarray(r.pred), _tel(r.telemetry))
    r = plan.solve(multi.PointToPoint(s, t))
    out["p2p"] = (r.distance, r.path, _tel(r.telemetry))
    r = plan.solve(multi.BoundedRadius(s, radius))
    out["bounded"] = (np.asarray(r.dist), np.asarray(r.pred),
                      _tel(r.telemetry))
    return out


class _Kinds:
    def __init__(self, **kinds):
        self.__dict__.update(kinds)


PORT_KINDS = _Kinds(SingleSource=SingleSource, MultiSource=MultiSource,
                    PointToPoint=PointToPoint, BoundedRadius=BoundedRadius)
JAX_KINDS = _Kinds(SingleSource=JSingleSource, MultiSource=JMultiSource,
                   PointToPoint=JPointToPoint, BoundedRadius=JBoundedRadius)


@pytest.mark.parametrize("pred_mode", PRED_MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_policy_queries_bitwise_equal_reference(variant, strategy,
                                                pred_mode):
    jg, s = adversarial_coo(7)
    g = _port_graph(jg)
    dref, _ = dijkstra(g, s)
    t = int(np.argmax(np.where(dref < INF, dref, -1)))   # farthest reached
    queries = (s, t, [s, 0, s, jg.n_nodes - 1], int(dref[t]) // 2)
    cfg = dict(delta=7, strategy=strategy, pred_mode=pred_mode,
               **VARIANTS[variant])
    ours = _answers(Engine(g, DeltaConfig(**cfg), device="cpu").plan(),
                    queries, PORT_KINDS)
    ctx = enable_x64() if pred_mode == "packed" else contextlib.nullcontext()
    with ctx:
        ref = _answers(JEngine(jg, JDeltaConfig(interpret=True, **cfg))
                       .plan(), queries, JAX_KINDS)
    for kind in ("single", "multi", "bounded"):
        for name, a, b in zip(("dist", "pred"), ours[kind], ref[kind]):
            assert a.dtype == b.dtype == np.int32, (kind, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{kind}: {name}")
        assert ours[kind][2] == ref[kind][2], kind
    assert ours["p2p"] == ref["p2p"]
    np.testing.assert_array_equal(ours["single"][0].astype(np.int64), dref)
    assert ours["p2p"][0] == int(dref[t])
    # every lane of the batch is its single solve
    plan = Engine(g, DeltaConfig(**cfg), device="cpu").plan()
    multi = plan.solve(MultiSource(queries[2]))
    for b, src in enumerate(queries[2]):
        one = plan.solve(SingleSource(src))
        assert torch.equal(multi.dist[b], one.dist)
        assert torch.equal(multi.pred[b], one.pred)
        assert (int(multi.telemetry.buckets[b]),
                int(multi.telemetry.inner_iters[b]),
                bool(multi.telemetry.overflow[b])) == (
            one.telemetry.buckets, one.telemetry.inner_iters,
            one.telemetry.overflow)


@pytest.mark.parametrize("strategy", ["edge", "pallas"])
@pytest.mark.parametrize("variant", ["rho3", "radius4"])
def test_policy_host_syncs_and_kernel_sweeps(variant, strategy, monkeypatch):
    """One transfer per round condition and per closure step plus one for
    the overflow flag; on ``pallas`` every step sweeps ``ell_relax``
    twice (light, heavy) and no bucket scan runs."""
    import repro_torch.core.backends as backends
    calls = {"ell_relax": 0, "bucket_scan": 0}
    for name in calls:
        real = getattr(backends, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(backends, name, counted)
    jg = jgen.watts_strogatz(48, 4, 0.2, seed=3)
    plan = Engine(_port_graph(jg), DeltaConfig(
        delta=7, strategy=strategy, **VARIANTS[variant]), device="cpu").plan()
    res = plan.solve(SingleSource(5))
    rounds, steps = res.telemetry.buckets, res.telemetry.inner_iters
    assert rounds > 1 and steps >= rounds
    if variant.startswith("rho"):
        assert steps == rounds
        assert plan.host_syncs == rounds + 2
    else:   # per round: its condition, then steps + 1 closure checks
        assert plan.host_syncs == 2 * rounds + steps + 2
    assert calls["bucket_scan"] == 0
    assert calls["ell_relax"] == (2 * steps if strategy == "pallas" else 0)


def test_rho_threshold_is_the_kth_pending_value():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 50, size=40).astype(np.int32)
    d[::7] = INF
    explored = np.where(rng.random(40) < 0.3, d, INF).astype(np.int32)
    for rho in (1, 3, 17, 40, 99):
        ours = pol.RhoPolicy(rho).threshold(torch.from_numpy(d),
                                            torch.from_numpy(explored))
        ref = jpol.RhoPolicy(rho=rho).threshold(jnp.asarray(d),
                                                jnp.asarray(explored))
        assert ours.dtype == torch.int32 and int(ours) == int(ref), rho


def test_radius_threshold_wraps_like_reference():
    """``d + r`` near INF wraps in the reference's int32 add, for pending
    and non-pending lanes alike; the port forms it in int64 and wraps
    explicitly, to the same minimum."""
    d = np.array([INF - 3, 5, INF, INF - 1, 2**30, 7], np.int32)
    explored = np.array([INF, INF, INF, INF, INF, 0], np.int32)
    for r in ([2, 9, 9, 4, 2**31 - 2, 1], [0, 0, 1, 0, 0, 0],
              [9, 2**31 - 1, 9, 1, 1, 5]):
        r = np.asarray(r, np.int32)
        ours = pol.RadiusPolicy(torch.from_numpy(r)).threshold(
            torch.from_numpy(d), torch.from_numpy(explored))
        ref = jpol.RadiusPolicy(r=jnp.asarray(r)).threshold(
            jnp.asarray(d), jnp.asarray(explored))
        assert ours.dtype == torch.int32 and int(ours) == int(ref), r


@pytest.mark.parametrize("graph", ["adversarial", "rmat", "lonely"])
def test_radii_and_weight_hash_equal_reference(graph):
    if graph == "adversarial":
        jg, _ = adversarial_coo(7)
    elif graph == "rmat":
        jg = jgen.rmat(40, 200, seed=2)
    else:       # a vertex without out-edges: radius 0
        from repro.graphs.structures import COOGraph as JCOOGraph
        jg = JCOOGraph(src=np.array([0, 0, 0, 1, 2], np.int32),
                       dst=np.array([1, 2, 3, 0, 0], np.int32),
                       w=np.array([9, 4, 6, 5, 8], np.int32), n_nodes=4)
    g = _port_graph(jg)
    assert pol.graph_weight_hash(g) == jpol.graph_weight_hash(jg)
    for k in (1, 2, 4, 10):
        ours = pol.compute_radii(g, k)
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, jpol.compute_radii(jg, k))
    with pytest.raises(ValueError):
        pol.compute_radii(g, 0)


def test_radii_store_round_trip_and_corrupt_miss(tmp_path):
    jg = jgen.watts_strogatz(60, 4, 0.05, seed=2)
    g = _port_graph(jg)
    store = pol.RadiiStore(str(tmp_path / "radii"))
    assert store.get(g, 4) is None               # cold miss
    r = pol.compute_radii(g, 4)
    store.put(g, 4, r)
    np.testing.assert_array_equal(store.get(g, 4), r)
    fresh = pol.RadiiStore(str(tmp_path / "radii"))
    np.testing.assert_array_equal(fresh.get(g, 4), r)
    assert fresh.get(g, 5) is None               # different k: miss
    w2 = g.w.clone()
    w2[0] += 1                                   # different weights: miss
    assert fresh.get(coo_from_numpy(g.src.numpy(), g.dst.numpy(),
                                    w2.numpy(), g.n_nodes), 4) is None
    # the reference reads the port's file: same key, same fields
    np.testing.assert_array_equal(
        jpol.RadiiStore(str(tmp_path / "radii")).get(jg, 4), r)
    for f in (tmp_path / "radii").iterdir():
        f.write_bytes(b"garbage")                # corrupt: a miss
    assert pol.RadiiStore(str(tmp_path / "radii")).get(g, 4) is None
    mem = pol.RadiiStore(None)
    mem.put(g, 4, r)
    np.testing.assert_array_equal(mem.get(g, 4), r)


def test_make_policy_defaults():
    g = _port_graph(jgen.watts_strogatz(400, 4, 0.05, seed=2))
    assert POLICIES == pol.POLICIES == jpol.POLICIES
    assert isinstance(pol.make_policy(g, DeltaConfig()), pol.DeltaPolicy)
    p = pol.make_policy(g, DeltaConfig(policy="rho"))
    assert p.rho == pol.default_rho(400) == jpol.default_rho(400) == 50
    assert pol.default_rho(100) == 32
    assert pol.make_policy(g, DeltaConfig(policy="rho", rho=7)).rho == 7
    rad = pol.make_policy(g, DeltaConfig(policy="radius", radius_k=2))
    assert rad.r.dtype == torch.int32 and rad.r.device == g.device
    np.testing.assert_array_equal(rad.r.numpy(), pol.compute_radii(g, 2))
    store = pol.RadiiStore(None)
    pol.make_policy(g, DeltaConfig(policy="radius", radius_k=3), store=store)
    np.testing.assert_array_equal(store.get(g, 3), pol.compute_radii(g, 3))
    with pytest.raises(NotImplementedError):
        pol.DeltaPolicy().threshold(None, None)


@pytest.mark.parametrize("policy", ["rho", "radius"])
def test_overflow_demotes_to_full_width_per_policy(policy):
    jg = jgen.watts_strogatz(200, 8, 0.05, seed=25)
    g = _port_graph(jg)
    cfg = dict(delta=10, strategy="ell", frontier_cap=4, rho=64,
               policy=policy)
    plan = Engine(g, DeltaConfig(**cfg), device="cpu").plan(fallback=True)
    jplan = JEngine(jg, JDeltaConfig(**cfg)).plan(fallback=True)
    res, jres = plan.solve(SingleSource(0)), jplan.solve(JSingleSource(0))
    assert plan._demoted is not None and plan._demoted.config.policy == policy
    assert res.telemetry.fallback and plan.explain()["fallback_taken"]
    assert _tel(res.telemetry) == _tel(jres.telemetry)
    np.testing.assert_array_equal(res.dist.numpy(), np.asarray(jres.dist))
    dref, _ = dijkstra(g, 0)
    np.testing.assert_array_equal(res.dist.numpy().astype(np.int64), dref)
    p2p = plan.solve(PointToPoint(0, 7))
    assert p2p.telemetry.fallback and p2p.distance == int(dref[7])


def test_non_delta_refusals_match_reference():
    """Grid plans are delta-only (ValueError at plan time), and the
    landmark modes under a policy raise the reference's ValueError
    before the port's landmark NotImplementedError."""
    g, free = grid_map(8, 8, 0.1, seed=0)
    cfg = DeltaConfig(delta=13, strategy="pallas", pred_mode="none",
                      policy="rho", rho=8)
    with pytest.raises(ValueError, match="policy"):
        Engine(g, cfg, free_mask=free, device="cpu").plan()
    jg = jgen.watts_strogatz(100, 4, 0.05, seed=1)
    plan = Engine(_port_graph(jg), DeltaConfig(policy="rho", rho=8),
                  device="cpu").plan()
    for mode in ("alt", "bidirectional", "alt_bidirectional"):
        with pytest.raises(ValueError, match="delta"):
            plan.solve(PointToPoint(0, 5, mode=mode))
    delta = Engine(_port_graph(jg), DeltaConfig(), device="cpu").plan()
    with pytest.raises(NotImplementedError, match="item 10"):
        delta.solve(PointToPoint(0, 5, mode="alt"))


@pytest.mark.parametrize("policy", ["rho", "radius"])
def test_launcher_batched_policy_on_cpu_with_verify(capsys, policy):
    from repro_torch.launch.sssp import main
    main(["--nodes", "300", "--degree", "6", "--device", "cpu",
          "--sources", "4", "--policy", policy, "--verify"])
    out = capsys.readouterr().out
    assert f"frontier policy: {policy}" in out
    assert "batched x4" in out and "verify vs Dijkstra: OK" in out
