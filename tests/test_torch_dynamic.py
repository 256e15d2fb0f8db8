"""The port's dynamic-graph path against the JAX package: ``Plan.update``,
warm ``resolve`` and ``UpdateBatch``, ``plan_repair`` and
``apply_weight_update``.

``repro_torch.api.Engine(g, cfg, device="cpu")`` (the kernels' plain
twins) and ``repro.api.Engine(g, cfg)`` (Pallas kernels in interpret
mode, x64 for packed words) take the same update batches, drawn by
``_perturb`` from fixed seeds (each printed), on the same graphs.
Tolerance: none — ``dist``, ``pred``, the bucket and inner-iteration
counters, ``overflow``, ``warm``, ``repaired``, ``cone`` and
``fallback`` of every re-solve, and ``plan_repair``'s ``tent0``,
``explored0``, ``cone``, ``repaired`` and refusal reason before it, must
be bitwise equal. Each warm answer must also equal the port's cold solve
of the updated graph and the Dijkstra oracle. Every JAX plan is built
once and takes all its batches, so each of its programs compiles once.
"""
import contextlib

import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
from repro.api import Engine as JEngine
from repro.api import SingleSource as JSingleSource
from repro.api import UpdateBatch as JUpdateBatch
from repro.compat import enable_x64
from repro.core import DeltaConfig as JDeltaConfig
from repro.dynamic import apply_weight_update as japply
from repro.dynamic import plan_repair as jplan_repair
from repro.dynamic import resident_words as jresident_words
from repro.dynamic.repair import Resident as JResident
from repro.graphs import generators as jgen
from repro.graphs.structures import COOGraph as JCOOGraph
from repro_torch.api import Engine, SingleSource, UpdateBatch
from repro_torch.core import DeltaConfig, dijkstra
from repro_torch.dynamic import (Resident, apply_weight_update, plan_repair,
                                 resident_words)
from repro_torch.graphs import coo_from_numpy

STRATEGIES = ("edge", "ell", "pallas", "fused")
PRED_MODES = ("none", "argmin", "packed")
INF = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _port_graph(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _x64(pred_mode):
    return enable_x64() if pred_mode == "packed" else contextlib.nullcontext()


def _perturb(rng, w, k, lo=1, hi=60):
    """k random edge ids + mixed-sign in-range replacement weights (the
    reference suite's ``_perturb``)."""
    ids = rng.choice(w.shape[0], size=min(k, w.shape[0]), replace=False)
    neww = np.clip(w[ids] + rng.integers(-8, 9, size=ids.shape[0]), lo, hi)
    return ids, neww


def _snap(res):
    """A re-solve's answer and telemetry on the host."""
    t = res.telemetry
    return (np.asarray(res.dist).tolist(), np.asarray(res.pred).tolist(),
            int(t.buckets), int(t.inner_iters), bool(t.overflow),
            bool(t.fallback), bool(t.warm), t.repaired, t.cone)


def _repair_snap(rep, reason):
    if rep is None:
        return None, reason
    arrays = [None if a is None else (a.dtype.str, a.tolist())
              for a in (rep.tent0, rep.explored0)]
    return (arrays, rep.cone, rep.repaired), reason


def _check_cold(results, cfg):
    """Each of the port's re-solves equals its cold solve of the graph
    it was answered on, and the Dijkstra oracle."""
    for res, graph in results:
        cold = Engine(graph, DeltaConfig(**cfg), device="cpu").plan().solve(
            SingleSource(0))
        assert torch.equal(res.dist, cold.dist)
        assert torch.equal(res.pred, cold.pred)
        dref, _ = dijkstra(graph, 0)
        np.testing.assert_array_equal(res.dist.numpy().astype(np.int64),
                                      dref)


def _run_batches(cfg, batches, jg, via_query=()):
    """Both packages solve ``SingleSource(0)`` on ``jg``, then take each
    batch: ``plan.update`` + ``plan_repair`` + ``resolve(warm=True)``, or
    ``solve(UpdateBatch)`` for the batch numbers in ``via_query``.
    Returns the port plan, its (result, graph) per batch and both
    packages' snapshots."""
    g = _port_graph(jg)
    plan = Engine(g, DeltaConfig(**cfg), device="cpu").plan()
    ours, ref = [], []
    plan.solve(SingleSource(0))
    results = []
    for b, (ids, w) in enumerate(batches):
        if b in via_query:
            res = plan.solve(UpdateBatch(ids, w))
        else:
            plan.update(ids, w)
            ours.append(_repair_snap(*plan_repair(
                plan.graph, plan._resident, pred_mode=cfg["pred_mode"])))
            res = plan.resolve(warm=True)
        ours.append(_snap(res))
        results.append((res, plan.graph))
    with _x64(cfg["pred_mode"]):
        jplan = JEngine(jg, JDeltaConfig(interpret=True, **cfg)).plan()
        jplan.solve(JSingleSource(0))
        for b, (ids, w) in enumerate(batches):
            if b in via_query:
                jres = jplan.solve(JUpdateBatch(ids, w))
            else:
                jplan.update(ids, w)
                ref.append(_repair_snap(*jplan_repair(
                    jplan.graph, jplan._resident,
                    pred_mode=cfg["pred_mode"])))
                jres = jplan.resolve(warm=True)
            ref.append(_snap(jres))
    return plan, results, ours, ref


def _draw(jg, seed, k, count):
    """``count`` stacked batches of ``k`` edges from ``seed`` (printed),
    each drawn against the weights the previous ones left."""
    print(f"update batches from seed {seed}")
    rng = np.random.default_rng(seed)
    w = np.asarray(jg.w).copy()
    batches = []
    for _ in range(count):
        ids, neww = _perturb(rng, w, k)
        w[ids] = neww
        batches.append((ids, neww))
    return batches


@pytest.fixture(scope="module")
def small_world():
    return jgen.watts_strogatz(240, 6, 0.05, seed=3)


@pytest.mark.parametrize("pred_mode", PRED_MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_warm_resolve_bitwise_equal_reference(small_world, strategy,
                                              pred_mode):
    """Three stacked mixed-sign batches per strategy x pred mode: the
    repair plan and each re-solve equal the JAX package's ('none' falls
    back cold on the increases, with the reference's reason), and each
    warm answer equals the port's cold solve and the oracle."""
    cfg = dict(delta=10, strategy=strategy, pred_mode=pred_mode)
    batches = _draw(small_world, 17, 12, 3)
    plan, results, ours, ref = _run_batches(cfg, batches, small_world,
                                            via_query=(1,))
    assert ours == ref
    assert all(res.telemetry.warm == (pred_mode != "none")
               for res, _ in results)
    _check_cold(results, cfg)
    assert plan.explain()["resident_source"] == 0


@pytest.mark.parametrize("strategy", ["edge", "pallas"])
@pytest.mark.parametrize("policy", ["rho", "radius"])
def test_warm_resolve_per_policy_bitwise_equal_reference(small_world,
                                                         policy, strategy):
    """The frontier-policy loop entered warm: two stacked batches, every
    re-solve (and, for radius, the radii recomputed at update time)
    equal to the JAX package's and to the port's cold solve."""
    cfg = dict(delta=10, strategy=strategy, pred_mode="argmin",
               policy=policy, rho=24)
    batches = _draw(small_world, 19, 12, 2)
    plan, results, ours, ref = _run_batches(cfg, batches, small_world,
                                            via_query=(0, 1))
    assert ours == ref
    assert all(res.telemetry.warm for res, _ in results)
    _check_cold(results, cfg)


# ------------------------------------------------------------- scenarios
# each scenario drives one plan of either package through the same calls
# and returns what it saw; ``pkg`` carries the package's kinds

class _Pkg:
    def __init__(self, port):
        self.port = port
        if port:
            self.Engine = lambda g, cfg, **kw: Engine(g, cfg, device="cpu",
                                                      **kw)
            self.Config, self.Single, self.Update = (DeltaConfig,
                                                     SingleSource,
                                                     UpdateBatch)
        else:
            self.Engine = JEngine
            self.Config = lambda **cfg: JDeltaConfig(interpret=True, **cfg)
            self.Single, self.Update = JSingleSource, JUpdateBatch

    def graph(self, src, dst, w, n):
        if self.port:
            return coo_from_numpy(src, dst, w, n)
        return JCOOGraph(*(np.asarray(a, np.int32) for a in (src, dst, w)), n)


def _lattice_x10():
    jl = jgen.square_lattice(20, weighted=True)
    return (np.asarray(jl.src), np.asarray(jl.dst),
            np.asarray(jl.w) * 10, jl.n_nodes)


def _cascade(pkg):
    """One near-source shortcut rewrites most distances in a couple of
    Δ = 1000 buckets: the repair twin (cap 64) overflows and the same
    warm state re-runs full-width; the cap floor escalates x4."""
    plan = pkg.Engine(pkg.graph(*_lattice_x10()),
                      pkg.Config(delta=1000, pred_mode="argmin")).plan()
    plan.solve(pkg.Single(0))
    runs = []
    orig = plan._run_warm
    plan._run_warm = lambda be, t, e: runs.append(
        be is plan.backend) or orig(be, t, e)
    res = plan.solve(pkg.Update([0], [1]))
    return [_snap(res), runs, plan._twin_cap_floor]


def _tie(pkg):
    """A decrease landing exactly on dist[3] makes vertex 1 a smaller-id
    tight parent without moving a distance: the no-op short cut must
    hand back the argmin tree of the updated graph, and the refreshed
    residency carries it on."""
    g = pkg.graph([0, 0, 2, 1], [1, 2, 3, 3], [1, 1, 5, 6], 4)
    plan = pkg.Engine(g, pkg.Config(delta=3, pred_mode="argmin")).plan()
    base = plan.solve(pkg.Single(0))
    warm = plan.solve(pkg.Update([3], [5]))
    return [_snap(base), _snap(warm), _snap(plan.resolve(warm=True))]


def _demotion(pkg):
    """An overflow on a fallback plan demotes it; residency rides along,
    and update/resolve keep working through the full-width twin."""
    jg = jgen.watts_strogatz(200, 8, 0.05, seed=25)
    g = pkg.graph(*(np.asarray(a) for a in (jg.src, jg.dst, jg.w)),
                  jg.n_nodes)
    plan = pkg.Engine(g, pkg.Config(delta=10, pred_mode="argmin",
                                    strategy="ell", frontier_cap=4)).plan(
        fallback=True)
    first = plan.solve(pkg.Single(0))
    w0 = int(np.asarray(jg.w)[0])
    warm = plan.solve(pkg.Update([0], [w0 + 3]))
    again = plan.solve(pkg.Update([5, 0], [1, w0]))
    return [_snap(first), _snap(warm), _snap(again),
            plan.explain()["fallback_taken"],
            plan.explain()["resident_source"]]


def _small(seed, pred_mode="argmin"):
    """A plan of ``pkg`` on ``watts_strogatz(200, 6, 0.05, seed)`` and
    the graph's weights."""
    def make(pkg):
        jg = jgen.watts_strogatz(200, 6, 0.05, seed=seed)
        w = np.asarray(jg.w)
        g = pkg.graph(np.asarray(jg.src), np.asarray(jg.dst), w, jg.n_nodes)
        return pkg.Engine(g, pkg.Config(delta=10,
                                        pred_mode=pred_mode)).plan(), w
    return make


def _overflowed_resident(pkg):
    """A capped plan without fallback keeps an overflowed answer
    resident; the repair refuses it and the re-solve runs cold."""
    jg = jgen.watts_strogatz(200, 8, 0.05, seed=25)
    g = pkg.graph(*(np.asarray(a) for a in (jg.src, jg.dst, jg.w)),
                  jg.n_nodes)
    plan = pkg.Engine(g, pkg.Config(delta=10, pred_mode="argmin",
                                    strategy="ell", frontier_cap=4)).plan()
    first = plan.solve(pkg.Single(0))
    return [_snap(first), _snap(plan.solve(pkg.Update([0], [1])))]


def _increase_without_tree(pkg):
    plan, w = _small(7, "none")(pkg)
    plan.solve(pkg.Single(0))
    return [_snap(plan.solve(pkg.Update([3], [int(w[3]) + 10])))]


def _zero_weight_packed(pkg):
    g = pkg.graph([0, 0, 1, 2], [1, 2, 3, 3], [0, 5, 7, 2], 4)
    with _x64("packed"):
        plan = pkg.Engine(g, pkg.Config(delta=3, pred_mode="packed")).plan()
        plan.solve(pkg.Single(0))
        return [_snap(plan.solve(pkg.Update([1], [4])))]


def _noop(pkg):
    """Identical weights re-submitted: zero buckets, the answer stands."""
    plan, w = _small(11)(pkg)
    base = plan.solve(pkg.Single(0))
    return [_snap(base), _snap(plan.solve(pkg.Update([0, 5, 9],
                                                     w[[0, 5, 9]])))]


def _compose(pkg):
    """Three update() calls between resolves diff against one resident
    snapshot; the warm answer is the final graph's."""
    plan, w = _small(13)(pkg)
    plan.solve(pkg.Single(0))
    rng = np.random.default_rng(23)
    w = w.copy()
    for _ in range(3):
        ids, neww = _perturb(rng, w, k=8)
        w[ids] = neww
        plan.update(ids, neww)
    return [_snap(plan.resolve(warm=True))]


def _cold_refresh(pkg):
    """resolve(warm=False) re-solves cold and refreshes residency, so
    the next warm resolve is a no-op."""
    plan, w = _small(15)(pkg)
    plan.solve(pkg.Single(0))
    plan.update([2], [int(w[2]) + 5])
    cold = plan.resolve(warm=False)
    return [_snap(cold), _snap(plan.resolve(warm=True))]


SCENARIOS = {"cascade": _cascade, "tie": _tie, "demotion": _demotion,
             "overflowed_resident": _overflowed_resident,
             "increase_without_tree": _increase_without_tree,
             "zero_weight_packed": _zero_weight_packed, "noop": _noop,
             "compose": _compose, "cold_refresh": _cold_refresh}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dynamic_scenario_bitwise_equal_reference(name):
    ours = SCENARIOS[name](_Pkg(port=True))
    ref = SCENARIOS[name](_Pkg(port=False))
    assert ours == ref
    if name == "cascade":
        assert ours[1] == [False, True] and ours[2] == 256
    if name == "tie":
        assert ours[1][1][3] == 1 and ours[1][7] == 0   # new parent, no-op
    if name in ("increase_without_tree", "zero_weight_packed"):
        assert ours[0][6] is False                       # cold fallback
    if name == "overflowed_resident":
        assert ours[0][4] and ours[1][4] and ours[1][6] is False
    if name == "noop":
        assert ours[1][2:] == (0, 0, False, False, True, 0, 0)
    if name == "cold_refresh":
        assert ours[0][6] is False and ours[1][7] == 0
    if name == "demotion":
        assert ours[-2:] == [True, 0]
        assert all(s[5] and s[6] for s in ours[1:3])


# ------------------------------------------------------ refusals, helpers

def _refusal_cases():
    jg = jgen.watts_strogatz(200, 6, 0.05, seed=9)
    n, w = jg.n_nodes, np.asarray(jg.w, np.int32)
    base = dict(source=0, dist=np.zeros(n, np.int64),
                pred=np.full(n, -1, np.int32), w=w)
    more = w.copy()
    more[3] += 10
    zero = w.copy()
    zero[0] = 0
    return {"overflow": (jg, dict(base, overflow=True), "none", "overflow"),
            "none_increase": (JCOOGraph(jg.src, jg.dst, more, n),
                              dict(base, overflow=False), "none",
                              "predecessor tree"),
            "packed_zero": (JCOOGraph(jg.src, jg.dst, zero, n),
                            dict(base, overflow=False), "packed",
                            "canonical")}


@pytest.mark.parametrize("case", ["overflow", "none_increase",
                                  "packed_zero"])
def test_plan_repair_refusals_match_reference(case):
    jg, fields, pred_mode, needle = _refusal_cases()[case]
    ref = jplan_repair(jg, JResident(**fields), pred_mode=pred_mode)
    ours = plan_repair(_port_graph(jg), Resident(**{
        k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
        else v for k, v in fields.items()}), pred_mode=pred_mode)
    assert ours[0] is None and ref[0] is None
    assert ours[1] == ref[1] and needle in ours[1]


def test_apply_weight_update_matches_reference_and_validates():
    jg = jgen.watts_strogatz(50, 4, 0.05, seed=1)
    g = _port_graph(jg)
    w_before = g.w.clone()
    ids, neww = [4, 7, 4, 0], [9, 3, 2, 11]          # id 4 twice: last wins
    new = apply_weight_update(g, ids, neww)
    ref = japply(jg, ids, neww)
    np.testing.assert_array_equal(new.w.numpy(), np.asarray(ref.w))
    assert int(new.w[4]) == 2
    assert torch.equal(g.w, w_before)                # the old w untouched
    assert new.w is not g.w and new.src is g.src and new.dst is g.dst
    for bad_ids, bad_w in (([g.n_edges], [5]), ([0], [-1]), ([0], [INF]),
                           ([0, 1], [5]), ([-1], [3])):
        for fn, graph in ((apply_weight_update, g), (japply, jg)):
            with pytest.raises(ValueError):
                fn(graph, bad_ids, bad_w)
    plan = Engine(g, DeltaConfig(delta=10), device="cpu").plan()
    with pytest.raises(ValueError, match="resident"):
        plan.resolve()
    assert plan.explain()["resident_source"] is None


def test_resident_words_match_reference():
    dist = np.array([0, 7, INF, 3], np.int64)
    pred = np.array([-1, 0, -1, 1], np.int32)
    for packed in (False, True):
        ours = resident_words(torch.from_numpy(dist), torch.from_numpy(pred),
                              source=0, packed=packed)
        ref = jresident_words(dist, pred, source=0, packed=packed)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    words = resident_words(dist, pred, source=0, packed=True)
    assert words[0] == 0 and words[1] == (7 << 32) and words[3] == (3 << 32) | 1
