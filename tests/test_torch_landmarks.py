"""The port's landmark subsystem against the JAX package: ALT tables and
their store, the estimator's statistics and fingerprint, potentials and
reduced weights, the all-light point-to-point drivers (``inner_stop``,
the meeting rule) and the ``Plan`` wiring (``prepare_landmarks``,
``landmark_tables``, ``LandmarkRefused``, ``explain()["landmarks"]``).

``repro_torch`` runs on the CPU (``device="cpu"``) and ``repro`` as its
own tests run it there, on the same graphs: the three families of
``tests/test_landmarks.py`` at its sizes and one small game map.
Tolerance: none — everything compared is an integer (distances, paths,
landmark ids, table rows, potentials, reduced weights, bucket and
inner-iteration counters, overflow flags, meeting vertices,
predecessor trees). Every landmark answer must also equal the port's
``early_exit`` answer and the Dijkstra oracle, and every landmark solve
must make ``2 * buckets + inner_iters + 1`` host syncs. The JAX side of
each graph runs in one test item per graph (``test_*_equals_reference``)
and the other cases check the port alone (against ``early_exit``, the
Dijkstra oracle and its own invariants), so under xdist each JAX
program compiles on one worker, not on every worker a case lands on.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
from repro.api import Engine as JEngine
from repro.api import PointToPoint as JPointToPoint
from repro.api import stitch_bidirectional_path as jstitch
from repro.core import DeltaConfig as JDeltaConfig
from repro.core.backends import EdgeBackend as JEdgeBackend
from repro.core.delta_stepping import _run_one_bidir as j_run_one_bidir
from repro.graphs import generators as jgen
from repro.graphs.structures import COOGraph as JCOOGraph
from repro.graphs.structures import coo_to_csr as jcoo_to_csr
from repro.graphs.structures import csr_to_ell as jcsr_to_ell
from repro.graphs.structures import union_with_reverse as junion
from repro.landmarks import LandmarkSpec as JLandmarkSpec
from repro.landmarks import LandmarkTables as JLandmarkTables
from repro.landmarks import graph_whash as jgraph_whash
from repro.landmarks import potentials as jpotentials
from repro.landmarks import reduce_forward as jreduce_forward
from repro.landmarks import reduce_union as jreduce_union
from repro.landmarks import require_canonical as jrequire_canonical
from repro.landmarks import select_landmarks as jselect
from repro.tune.estimator import _bfs_eccentricity as j_bfs_eccentricity
from repro.tune.estimator import estimate_delta as jestimate_delta
from repro.tune.estimator import fingerprint as jfingerprint
from repro.tune.estimator import graph_stats as jgraph_stats
from repro_torch.api import (
    Engine,
    LandmarkRefused,
    PointToPoint,
    SingleSource,
    UpdateRefused,
    stitch_bidirectional_path,
)
from repro_torch.core import DeltaConfig, dijkstra, walk_pred_tree
from repro_torch.core.backends import EdgeBackend, FusedBackend
from repro_torch.core.delta_stepping import (
    _run_backend,
    _run_one_bidir,
    _run_one_p2p,
)
from repro_torch.graphs import coo_from_numpy, coo_to_csr, csr_to_ell
from repro_torch.graphs import union_with_reverse
from repro_torch.landmarks import (
    LANDMARK_MODES,
    LandmarkSpec,
    LandmarkState,
    LandmarkStore,
    LandmarkTables,
    POTENTIAL_CLIP,
    build_tables,
    graph_whash,
    potentials,
    reduce_forward,
    reduce_union,
    require_canonical,
    select_landmarks,
)
from repro_torch.tune.estimator import (
    _bfs_eccentricity,
    estimate_delta,
    fingerprint,
    graph_stats,
)

INF = 2**31 - 1
DELTA = 10
MODES = ("early_exit",) + LANDMARK_MODES
STRATEGIES = ("edge", "ell", "pallas", "fused")

JGRAPHS = {
    "lattice": lambda: jgen.square_lattice(14, weighted=True, seed=3),
    "smallworld": lambda: jgen.watts_strogatz(180, 6, 0.05, seed=7),
    "random": lambda: jgen.random_graph(150, 900, seed=2),
}
FAMILIES = sorted(JGRAPHS)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _port_graph(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _targets(n):
    return (1, n // 3, n - 1)


def _answer(res):
    """A PointToPoint answer and its counters, on the host."""
    t = res.telemetry
    return (int(res.distance), res.path, int(t.buckets),
            int(t.inner_iters), bool(t.overflow))


def _edge_weights(g):
    w = {}
    for u, v, c in zip(g.src.tolist(), g.dst.tolist(), g.w.tolist()):
        w[(u, v)] = min(w.get((u, v), c), c)
    return w


def _check_path(g, path, source, target, distance):
    """Endpoints, edge existence and exact cost of one path, and the
    path re-expressed as a one-chain tree passes ``walk_pred_tree``."""
    assert path[0] == source and path[-1] == target
    assert len(set(path)) == len(path)
    ew = _edge_weights(g)
    pred = np.full(g.n_nodes, -1, np.int32)
    dist = np.full(g.n_nodes, INF, np.int64)
    dist[source] = acc = 0
    for a, b in zip(path, path[1:]):
        acc += ew[(a, b)]
        pred[b], dist[b] = a, acc
    assert acc == distance
    assert walk_pred_tree(g, source, dist, pred)


class Family:
    """One family's graph in both packages and its Dijkstra distances
    from 0."""

    def __init__(self, name):
        self.name = name
        self.jg = JGRAPHS[name]()
        self.g = _port_graph(self.jg)
        self.dref = dijkstra(self.g, 0)[0]


class _Families(dict):
    def __missing__(self, name):
        self[name] = Family(name)
        return self[name]


@pytest.fixture(scope="session")
def families():
    return _Families()


def _carry_over(jtables, g, store):
    """The JAX package's tables as the port's: the same arrays under the
    port's fingerprint of ``g``, put into ``store`` so that a
    ``LandmarkState`` over it finds them instead of building its own."""
    fp = fingerprint(graph_stats(g), g.device)
    tables = LandmarkTables(
        fingerprint=fp, whash=jtables.whash, strategy=jtables.strategy,
        seed=jtables.seed, landmarks=np.asarray(jtables.landmarks, np.int32),
        d_out=np.asarray(jtables.d_out, np.int32),
        d_in=np.asarray(jtables.d_in, np.int32))
    store.put(tables)
    return tables


# ---------------------------------------------------------------------------
# tables, statistics, potentials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_union_with_reverse_equals_reference(families, family):
    f = families[family]
    ju, u = junion(f.jg), union_with_reverse(f.g)
    assert u.n_nodes == ju.n_nodes == 2 * f.g.n_nodes
    for a, b in ((u.src, ju.src), (u.dst, ju.dst), (u.w, ju.w)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("strategy,seed,k", [("random", 3, 5),
                                             ("farthest", 3, 5),
                                             ("random", 0, 1)])
def test_selection_equals_reference(families, strategy, seed, k):
    f = families["smallworld"]
    ours = select_landmarks(f.g, k, strategy=strategy, seed=seed,
                            delta=DELTA)
    ref = jselect(f.jg, k, strategy=strategy, seed=seed, delta=DELTA)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(np.unique(ours[0])) == k and list(ours[0]) == sorted(ours[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_graph_stats_and_fingerprint_equal_reference(families, family):
    f = families[family]
    ours, ref = graph_stats(f.g), jgraph_stats(f.jg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    fp, jfp = fingerprint(ours, "cpu"), jfingerprint(ref)
    head, _, dev = fp.partition(":dev=")
    assert head == jfp.partition(":dev=")[0]
    assert dev == "torch-cpu1" and fp != jfp
    assert dataclasses.asdict(graph_stats(f.g, probe_ecc=False)) == \
        dataclasses.asdict(jgraph_stats(f.jg, probe_ecc=False))
    with pytest.raises(ValueError, match="probe_ecc"):
        fingerprint(graph_stats(f.g, probe_ecc=False), "cpu")
    # the zero-measurement Δ at small, default and clamped c
    for c in (0.5, 3.0, 12.0, 1e6):
        ours = estimate_delta(graph_stats(f.g, probe_ecc=False), c)
        assert ours == jestimate_delta(jgraph_stats(f.jg, probe_ecc=False), c)
        assert 1 <= ours <= 4 * int(f.g.w.max())
    src, dst = f.g.src.numpy(), f.g.dst.numpy()
    for s in (0, 1, f.g.n_nodes - 1):
        assert _bfs_eccentricity(src, dst, f.g.n_nodes, s) == \
            j_bfs_eccentricity(np.asarray(f.jg.src), np.asarray(f.jg.dst),
                               f.jg.n_nodes, s)
    # the store's weight hash, and a new one after one weight changes
    assert graph_whash(f.g) == jgraph_whash(f.jg)
    w = f.g.w.clone()
    w[0] += 1
    assert graph_whash(coo_from_numpy(src, dst, w.numpy(), f.g.n_nodes)) \
        != graph_whash(f.g)


def test_graph_stats_of_edgeless_graph_equal_reference():
    g = coo_from_numpy(np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.int32), 5)
    jg = JCOOGraph(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                   w=np.zeros(0, np.int32), n_nodes=5)
    assert dataclasses.asdict(graph_stats(g)) == \
        dataclasses.asdict(jgraph_stats(jg))
    assert estimate_delta(graph_stats(g)) == \
        jestimate_delta(jgraph_stats(jg))


def _random_ell(rng, rows, width, n_valid):
    nbr = rng.integers(0, n_valid + 1, size=(rows, width)).astype(np.int32)
    nbr[-1] = n_valid
    w = rng.integers(1, 2**20, size=(rows, width)).astype(np.int32)
    w[nbr == n_valid] = INF
    return w, nbr


def test_potentials_and_reduced_weights_like_reference():
    """π from seeded tables with unreachable (INF32) entries and rows
    past the clip, for every target, inside [0, clip]; both reduced-weight
    blocks on seeded ELL adjacencies, and the int32 wrap of
    ``w + π[v] − π[u]`` and the clipped gather of the sentinel row at the
    extremes the clamp allows and past them: all equal to the
    reference's."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        k, n = int(rng.integers(1, 5)), 24
        rows = []
        for _ in range(2):
            d = rng.integers(0, 2**29, size=(k, n)).astype(np.int32)
            d[rng.random((k, n)) < 0.2] = INF
            rows.append(d)
        fields = dict(fingerprint="f", whash="h", strategy="random",
                      seed=seed, landmarks=np.arange(k, dtype=np.int32),
                      d_out=rows[0], d_in=rows[1])
        ours, ref = LandmarkTables(**fields), JLandmarkTables(**fields)
        for t in range(n):
            pi = potentials(ours, t)
            np.testing.assert_array_equal(pi, jpotentials(ref, t))
            assert pi.dtype == np.int64
            assert (pi >= 0).all() and (pi <= POTENTIAL_CLIP).all()

    rng = np.random.default_rng(0)
    n, width, half = 10, 4, 5
    pi = rng.integers(0, 2**20, size=n).astype(np.int32)
    w, nbr = _random_ell(rng, n + 1, width, n)
    extreme = np.array([0, 2**28, 2**30, -2**30, 7, 2**31 - 1] * 2, np.int32)
    for p in (pi, extreme[:n]):
        for wb in (w, np.where(nbr == n, INF, 2**30 - 1).astype(np.int32)):
            ours = reduce_forward(torch.from_numpy(wb), torch.from_numpy(nbr),
                                  torch.from_numpy(p), n)
            assert ours.dtype == torch.int32
            np.testing.assert_array_equal(
                ours.numpy(), np.asarray(jreduce_forward(wb, nbr, p, n)))
    w, nbr = _random_ell(rng, 2 * half + 1, width, 2 * half)
    for p in (pi[:half], extreme[:half]):
        ours = reduce_union(torch.from_numpy(w), torch.from_numpy(nbr),
                            torch.from_numpy(p), half)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(
            ours.numpy(), np.asarray(jreduce_union(w, nbr, p, half)))


# ---------------------------------------------------------------------------
# the query path: every mode bitwise the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_family_equals_reference(families, family):
    """Everything the JAX package computes for one family, against the
    port: the tables (k = 4, farthest, seed 0) with rows equal to the
    oracle on the graph and its reverse; potentials and both reduced
    ELL weight blocks for three targets; every landmark mode's answer
    and counters from source 0 to every target, and from vertex 5 to
    itself in every mode; and a port ``LandmarkState`` fed the JAX
    tables through its store (the carry-over of this slice's state),
    whose raw solves — distance, meeting vertex, both predecessor trees,
    counters — are the JAX package's."""
    from repro.landmarks import LandmarkState as JLandmarkState

    f = families[family]
    n = f.g.n_nodes
    jplan = JEngine(f.jg, JDeltaConfig(delta=DELTA)).plan()
    jplan.prepare_landmarks(k=4)
    jt = jplan.landmark_tables

    tb = build_tables(f.g, k=4, delta=DELTA)
    for a, b in ((tb.landmarks, jt.landmarks), (tb.d_out, jt.d_out),
                 (tb.d_in, jt.d_in)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert tb.whash == jt.whash == graph_whash(f.g)
    rev = f.g.reversed()
    for j, lm in enumerate(tb.landmarks):
        np.testing.assert_array_equal(tb.d_out[j], dijkstra(f.g, int(lm))[0])
        np.testing.assert_array_equal(tb.d_in[j], dijkstra(rev, int(lm))[0])

    store = LandmarkStore()
    tables = _carry_over(jt, f.g, store)
    fwd, uni = csr_to_ell(coo_to_csr(f.g)), csr_to_ell(coo_to_csr(
        union_with_reverse(f.g)))
    jfwd = jcsr_to_ell(jcoo_to_csr(f.jg))
    juni = jcsr_to_ell(jcoo_to_csr(junion(f.jg)))
    np.testing.assert_array_equal(uni.nbr.numpy(), np.asarray(juni.nbr))
    for target in (0, n // 2, n - 1):
        pi = potentials(tables, target)
        np.testing.assert_array_equal(pi, jpotentials(jt, target))
        assert pi[target] == 0
        pi32 = pi.astype(np.int32)
        wf = reduce_forward(fwd.w, fwd.nbr, torch.from_numpy(pi32), n)
        wu = reduce_union(uni.w, uni.nbr, torch.from_numpy(pi32), n)
        jwf = jreduce_forward(jfwd.w, jfwd.nbr, pi32, n)
        jwu = jreduce_union(juni.w, juni.nbr, pi32, n)
        for ours, ref, w in ((wf, jwf, fwd.w), (wu, jwu, uni.w)):
            assert ours.dtype == torch.int32
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
            assert (ours[w < INF] >= 0).all()   # π is consistent

    plan = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    plan.prepare_landmarks(k=4)
    for mode in LANDMARK_MODES:
        for t in _targets(n):
            r = plan.solve(PointToPoint(0, t, mode=mode))
            ref = jplan.solve(JPointToPoint(0, t, mode=mode))
            assert _answer(r) == _answer(ref), (family, mode, t)
    for mode in MODES:
        r = plan.solve(PointToPoint(5, 5, mode=mode))
        assert _answer(r) == _answer(jplan.solve(JPointToPoint(5, 5,
                                                               mode=mode)))

    st = LandmarkState(LandmarkSpec(), DELTA, store=store)
    assert st.ensure_tables(f.g) is tables
    jst = jplan._landmarks
    assert isinstance(jst, JLandmarkState)
    for mode in LANDMARK_MODES:
        for t in _targets(n):
            ours = st.solve_p2p(f.g, 0, t, mode)
            ref = jst.solve_p2p(f.jg, 0, t, mode)
            assert (ours.distance, ours.meet, ours.outer, ours.inner,
                    ours.overflow) == (ref.distance, ref.meet, int(ref.outer),
                                       int(ref.inner), bool(ref.overflow))
            for a, b in ((ours.pred_f, ref.pred_f), (ours.pred_b, ref.pred_b)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert ours.host_syncs == 2 * ours.outer + ours.inner + 1


@pytest.mark.parametrize("mode", LANDMARK_MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_modes_equal_early_exit_and_oracle(families, family, mode):
    f = families[family]
    plan = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    for t in _targets(f.g.n_nodes):
        base = plan.solve(PointToPoint(0, t))
        assert base.distance == int(f.dref[t])
        r = plan.solve(PointToPoint(0, t, mode=mode))
        assert r.distance == base.distance, (family, mode, t)
        assert not r.telemetry.overflow
        tel = r.telemetry
        assert plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1
        if r.distance < INF:
            _check_path(f.g, r.path, 0, t, r.distance)
        else:
            assert r.path is None
    assert plan.explain()["landmarks"] == (None if mode == "bidirectional"
                                           else 4)


@pytest.mark.parametrize("all_light", [False, True])
@pytest.mark.parametrize("family", ["lattice", "random"])
def test_bidir_driver_equals_reference_on_edge(families, family, all_light):
    """``_run_one_bidir`` on a generic backend (the ``2·nxt·Δ >= μ``
    stop) and with the all-light meeting rule, over the union graph on
    ``edge``: tent words and counters bitwise the reference's."""
    f = families[family]
    n = f.g.n_nodes
    t = n - 1
    cfg = DeltaConfig(delta=DELTA, strategy="edge")
    backend = EdgeBackend.build(union_with_reverse(f.g), cfg)
    tent0 = torch.full((2 * n,), INF, dtype=torch.int32)
    tent0[0] = 0
    tent0[t + n] = 0
    explored0 = torch.full((2 * n,), INF, dtype=torch.int32)
    out = _run_one_bidir(backend, tent0, explored0, n=2 * n, packed=False,
                         device="cpu", all_light=all_light)
    jbackend = JEdgeBackend.build(junion(f.jg), JDeltaConfig(delta=DELTA))
    jt0 = np.asarray(tent0.numpy())
    jref = j_run_one_bidir(jbackend, jt0, explored0.numpy(), n=2 * n,
                           packed=False, all_light=all_light)
    np.testing.assert_array_equal(out.tent.numpy(), np.asarray(jref[0]))
    assert (out.outer_iters, out.inner_iters, out.overflow) == (
        int(jref[1]), int(jref[2]), bool(jref[3]))
    assert out.host_syncs == 2 * out.outer_iters + out.inner_iters + 1
    f_, b_ = out.tent[:n].to(torch.int64), out.tent[n:].to(torch.int64)
    fin = (f_ < INF) & (b_ < INF)
    assert int(torch.where(fin, f_ + b_, INF).min()) == int(f.dref[t])


def test_inner_stop_refused_on_fused_backend(families):
    f = families["lattice"]
    backend = FusedBackend.build(f.g, DeltaConfig(delta=DELTA,
                                                  strategy="fused"))
    with pytest.raises(ValueError, match="fused"):
        _run_backend(backend, 0, n=f.g.n_nodes, packed=False, device="cpu",
                     inner_stop=lambda tent, explored: tent[0] < 0)
    with pytest.raises(ValueError, match="fused"):
        _run_one_p2p(backend, 0, 5, n=f.g.n_nodes, packed=False,
                     device="cpu", all_light=True)
    # without the hook the fused loop runs as before
    out = _run_one_p2p(backend, 0, 5, n=f.g.n_nodes, packed=False,
                       device="cpu")
    assert int(out.tent[5]) == int(f.dref[5])


@pytest.mark.parametrize("mode", MODES)
def test_source_equals_target(families, mode):
    f = families["lattice"]
    plan = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    r = plan.solve(PointToPoint(5, 5, mode=mode))
    assert r.distance == 0 and r.path == [5], mode
    tel = r.telemetry
    assert plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1
    if mode in ("bidirectional", "alt_bidirectional"):
        # the meeting rule holds before bucket 0: the cold two-seed state
        assert (tel.buckets, tel.inner_iters, plan.host_syncs) == (0, 0, 1)


def _sparse_case():
    """A sparse graph with an isolated tail, in both packages, and a
    vertex source 0 cannot reach."""
    jg = jgen.random_graph(60, 90, seed=5)
    g = _port_graph(jg)
    dref, _ = dijkstra(g, 0)
    far = int(np.argmax(dref))
    assert dref[far] >= INF
    return jg, g, far


@pytest.mark.parametrize("mode", MODES)
def test_unreachable_target(mode):
    _, g, far = _sparse_case()
    plan = Engine(g, DeltaConfig(delta=8), device="cpu").plan()
    r = plan.solve(PointToPoint(0, far, mode=mode))
    assert r.distance == INF and r.path is None, mode


def test_unreachable_target_equals_reference():
    jg, g, far = _sparse_case()
    plan = Engine(g, DeltaConfig(delta=8), device="cpu").plan()
    jplan = JEngine(jg, JDeltaConfig(delta=8)).plan()
    for mode in LANDMARK_MODES:
        assert _answer(plan.solve(PointToPoint(0, far, mode=mode))) == \
            _answer(jplan.solve(JPointToPoint(0, far, mode=mode)))


def test_landmark_modes_require_canonical_weights():
    jg = jgen.random_graph(40, 120, seed=0)
    w = np.asarray(jg.w).copy()
    w[0] = 0
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst), w, jg.n_nodes)
    require_canonical(_port_graph(jg))
    jrequire_canonical(jg)
    with pytest.raises(ValueError, match="canonical"):
        jrequire_canonical(JCOOGraph(src=jg.src, dst=jg.dst, w=w,
                                     n_nodes=jg.n_nodes))
    with pytest.raises(ValueError, match="canonical"):
        require_canonical(g)
    plan = Engine(g, DeltaConfig(delta=8), device="cpu").plan()
    for mode in LANDMARK_MODES:
        with pytest.raises(ValueError, match="canonical"):
            plan.solve(PointToPoint(0, 10, mode=mode))
    with pytest.raises(ValueError, match="canonical"):
        plan.prepare_landmarks(k=2)
    # a deferred build defers the check to the first landmark query
    plan.prepare_landmarks(k=2, build=False)
    assert plan.landmark_tables is None
    assert plan.solve(PointToPoint(0, 10)).distance < INF


def test_bad_mode_and_policy_rejected(families):
    g = families["lattice"].g
    plan = Engine(g, DeltaConfig(delta=DELTA), device="cpu").plan()
    with pytest.raises(ValueError, match="p2p"):
        plan.solve(PointToPoint(0, 5, mode="astar"))
    rho = Engine(g, DeltaConfig(delta=DELTA, policy="rho"),
                 device="cpu").plan()
    with pytest.raises(ValueError, match="delta-only"):
        rho.solve(PointToPoint(0, 5, mode="alt"))
    for kwargs in (dict(k=0), dict(k=-2), dict(strategy="nearest"),
                   dict(on_update="ignore")):
        with pytest.raises(ValueError) as ref:
            JLandmarkSpec(**kwargs)
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            LandmarkSpec(**kwargs)
    assert dataclasses.asdict(LandmarkSpec()) == \
        dataclasses.asdict(JLandmarkSpec())


def _grid_case():
    """A small game map in both packages, its mask and its first and
    last free cells, and the port's grid plan."""
    jg, free = jgen.grid_map(20, 20, 0.1, seed=0)
    free = np.asarray(free)
    cells = np.flatnonzero(free.ravel())
    g = _port_graph(jg)
    plan = Engine(g, DeltaConfig(delta=13, strategy="pallas"),
                  free_mask=free, device="cpu").plan()
    return jg, free, int(cells[0]), int(cells[-1]), plan


@pytest.mark.parametrize("mode", LANDMARK_MODES)
def test_grid_plan_modes(mode):
    """A game-map grid plan answers the landmark modes over its COO
    graph: the grid stencil's single-source distance, a valid path."""
    _, _, s, t, plan = _grid_case()
    r = plan.solve(PointToPoint(s, t, mode=mode))
    tel = r.telemetry
    assert plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1
    assert r.distance == int(plan.solve(SingleSource(s)).dist[t])
    _check_path(plan.graph, r.path, s, t, r.distance)


def test_grid_plan_modes_equal_reference():
    jg, free, s, t, plan = _grid_case()
    jplan = JEngine(jg, JDeltaConfig(delta=13, strategy="pallas",
                                     interpret=True), free_mask=free).plan()
    for mode in LANDMARK_MODES:
        assert _answer(plan.solve(PointToPoint(s, t, mode=mode))) == \
            _answer(jplan.solve(JPointToPoint(s, t, mode=mode)))


# ---------------------------------------------------------------------------
# stitch_bidirectional_path
# ---------------------------------------------------------------------------

STITCH_CASES = [
    # (pred_f, pred_b, meet, expected)
    ([-1, 0, 1, -1], [-1, -1, 3, -1], 2, [0, 1, 2, 3]),
    ([-1, 0, 1, -1], [-1, -1, 3, -1], 3, None),   # pf[3] = -1
    ([-1, 0, 1, 2], [-1, -1, 3, -1], 3, [0, 1, 2, 3]),
    ([-1, 0, 1, -1], [1, 2, 3, -1], 0, [0, 1, 2, 3]),
    ([-1, 2, 1, -1], [-1, -1, 3, -1], 2, None),   # forward cycle
    ([-1, 0, 1, -1], [-1, -1, 2, -1], 2, None),   # backward self loop
    ([-1, 0, 1, -1], [-1, -1, 1, -1], 2, None),   # wrong backward root
]


@pytest.mark.parametrize("pf,pb,meet,expected", STITCH_CASES)
def test_stitch_regressions(pf, pb, meet, expected):
    pf, pb = np.array(pf, np.int32), np.array(pb, np.int32)
    assert stitch_bidirectional_path(pf, pb, 0, 3, meet, 4) == expected
    assert jstitch(pf, pb, 0, 3, meet, 4) == expected


def test_stitched_paths_many_pairs(families):
    f = families["random"]
    plan = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    dref, _ = dijkstra(f.g, 3)
    rng = np.random.default_rng(0)
    for t in rng.integers(0, f.g.n_nodes, size=4).tolist():
        for mode in ("bidirectional", "alt_bidirectional"):
            r = plan.solve(PointToPoint(3, t, mode=mode))
            assert r.distance == int(dref[t]), (mode, t)
            _check_path(f.g, r.path, 3, t, r.distance)
    # seeded predecessor arrays (cycles, -1 holes and wrong roots
    # included) and meeting vertices: the same path, or the same None,
    # as the reference
    n = 9
    for _ in range(50):
        pf = rng.integers(-1, n, size=n).astype(np.int32)
        pb = rng.integers(-1, n, size=n).astype(np.int32)
        s, t, meet = (int(x) for x in rng.integers(0, n, size=3))
        pf[s], pb[t] = -1, -1
        ours = stitch_bidirectional_path(pf, pb, s, t, meet, n)
        assert ours == jstitch(pf, pb, s, t, meet, n)
        if ours is not None:
            assert ours[0] == s and ours[-1] == t and meet in ours


# ---------------------------------------------------------------------------
# updates: stale tables never serve
# ---------------------------------------------------------------------------

def _inc_dec_batches(w):
    """One increase-only batch and one decreasing batch on the heaviest
    edge (the reference suite's ``_inc_dec_batches``)."""
    eid = int(np.argmax(w))
    return ([eid], [int(w[eid]) + 5]), ([eid], [1])


def _update_sequence(plan):
    """Landmark tables at k = 3, then the increase-only batch (tables
    kept, ``alt`` answered) and the decreasing batch (tables dropped,
    every mode answered, tables rebuilt), each answer equal to the
    oracle on the weights it was solved at. Returns the landmarks, the
    answers and the rebuilt ``d_out`` by step."""
    t = plan.graph.n_nodes - 1
    inc, dec = _inc_dec_batches(plan.graph.w.numpy())
    seen = {}

    def solve(step, mode):
        r = plan.solve(PointToPoint(0, t, mode=mode))
        assert r.distance == int(dijkstra(plan.graph, 0)[0][t]), step
        seen[step] = _answer(r)

    plan.prepare_landmarks(k=3)
    tables0 = plan.landmark_tables
    seen["landmarks"] = np.asarray(tables0.landmarks)
    plan.update(*inc)                           # increase-only: kept
    assert plan.landmark_tables is tables0
    assert plan.explain()["landmarks"] == 3
    solve("inc alt", "alt")
    plan.update(*dec)                           # decrease: stale -> drop
    assert plan.landmark_tables is None
    assert plan.explain()["landmarks"] is None
    for mode in LANDMARK_MODES:                 # lazy rebuild, fresh answer
        solve(f"dec {mode}", mode)
    assert plan.landmark_tables is not None
    seen["d_out"] = np.asarray(plan.landmark_tables.d_out)
    return seen


@pytest.fixture(scope="module")
def jax_update_sequence(families):
    """The update sequence of ``_update_sequence`` on the JAX package's
    ``edge`` plan: landmarks, answers and counters by step, and the
    rebuilt rows (one JAX run per worker)."""
    f = families["random"]
    jplan = JEngine(f.jg, JDeltaConfig(delta=DELTA)).plan()
    t = f.g.n_nodes - 1
    inc, dec = _inc_dec_batches(f.g.w.numpy())
    jplan.prepare_landmarks(k=3)
    ref = {"landmarks": np.asarray(jplan.landmark_tables.landmarks)}
    jplan.update(*inc)
    ref["inc alt"] = _answer(jplan.solve(JPointToPoint(0, t, mode="alt")))
    jplan.update(*dec)
    for mode in LANDMARK_MODES:
        ref[f"dec {mode}"] = _answer(jplan.solve(JPointToPoint(0, t,
                                                               mode=mode)))
    ref["d_out"] = np.asarray(jplan.landmark_tables.d_out)
    return ref


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_updates_equal_reference(families, jax_update_sequence, strategy):
    """The update sequence on each ported strategy against the JAX
    package's on ``edge``: tables kept or dropped, landmarks, answers and
    counters, and the rebuilt rows, bitwise (the landmark path ignores
    the plan's strategy in both packages)."""
    f = families["random"]
    seen = _update_sequence(Engine(
        f.g, DeltaConfig(delta=DELTA, strategy=strategy), device="cpu").plan())
    assert seen.keys() == jax_update_sequence.keys()
    for step, value in jax_update_sequence.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(seen[step], value)
        else:
            assert seen[step] == value, (strategy, step)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_update_refused_before_any_weight_changes(families, strategy):
    f = families["random"]
    plan = Engine(f.g, DeltaConfig(delta=DELTA, strategy=strategy),
                  device="cpu").plan()
    plan.prepare_landmarks(k=3, on_update="refuse")
    inc, dec = _inc_dec_batches(f.g.w.numpy())
    plan.update(*inc)                           # increases pass through
    w_before = plan.graph.w.clone()
    with pytest.raises(LandmarkRefused) as ei:
        plan.update(*dec)
    assert ei.value.reason == "landmarks_stale"
    assert isinstance(ei.value, UpdateRefused)
    assert torch.equal(plan.graph.w, w_before)  # refused BEFORE applying
    assert plan.landmark_tables is not None
    t = f.g.n_nodes - 1
    assert plan.solve(PointToPoint(0, t, mode="alt")).distance == \
        int(dijkstra(plan.graph, 0)[0][t])


def test_landmark_state_shared_with_full_width_twin(families):
    """A twin made by the overflow fallback BEFORE ``prepare_landmarks``
    sees the new state; an update of the plan re-validates the tables
    the twin built for itself after demotion."""
    f = families["random"]
    t = f.g.n_nodes - 1
    plan = Engine(f.g, DeltaConfig(delta=DELTA, strategy="ell",
                                   frontier_cap=2), device="cpu").plan(
        fallback=True)
    assert plan.solve(SingleSource(0)).telemetry.fallback
    assert plan.explain()["fallback_taken"]
    plan.prepare_landmarks(k=2)
    assert plan._demoted._landmarks is plan._landmarks
    r = plan.solve(PointToPoint(0, t, mode="alt"))
    assert r.telemetry.fallback and r.distance == int(f.dref[t])
    assert plan.landmark_tables is plan._demoted.landmark_tables

    lazy = Engine(f.g, DeltaConfig(delta=DELTA, strategy="ell",
                                   frontier_cap=2), device="cpu").plan(
        fallback=True)
    lazy.solve(SingleSource(0))
    lazy.solve(PointToPoint(0, t, mode="alt"))  # the twin builds its own
    assert lazy.landmark_tables is None
    assert lazy._demoted.landmark_tables is not None
    _, dec = _inc_dec_batches(f.g.w.numpy())
    lazy.update(*dec)
    assert lazy._demoted.landmark_tables is None     # stale, dropped
    assert lazy.solve(PointToPoint(0, t, mode="alt")).distance == \
        int(dijkstra(lazy.graph, 0)[0][t])


def test_would_invalidate_last_wins(families):
    f = families["random"]
    st = LandmarkState(LandmarkSpec(k=2), DELTA)
    assert not st.would_invalidate([0], [1])    # no tables yet
    st.ensure_tables(f.g)
    w0 = int(f.g.w[0])
    assert st.would_invalidate([0, 0], [w0 + 1, w0 - 1]) == (w0 > 1)
    assert not st.would_invalidate([0, 0], [w0 - 1, w0 + 1])
    assert st.note_update(f.g) == "kept"


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_store_roundtrip_and_corruption(tmp_path):
    g = _port_graph(jgen.random_graph(60, 300, seed=8))
    spec = LandmarkSpec(k=3, store=str(tmp_path))
    tb = LandmarkState(spec, 8).ensure_tables(g)
    files = list(tmp_path.glob("landmarks_*.npz"))
    assert len(files) == 1
    # a second state over the same store hits persistently
    hit = LandmarkState(spec, 8).ensure_tables(g)
    for a, b in ((hit.landmarks, tb.landmarks), (hit.d_out, tb.d_out),
                 (hit.d_in, tb.d_in)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (hit.fingerprint, hit.whash, hit.strategy, hit.seed) == (
        tb.fingerprint, tb.whash, "farthest", 0)
    assert hit.fingerprint.endswith(":dev=torch-cpu1")
    # corruption is a miss, never a crash or a wrong answer
    files[0].write_bytes(b"not an npz")
    assert LandmarkStore(str(tmp_path)).get(
        tb.fingerprint, tb.whash, 3, "farthest", 0) is None
    rebuilt = LandmarkState(spec, 8).ensure_tables(g)
    np.testing.assert_array_equal(rebuilt.d_out, tb.d_out)
    assert not list(tmp_path.glob("*.tmp"))     # no torn temp file left


def test_store_is_weight_keyed(tmp_path):
    jg = jgen.random_graph(60, 300, seed=8)
    g = _port_graph(jg)
    w2 = g.w.clone()
    w2[0] += 1
    g2 = coo_from_numpy(g.src, g.dst, w2, g.n_nodes)
    assert graph_whash(g) != graph_whash(g2)
    assert fingerprint(graph_stats(g2), "cpu") == fingerprint(
        graph_stats(g), "cpu")                  # same fingerprint bucket
    store = LandmarkStore(str(tmp_path))
    tb = build_tables(g, k=2, delta=8, fingerprint="fp")
    store.put(tb)
    assert store.get("fp", graph_whash(g2), 2, "farthest", 0) is None
    assert store.get("fp", tb.whash, 2, "farthest", 0) is tb


def test_prepare_landmarks_from_store_and_explain(tmp_path, families):
    f = families["smallworld"]
    first = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    assert first.explain()["landmarks"] is None
    first.prepare_landmarks(k=4, store=str(tmp_path))
    second = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    second.prepare_landmarks(k=4, store=str(tmp_path))
    a, b = first.landmark_tables, second.landmark_tables
    assert a is not b
    for x, y in ((a.landmarks, b.landmarks), (a.d_out, b.d_out),
                 (a.d_in, b.d_in)):
        np.testing.assert_array_equal(x, y)
    assert second.explain()["landmarks"] == 4
    lazy = Engine(f.g, DeltaConfig(delta=DELTA), device="cpu").plan()
    lazy.prepare_landmarks(k=4, build=False)
    assert lazy.explain()["landmarks"] is None
    lazy.solve(PointToPoint(0, 5, mode="alt"))
    assert lazy.explain()["landmarks"] == 4
