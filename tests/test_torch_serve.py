"""The port's async serving tier (``repro_torch.serve.Server``) against
the JAX package's (``repro.serve.Server``): twins of
``tests/test_serving.py``'s cases.

Both servers take the same request stream with the same injected clock
(a constant, so every timestamp and latency is comparable), and every
ticket is held field by field: the result (dist, pred, distance, path,
matrix, radius, the whole telemetry), or the typed rejection and its
reason, and the request trace (tenant, kind, timestamps, occupancy,
shed reason). ``stats()`` must be equal too. The port runs on the CPU
(``device="cpu"``); answers are also held to a serial ``plan.solve``
stream of the port and to the Dijkstra oracle. Tolerance: none. The
threaded batch loop (``with srv:``) forms batches by arrival timing, so
there only the answers, not the batch counts, are compared. All cases
share two tenant graphs, one config and one lane width, so the JAX
side compiles few programs.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
from repro.api import BoundedRadius as JBoundedRadius
from repro.api import ManyToMany as JManyToMany
from repro.api import PointToPoint as JPointToPoint
from repro.api import SingleSource as JSingleSource
from repro.api import Tuning as JTuning
from repro.api import UpdateBatch as JUpdateBatch
from repro.core import DeltaConfig as JDeltaConfig
from repro.graphs import generators as jgen
from repro.serve import Server as JServer
from repro.tune import TuningCache as JTuningCache
from repro.tune import tune as jtune
from repro_torch.api import (
    BoundedRadius,
    Engine,
    ManyToMany,
    PointToPoint,
    SingleSource,
    Tuning,
    UpdateBatch,
    UpdateRefused,
)
from repro_torch.core import DeltaConfig, dijkstra
from repro_torch.graphs import coo_from_numpy
from repro_torch.serve import RequestRejected, Server, UpdateApplied
from repro_torch.tune import TuningCache, tune

CFG = DeltaConfig(delta=10, pred_mode="argmin")
LANE = 3


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _port(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _graphs(*names):
    """Tenant graphs by name, in both packages: ``ws`` and ``ws2``
    (small world), ``lat`` (weighted lattice)."""
    make = {"ws": lambda: jgen.watts_strogatz(200, 6, 0.05, seed=7),
            "ws2": lambda: jgen.watts_strogatz(220, 6, 0.05, seed=1),
            "lat": lambda: jgen.square_lattice(12, weighted=True, seed=3)}
    jgs = {n: make[n]() for n in names}
    return {n: _port(jg) for n, jg in jgs.items()}, jgs


_JAX_QUERY = {SingleSource: JSingleSource, PointToPoint: JPointToPoint,
              BoundedRadius: JBoundedRadius, ManyToMany: JManyToMany,
              UpdateBatch: JUpdateBatch}


def _jq(q):
    """The JAX package's twin of a port query."""
    return _JAX_QUERY[type(q)](**dataclasses.asdict(q))


def _servers(graphs, jgraphs, jtuning=None, **kw):
    """The port's server and the JAX package's on one constant clock
    (``now[0]``), with the same arguments; ``jtuning`` is the JAX
    server's ``tuning`` where it differs (its own cache file)."""
    now = [0.0]
    clock = lambda: now[0]                       # noqa: E731
    jkw = dict(kw)
    if "config" in kw:
        jkw["config"] = JDeltaConfig(**dataclasses.asdict(kw["config"]))
    if jtuning is not None:
        jkw["tuning"] = jtuning
    srv = Server(graphs, clock=clock, device="cpu", **kw)
    jsrv = JServer(jgraphs, clock=clock, **jkw)
    return srv, jsrv, now


def _same_value(a, b, tag):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, tag
        for f in dataclasses.fields(a):
            _same_value(getattr(a, f.name), getattr(b, f.name),
                        f"{tag}.{f.name}")
    elif isinstance(a, torch.Tensor):
        b = np.asarray(b)
        a = a.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, tag
        np.testing.assert_array_equal(a, b, err_msg=tag)
    elif isinstance(a, (list, tuple)):
        assert list(a) == [int(x) for x in b], tag
    elif a is None or b is None:
        assert a is None and b is None, tag
    else:
        assert a == type(a)(np.asarray(b)), (tag, a, b)


def _same_ticket(t, jt, tag):
    """One ticket against the JAX server's: its result or typed
    rejection, and its trace."""
    assert t.done() and jt.done(), tag
    exc, jexc = t.exception(0), jt.exception(0)
    assert (exc is None) == (jexc is None), (tag, exc, jexc)
    if exc is not None:
        assert type(exc).__name__ == type(jexc).__name__, tag
        assert getattr(exc, "reason", None) == getattr(jexc, "reason", None)
    else:
        _same_value(t.result(0), jt.result(0), tag)
    assert dataclasses.asdict(t.trace) == dataclasses.asdict(jt.trace), tag


def _submit_both(srv, jsrv, stream):
    """Submit ``(tenant, query)`` pairs to both servers in order."""
    return [(srv.submit(q, graph=name), jsrv.submit(_jq(q), graph=name))
            for name, q in stream]


def _serial(g, queries, cfg=CFG, free_mask=None):
    """The port's serial answers on one fresh fallback plan (updates
    applied in order, ``None`` in their place), and the plan."""
    plan = Engine(g, cfg, free_mask=free_mask, device="cpu").plan(
        fallback=True)
    out = []
    for q in queries:
        if isinstance(q, UpdateBatch):
            plan.update(q.edge_ids, q.new_weights)
            out.append(None)
        else:
            out.append(plan.solve(q))
    return out, plan


def _edge_cost(g, path):
    src, dst, w = (t.numpy() for t in (g.src, g.dst, g.w))
    cost = 0
    for u, v in zip(path[:-1], path[1:]):
        cost += int(w[(src == u) & (dst == v)].min())
    return cost


def _same_as_serial(got, ref, q, g):
    if isinstance(q, (SingleSource, BoundedRadius)):
        assert torch.equal(got.dist, ref.dist), q
        assert torch.equal(got.pred, ref.pred), q
    elif isinstance(q, ManyToMany):
        assert torch.equal(got.matrix, ref.matrix), q
    else:   # a lane settles every vertex, the serial early exit does not:
        # equal distance, and any shortest path of that weight
        assert got.distance == ref.distance, q
        assert (got.path is None) == (ref.path is None), q
        if got.path is not None:
            assert got.path[0] == q.source and got.path[-1] == q.target
            assert _edge_cost(g, got.path) == got.distance


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

MIXED = {
    "ws": [SingleSource(0), PointToPoint(0, 37), BoundedRadius(5, 30),
           SingleSource(11), ManyToMany([0, 1], [9, 10, 11], tile=3)],
    "lat": [SingleSource(2), BoundedRadius(0, 40), PointToPoint(0, 100),
            SingleSource(60)],
}


def test_mixed_stream_inline_equals_reference_and_serial():
    graphs, jgraphs = _graphs("ws", "lat")
    srv, jsrv, _ = _servers(graphs, jgraphs, config=CFG, lane_width=LANE)
    stream = [(n, q) for qs in zip(MIXED["ws"], MIXED["lat"] + [None])
              for n, q in zip(("ws", "lat"), qs) if q is not None]
    pairs = _submit_both(srv, jsrv, stream)
    srv.drain()
    jsrv.drain()
    for (name, q), (t, jt) in zip(stream, pairs):
        _same_ticket(t, jt, f"{name} {q}")
    assert srv.stats() == jsrv.stats()
    stats = srv.stats()
    assert stats["completed"] == 9 and stats["shed"] == {}
    assert stats["batches"]["solo"] == 1        # the ManyToMany
    for name, g in graphs.items():
        got = [t.result(0) for (n, _), (t, _) in zip(stream, pairs)
               if n == name]
        for q, a, b in zip(MIXED[name], got, _serial(g, MIXED[name])[0]):
            _same_as_serial(a, b, q, g)


def test_threaded_loop_and_concurrent_submitters_equal_reference():
    """The background loop with two submitting threads: every ticket
    resolves, and each tenant's answers are the JAX server's on the same
    per-tenant stream, and the oracle's."""
    graphs, jgraphs = _graphs("ws", "lat")
    per = {"ws": [SingleSource(3), PointToPoint(3, 50), BoundedRadius(3, 25),
                  SingleSource(3), SingleSource(9)],
           "lat": [SingleSource(4), SingleSource(4), PointToPoint(4, 99),
                   SingleSource(17), BoundedRadius(4, 50)]}
    out = {}

    def client(srv, name):
        ts = [srv.submit(q, graph=name) for q in per[name]]
        out[name] = [t.result(timeout=300) for t in ts]

    with Server(graphs, config=CFG, lane_width=LANE, device="cpu") as srv:
        threads = [threading.Thread(target=client, args=(srv, n))
                   for n in per]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    _, jsrv, _ = _servers({}, jgraphs, config=CFG, lane_width=LANE)
    for name, qs in per.items():
        jts = [jsrv.submit(_jq(q), graph=name) for q in qs]
        jsrv.drain()
        for q, got, jt in zip(qs, out[name], jts):
            _same_value(got, jt.result(0), f"{name} {q}")
        dref = dijkstra(graphs[name], qs[0].source)[0]
        np.testing.assert_array_equal(
            out[name][0].dist.numpy().astype(np.int64), dref)
    stats = srv.stats()
    assert stats["completed"] == 10 and stats["queued"] == 0


def test_lru_eviction_and_cache_readmission_equal_reference(tmp_path):
    """``max_resident=2`` over three tenants: the coldest plan is
    evicted, and a re-admitted tenant re-resolves through the tuning
    cache (a fingerprint hit, no measurement) into a plan whose answer
    is bitwise the evicted one's."""
    graphs, jgraphs = _graphs("ws", "lat", "ws2")
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")

    def planted(delta, strat, cap, policy, reps):
        return 1.0e-6 if delta == 10 else 1.0e-3

    for name in graphs:       # each package measures into its own file
        tune(graphs[name], deltas=(5, 10), strategies=("edge",),
             policies=("delta",), measure_fn=planted,
             cache=TuningCache(path), device="cpu")
        jtune(jgraphs[name], deltas=(5, 10), strategies=("edge",),
              policies=("delta",), measure_fn=planted,
              cache=JTuningCache(jpath))
    srv, jsrv, _ = _servers(graphs, jgraphs, config=CFG, lane_width=LANE,
                            max_resident=2,
                            tuning=Tuning(measure=True, cache=path),
                            jtuning=JTuning(measure=True, cache=jpath))
    pairs = []
    for name in ("ws", "lat", "ws", "ws2", "lat"):  # ws2 evicts lat
        pairs += _submit_both(srv, jsrv, [(name, SingleSource(0))])
        srv.drain()
        jsrv.drain()
        assert srv.stats() == jsrv.stats()
    for k, (t, jt) in enumerate(pairs):
        _same_ticket(t, jt, f"request {k}")
    stats = srv.stats()
    assert stats["evictions"] == 2 and stats["plans_built"] == 4
    assert stats["resident"] == ["lat", "ws2"]
    rec = srv.plan("lat").record
    assert rec.source == "cache" and rec.delta == 10
    assert srv.plan("lat").config == CFG
    first, again = pairs[1][0].result(0), pairs[4][0].result(0)  # lat
    assert torch.equal(first.dist, again.dist)
    assert torch.equal(first.pred, again.pred)


def test_admit_overrides_tuning_per_tenant(tmp_path):
    """The port's ``admit(..., tuning=...)``: a tuned tenant (a cache
    hit) beside a pinned one on a server without tuning. The tuned
    tenant answers as the JAX server whose own ``tuning`` is that
    cache; the pinned one keeps its concrete config."""
    graphs, jgraphs = _graphs("ws", "lat")
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")

    def planted(delta, strat, cap, policy, reps):
        return 1.0e-6 if delta == 10 else 1.0e-3

    tune(graphs["ws"], deltas=(5, 10), strategies=("edge",),
         policies=("delta",), measure_fn=planted, cache=TuningCache(path),
         device="cpu")
    jtune(jgraphs["ws"], deltas=(5, 10), strategies=("edge",),
          policies=("delta",), measure_fn=planted, cache=JTuningCache(jpath))
    srv = Server(config=CFG, lane_width=LANE, device="cpu",
                 clock=lambda: 0.0)
    srv.admit("ws", graphs["ws"], tuning=path)
    srv.admit("lat", graphs["lat"], config=DeltaConfig(delta=7))
    _, jsrv, _ = _servers({"ws": jgraphs["ws"]}, {"ws": jgraphs["ws"]},
                          config=CFG, lane_width=LANE, jtuning=jpath)
    stream = [("ws", SingleSource(0)), ("ws", PointToPoint(1, 60))]
    pairs = [(srv.submit(q, graph=n), jsrv.submit(_jq(q), graph=n))
             for n, q in stream]
    t_lat = srv.submit(SingleSource(0), graph="lat")
    srv.drain()
    jsrv.drain()
    for k, (t, jt) in enumerate(pairs):
        _same_ticket(t, jt, f"request {k}")
    assert srv.plan("ws").record.source == "measured"
    assert srv.plan("ws").record.delta == 10
    assert srv.plan("lat").record is None
    assert srv.plan("lat").config == DeltaConfig(delta=7)
    np.testing.assert_array_equal(
        t_lat.result(0).dist.numpy().astype(np.int64),
        dijkstra(graphs["lat"], 0)[0])


def test_queue_full_and_deadline_shedding_equal_reference():
    graphs, jgraphs = _graphs("ws")
    srv, jsrv, now = _servers(graphs, jgraphs, config=CFG, lane_width=LANE,
                              max_queue=4)
    stream = [("ws", SingleSource(i)) for i in range(6)]
    pairs = _submit_both(srv, jsrv, stream)
    shed = [t for t, _ in pairs if t.done()]
    assert len(shed) == 2
    for t in shed:
        assert isinstance(t.exception(0), RequestRejected)
        assert t.exception(0).reason == "queue_full"
        with pytest.raises(RequestRejected, match="queue_full"):
            t.result(0)
    srv.drain()
    jsrv.drain()
    # deadlines: expired while queued -> shed at batch formation
    late = [srv.submit(SingleSource(1), graph="ws", deadline=0.5),
            srv.submit(SingleSource(2), graph="ws", deadline=60.0),
            srv.submit(SingleSource(3), graph="ws")]
    jlate = [jsrv.submit(JSingleSource(1), graph="ws", deadline=0.5),
             jsrv.submit(JSingleSource(2), graph="ws", deadline=60.0),
             jsrv.submit(JSingleSource(3), graph="ws")]
    now[0] = 1.0
    srv.drain()
    jsrv.drain()
    for k, (t, jt) in enumerate(pairs + list(zip(late, jlate))):
        _same_ticket(t, jt, f"request {k}")
    assert late[0].exception(0).reason == "deadline"
    for (_, q), (t, _) in zip(stream, pairs):
        if t.exception(0) is None:    # every accepted request is answered
            np.testing.assert_array_equal(
                t.result(0).dist.numpy().astype(np.int64),
                dijkstra(graphs["ws"], q.source)[0])
    stats = srv.stats()
    assert stats == jsrv.stats()
    assert stats["shed"] == {"deadline": 1, "queue_full": 2}
    assert stats["submitted"] == 9 and stats["completed"] == 6


def test_interleaved_updates_equal_reference_and_serial():
    graphs, jgraphs = _graphs("ws", "lat")
    rng = np.random.default_rng(0)
    program = {}
    for name, g in graphs.items():
        ids = rng.choice(g.n_edges, size=12, replace=False)
        neww = np.clip(g.w.numpy()[ids] + 7, 1, None)
        program[name] = [SingleSource(0), UpdateBatch(ids, neww),
                         SingleSource(0), PointToPoint(0, 50)]
    srv, jsrv, _ = _servers(graphs, jgraphs, config=CFG, lane_width=LANE)
    stream = [(n, q) for qs in zip(program["ws"], program["lat"])
              for n, q in zip(("ws", "lat"), qs)]
    pairs = _submit_both(srv, jsrv, stream)
    srv.drain()
    jsrv.drain()
    for (name, q), (t, jt) in zip(stream, pairs):
        _same_ticket(t, jt, f"{name} {q}")
        if isinstance(q, UpdateBatch):
            # lanes establish no residency: the tier acks the weight swap
            assert t.result(0) == UpdateApplied(n_edges=12)
    assert srv.stats() == jsrv.stats()
    assert srv.stats()["batches"]["update"] == 2
    for name, g in graphs.items():
        got = [t.result(0) for (n, _), (t, _) in zip(stream, pairs)
               if n == name]
        serial, plan = _serial(g, program[name])
        for q, a, b in zip(program[name], got, serial):
            if b is not None:     # path weights on the updated graph
                _same_as_serial(a, b, q, plan.graph)


def test_grid_update_refused_sheds_request_not_loop():
    """A grid-stencil tenant refuses edge-weight updates
    (``UpdateRefused(reason="grid_costs")``): the one update ticket is
    shed as ``update_refused`` and the loop keeps serving the tenant."""
    jg, free = jgen.grid_map(8, 8, seed=0)
    g = _port(jg)
    grid_cfg = DeltaConfig(delta=13, strategy="pallas", interpret=True,
                           pred_mode="none")
    srv, jsrv, _ = _servers({}, {}, lane_width=LANE)
    srv.admit("map", g, config=grid_cfg, free_mask=np.asarray(free))
    jsrv.admit("map", jg, config=JDeltaConfig(
        **dataclasses.asdict(grid_cfg)), free_mask=free)
    stream = [("map", UpdateBatch([0], [5])), ("map", SingleSource(0))]
    pairs = _submit_both(srv, jsrv, stream)
    srv.drain()
    jsrv.drain()
    for k, (t, jt) in enumerate(pairs):
        _same_ticket(t, jt, f"request {k}")
    exc = pairs[0][0].exception(0)
    assert exc.reason == "update_refused" and "grid" in str(exc)
    ref = _serial(g, [SingleSource(0)], grid_cfg, np.asarray(free))[0][0]
    assert torch.equal(pairs[1][0].result(0).dist, ref.dist)
    assert srv.stats() == jsrv.stats()
    assert srv.stats()["shed"] == {"update_refused": 1}
    plan = Engine(g, grid_cfg, free_mask=np.asarray(free),
                  device="cpu").plan()
    with pytest.raises(UpdateRefused, match="grid") as ei:
        plan.update([0], [5])
    assert ei.value.reason == "grid_costs"


def test_invalid_unknown_tenant_and_close_equal_reference():
    graphs, jgraphs = _graphs("ws")
    srv, jsrv, _ = _servers(graphs, jgraphs, config=CFG, lane_width=LANE)
    stream = [("ws", SingleSource(10_000)), ("nope", SingleSource(0)),
              ("ws", PointToPoint(0, 5, mode="astar")),
              ("ws", BoundedRadius(0, -1)), ("ws", SingleSource(0))]
    pairs = _submit_both(srv, jsrv, stream)
    srv.drain()
    jsrv.drain()
    for (name, q), (t, jt) in zip(stream, pairs):
        _same_ticket(t, jt, f"{name} {q}")
    assert [t.exception(0).reason for t, _ in pairs[:4]] == ["invalid"] * 4
    np.testing.assert_array_equal(
        pairs[4][0].result(0).dist.numpy().astype(np.int64),
        dijkstra(graphs["ws"], 0)[0])
    # close without drain: queued and later requests shed as "closed"
    queued = _submit_both(srv, jsrv, [("ws", SingleSource(1))])
    srv.close(drain=False)
    jsrv.close(drain=False)
    after = _submit_both(srv, jsrv, [("ws", SingleSource(2))])
    for t, jt in queued + after:
        _same_ticket(t, jt, "closed")
        assert t.exception(0).reason == "closed"
    assert srv.stats() == jsrv.stats()


def test_landmarks_knob_and_device():
    """``landmarks=`` prepares every tenant plan lazily; an explicit
    landmark mode runs solo and answers as the oracle. ``Server``
    without ``device`` asks for CUDA and raises where there is none."""
    graphs, _ = _graphs("ws")
    g = graphs["ws"]
    with Server(graphs, config=CFG, lane_width=LANE, landmarks=2,
                device="cpu") as srv:
        t1 = srv.submit(PointToPoint(0, 40, mode="alt_bidirectional"),
                        graph="ws")
        t2 = srv.submit(PointToPoint(0, 77), graph="ws")
        r1, r2 = t1.result(timeout=300), t2.result(timeout=300)
    dref = dijkstra(g, 0)[0]
    assert (r1.distance, r2.distance) == (int(dref[40]), int(dref[77]))
    assert _edge_cost(g, r1.path) == r1.distance
    assert srv.stats()["batches"]["solo"] >= 1
    assert srv.plan("ws").landmark_tables.k == 2
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Server(graphs, config=CFG)
    finally:
        torch.cuda.is_available = real


def test_serve_launcher_on_cpu(tmp_path, capsys):
    from repro_torch.launch.serve import main

    main(["--sssp", "--device", "cpu", "--nodes", "300", "--degree", "6",
          "--requests", "6", "--batch", "3", "--tune-cache",
          str(tmp_path / "sv.json")])
    out = capsys.readouterr().out
    assert "record=heuristic" in out
    assert "answered 6 SSSP queries (3 with paths)" in out
