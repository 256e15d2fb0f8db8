"""The port's game-map path against the JAX package, bitwise.

Inputs come from fixed numpy seeds and go through the JAX function and
its counterpart in the port (``device="cpu"``: the kernels' plain
twins); every output is an integer array or counter and must be equal
(tolerance 0):

* the ``grid_relax`` twin against JAX ``grid_relax`` (Pallas in
  interpret mode, ``block_rows=8``) and JAX ``grid_relax_ref``, over
  shapes that are not tile multiples, both phases and Δ ∈ {5, 13, 20}
  (both, one or neither move class on), with INF cells, blocked cells
  and values within 14 of INF in the swept bucket (the int32 wrap);
* ``GridDeltaSolver``: dist, ``outer_iters``, ``inner_iters``;
* ``Engine(g, DeltaConfig(delta=13, strategy="pallas"),
  free_mask=free)`` for ``SingleSource``, ``PointToPoint`` and
  ``BoundedRadius`` in pred modes none and argmin, on the JAX tests'
  map and on a map with a walled-off region;
* the ``stop`` hook of both loops of ``_run_backend``: point-to-point
  and bounded queries through every sparse strategy;
* the reference's refusals, with the reference's exception types;
* the launcher's game-map path end to end with ``--verify``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import BoundedRadius as JBoundedRadius
from repro.api import Engine as JEngine
from repro.api import PointToPoint as JPointToPoint
from repro.api import SingleSource as JSingleSource
from repro.api import UpdateRefused as JUpdateRefused
from repro.compat import enable_x64
from repro.core import DeltaConfig as JDeltaConfig
from repro.core.grid import GridDeltaConfig as JGridDeltaConfig
from repro.core.grid import GridDeltaSolver as JGridDeltaSolver
from repro.graphs import generators as jgen
from repro.graphs.structures import COOGraph as JCOOGraph
from repro.kernels.grid_relax import grid_relax as j_grid_relax
from repro.kernels.grid_relax import grid_relax_ref as j_grid_relax_ref
from repro_torch.api import (
    BoundedRadius,
    Engine,
    PointToPoint,
    SingleSource,
    UpdateBatch,
    UpdateRefused,
)
from repro_torch.core import (
    DeltaConfig,
    GridDeltaConfig,
    GridDeltaSolver,
    GridPallasBackend,
    dijkstra,
)
from repro_torch.graphs import coo_from_numpy, grid_map
from repro_torch.kernels.grid_relax import grid_relax, grid_relax_ref

INF = 2**31 - 1
COSTS = dict(cost_straight=10, cost_diag=14)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    # leave no compiled executables behind for the modules that follow
    jax.clear_caches()
    yield
    jax.clear_caches()


# ---------------------------------------------------------------- kernel twin
@pytest.mark.parametrize("delta", [5, 13, 20])
@pytest.mark.parametrize("light", [True, False])
@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (20, 33), (37, 129)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_relax_twin_matches_reference(shape, light, delta):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] * 10 + delta)
    tent = rng.integers(0, 60, size=shape).astype(np.int64)
    tent[rng.random(shape) < 0.3] = INF
    near = rng.random(shape) < 0.15
    tent[near] = INF - rng.integers(1, 15, size=int(near.sum()))
    tent = tent.astype(np.int32)
    free = rng.random(shape) >= 0.2
    print(f"shape={shape} light={light} delta={delta}\ntent=\n{tent}\n"
          f"free=\n{free.astype(int)}")
    t_t, f_t = torch.from_numpy(tent), torch.from_numpy(free)
    # a low bucket, and the bucket of the values within 14 of INF, whose
    # candidates wrap past INT32_MAX as they do on the TPU
    for i in (2, (INF - 8) // delta):
        kw = dict(delta=delta, light=light, **COSTS)
        twin = grid_relax_ref(t_t, f_t, i, **kw)
        assert twin.dtype == torch.int32 and twin.shape == shape
        assert torch.equal(grid_relax(t_t, f_t, i, **kw), twin)
        j_ref = j_grid_relax_ref(jnp.asarray(tent), jnp.asarray(free), i,
                                 **kw)
        j_pal = j_grid_relax(jnp.asarray(tent), jnp.asarray(free), i,
                             backend="pallas", interpret=True, block_rows=8,
                             **kw)
        np.testing.assert_array_equal(twin.numpy(), np.asarray(j_ref))
        np.testing.assert_array_equal(twin.numpy(), np.asarray(j_pal))


# ------------------------------------------------------------- grid solver
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_grid_solver_matches_reference(backend):
    h, w = 20, 33
    jg, free = jgen.grid_map(h, w, 0.15, seed=21)
    src = int(np.flatnonzero(free.ravel())[0])
    jres = JGridDeltaSolver(free, JGridDeltaConfig(
        backend=backend, interpret=(backend == "pallas"),
        block_rows=8)).solve((src // w, src % w))
    res = GridDeltaSolver(free, GridDeltaConfig(backend=backend),
                          device="cpu").solve((src // w, src % w))
    assert res.dist.dtype == torch.int32 and res.dist.shape == (h, w)
    np.testing.assert_array_equal(res.dist.numpy(), np.asarray(jres.dist))
    assert (res.outer_iters, res.inner_iters) == (int(jres.outer_iters),
                                                  int(jres.inner_iters))
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    dref, _ = dijkstra(g, src)
    np.testing.assert_array_equal(res.dist.numpy().ravel().astype(np.int64),
                                  dref)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_grid_solver_sweeps_through_dispatcher(backend, monkeypatch):
    """Every sweep of ``GridDeltaSolver`` goes through the device
    dispatcher whatever ``backend`` says, so a CUDA tensor reaches the
    hand-written kernel (here, on the CPU, the dispatcher's twin)."""
    import repro_torch.core.grid as grid_mod
    calls = []
    real = grid_mod.grid_relax

    def counting(*args, **kw):
        calls.append(kw["light"])
        return real(*args, **kw)

    monkeypatch.setattr(grid_mod, "grid_relax", counting)
    _, free = grid_map(12, 17, 0.15, seed=4)
    src = int(np.flatnonzero(free.ravel())[0])
    res = GridDeltaSolver(free, GridDeltaConfig(backend=backend),
                          device="cpu").solve((src // 17, src % 17))
    assert len(calls) == res.outer_iters + res.inner_iters
    assert calls.count(False) == res.outer_iters


# ---------------------------------------------------------- the grid slice
def _grid_graph(free):
    """8-neighbour COO edges between free cells (``grid_map``'s
    construction) for an arbitrary occupancy mask."""
    h, w = free.shape
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    srcs, dsts, ws = [], [], []
    for dr, dc, cost in ((-1, 0, 10), (1, 0, 10), (0, -1, 10), (0, 1, 10),
                         (-1, -1, 14), (-1, 1, 14), (1, -1, 14), (1, 1, 14)):
        rs = slice(max(0, -dr), h - max(0, dr))
        cs = slice(max(0, -dc), w - max(0, dc))
        rs2 = slice(max(0, dr), h + min(0, dr))
        cs2 = slice(max(0, dc), w + min(0, dc))
        ok = free[rs, cs] & free[rs2, cs2]
        srcs.append(idx[rs, cs][ok])
        dsts.append(idx[rs2, cs2][ok])
        ws.append(np.full(int(ok.sum()), cost, np.int32))
    return JCOOGraph(np.concatenate(srcs).astype(np.int32),
                     np.concatenate(dsts).astype(np.int32),
                     np.concatenate(ws), h * w)


def _map(name):
    """(JAX graph, free mask, source, p2p targets by role)."""
    if name == "jax_tests":
        jg, free = jgen.grid_map(25, 31, 0.15, seed=3)
    else:                      # column 20 walled off: cells right of it
        rng = np.random.default_rng(5)
        free = rng.random((22, 30)) >= 0.1
        free[:, 20] = False
        jg = _grid_graph(free)
    flat = free.ravel()
    src = int(np.flatnonzero(flat)[0])
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    dref, _ = dijkstra(g, src)
    reach = np.flatnonzero(dref < INF)
    targets = {"near": int(reach[np.argsort(dref[reach])[3]]),
               "far": int(reach[np.argmax(dref[reach])]),
               "blocked": int(np.flatnonzero(~flat)[0])}
    unreached = np.flatnonzero((dref >= INF) & flat)
    if unreached.size:
        targets["unreachable"] = int(unreached[-1])
    return jg, free, src, targets


MAPS = ("jax_tests", "walled")


def _telemetry(t):
    return int(t.buckets), int(t.inner_iters), bool(t.overflow)


def _check_arrays(ours, ref, tag):
    for name, a, b in zip(("dist", "pred"), ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.int32 and b.dtype == np.int32, (tag, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {name}")


def _queries(kind, src, targets):
    if kind == "single":
        return [("single", SingleSource(src), JSingleSource(src))]
    if kind == "p2p":
        return [(role, PointToPoint(src, t), JPointToPoint(src, t))
                for role, t in targets.items()]
    return [(f"r={r}", BoundedRadius(src, r), JBoundedRadius(src, r))
            for r in (0, 57, 200)]


def _compare(ours, ref, tag):
    if hasattr(ref, "distance"):
        assert ours.distance == ref.distance, tag
        assert ours.path == ref.path, tag
    else:
        _check_arrays((ours.dist, ours.pred), (ref.dist, ref.pred), tag)
    assert _telemetry(ours.telemetry) == _telemetry(ref.telemetry), tag


@pytest.mark.parametrize("kind", ["single", "p2p", "bounded"])
@pytest.mark.parametrize("pred_mode", ["none", "argmin"])
@pytest.mark.parametrize("name", MAPS)
def test_grid_engine_matches_reference(name, pred_mode, kind):
    jg, free, src, targets = _map(name)
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    cfg = dict(delta=13, strategy="pallas", pred_mode=pred_mode)
    plan = Engine(g, DeltaConfig(**cfg), free_mask=free, device="cpu").plan()
    assert isinstance(plan.backend, GridPallasBackend)
    jplan = JEngine(jg, JDeltaConfig(interpret=True, **cfg),
                    free_mask=free).plan()
    if kind == "p2p" and name == "walled":
        assert "unreachable" in targets
    for role, q, jq in _queries(kind, src, targets):
        tag = (name, pred_mode, role)
        ours = plan.solve(q)
        _compare(ours, jplan.solve(jq), tag)
        tel = ours.telemetry
        assert plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1, tag
        if role == "unreachable":
            assert ours.distance == INF and ours.path is None, tag
        if role == "far" and pred_mode == "argmin":
            assert ours.path[0] == src and ours.path[-1] == q.target, tag


@pytest.mark.parametrize("kind", ["p2p", "bounded"])
@pytest.mark.parametrize("strategy", ["edge", "ell", "pallas", "fused"])
def test_stop_hook_on_sparse_strategies_matches_reference(strategy, kind):
    jg = jgen.watts_strogatz(60, 4, 0.2, seed=4)
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    cfg = dict(delta=7, strategy=strategy, pred_mode="argmin")
    plan = Engine(g, DeltaConfig(**cfg), device="cpu").plan()
    jplan = JEngine(jg, JDeltaConfig(interpret=True, **cfg)).plan()
    dref, _ = dijkstra(g, 1)
    order = np.argsort(dref, kind="stable")
    targets = {"self": 1, "near": int(order[4]), "far": int(order[-1])}
    full = plan.solve(SingleSource(1)).telemetry.buckets
    for role, q, jq in _queries(kind, 1, targets):
        ours = plan.solve(q)
        _compare(ours, jplan.solve(jq), (strategy, role))
        tel = ours.telemetry
        assert plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1
        if role in ("self", "near", "r=0"):
            assert tel.buckets < full, (strategy, role)   # it stopped early
        if kind == "p2p":
            assert ours.distance == int(dref[q.target])


@pytest.mark.parametrize("strategy", ["edge", "fused", "grid"])
def test_stop_before_bucket_zero_matches_reference(strategy):
    """A predicate that holds at ``next_bucket = 0`` stops the loop
    before bucket 0 (the reference's first ``outer_cond`` check): the
    cold state, zero counters, in both loops of ``_run_backend``."""
    from repro.core.backends import make_backend as j_make_backend
    from repro.core.delta_stepping import _run_backend as j_run_backend
    from repro_torch.core.backends import make_backend
    from repro_torch.core.delta_stepping import _run_backend

    if strategy == "grid":
        jg, free = jgen.grid_map(6, 7, 0.1, seed=1)
        cfg = dict(delta=13, strategy="pallas")
    else:
        jg, free = jgen.watts_strogatz(30, 4, 0.2, seed=2), None
        cfg = dict(delta=7, strategy=strategy)
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    backend = make_backend(g, DeltaConfig(**cfg), free_mask=free)
    jbackend = j_make_backend(jg, JDeltaConfig(interpret=True, **cfg),
                              free_mask=free)
    out = _run_backend(backend, 0, n=g.n_nodes, packed=False, device="cpu",
                       stop=lambda tent, explored, nxt: nxt >= 0)
    jtent, jouter, jinner, jover = j_run_backend(
        jbackend, jnp.int32(0), n=g.n_nodes, packed=False,
        stop=lambda tent, explored, nxt: nxt >= 0)
    np.testing.assert_array_equal(out.tent.numpy(), np.asarray(jtent))
    assert (out.outer_iters, out.inner_iters, out.overflow) == (
        int(jouter), int(jinner), bool(jover)) == (0, 0, False)


# ---------------------------------------------------------------- refusals
def _both_raise(exc, ours, ref):
    with pytest.raises(exc):
        ours()
    with pytest.raises(exc):
        ref()


def test_grid_refusals_match_reference():
    jg, free = jgen.grid_map(8, 9, 0.2, seed=0)
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)

    def pair(free_mask=free, **cfg):
        cfg = dict(dict(delta=13, strategy="pallas"), **cfg)
        return (lambda: Engine(g, DeltaConfig(**cfg), free_mask=free_mask,
                               device="cpu").plan(),
                lambda: JEngine(jg, JDeltaConfig(interpret=True, **cfg),
                                free_mask=free_mask).plan())

    with enable_x64():              # the reference checks x64 first
        _both_raise(ValueError, *pair(pred_mode="packed"))
    _both_raise(ValueError, *pair(free_mask=np.ones((9, 9), bool)))
    _both_raise(ValueError, *pair(free_mask=free.ravel()))
    _both_raise(ValueError, *pair(policy="rho"))
    plan, jplan = (make() for make in pair())
    for p, exc in ((plan, UpdateRefused), (jplan, JUpdateRefused)):
        with pytest.raises(exc) as info:
            p.update([0], [5])
        assert info.value.reason == "grid_costs"
    with pytest.raises(UpdateRefused, match="grid_costs"):
        plan.solve(UpdateBatch([0], [5]))
    # other strategies ignore the mask, as in the reference, and take
    # weight updates
    edge = Engine(g, DeltaConfig(delta=13), free_mask=free,
                  device="cpu").plan()
    assert not isinstance(edge.backend, GridPallasBackend)
    assert edge.update([0], [5]) is edge
    assert int(edge.graph.w[0]) == 5


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("extra", [[], ["--target", "850"]],
                         ids=["single", "target"])
def test_launcher_gamemap_on_cpu_with_verify(capsys, extra):
    from repro_torch.launch.sssp import main
    main(["--graph", "gamemap", "--nodes", "900", "--strategy", "pallas",
          "--device", "cpu", "--verify", *extra])
    out = capsys.readouterr().out
    assert "verify vs Dijkstra: OK" in out
    if extra:
        assert "p2p 0->850" in out


def test_grid_map_source_is_free_and_twin_path_is_cpu():
    _, free = grid_map(30, 30, 0.1, seed=0)
    assert free.ravel()[0]          # the launcher's source 0 is a free cell
    t = torch.zeros((2, 3), dtype=torch.int32)
    f = torch.ones((2, 3), dtype=torch.bool)
    assert grid_relax(t, f, 0, light=True).device.type == "cpu"
