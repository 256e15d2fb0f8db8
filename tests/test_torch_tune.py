"""The port's tuner, tuning cache, ``Engine(graph)``/``tuning=`` and the
deprecated solver shims against the JAX package (``repro.tune``,
``repro.api``, ``repro.core``).

``repro_torch`` runs on the CPU (``device="cpu"``) and ``repro`` as its
own tests run it there, on the graphs of ``tests/test_tuner.py``.
Tolerance: none. The search is compared under the *same injected*
``measure_fn`` (the candidate grid, the order of measurements and the
whole ``TuningRecord``, trials and µs included; the fingerprint is equal
up to ``:dev=``, where the terms must differ). Resolved plans, ``auto``
plans and the shims are compared bitwise (dist, pred, buckets,
inner_iters, overflow). One real measured search runs on the port alone
(≤ 300 vertices, 3 candidates). The JAX programs run in few test items
(one per resolved operating point), so under xdist each compiles on one
worker.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
from repro.api import Engine as JEngine
from repro.api import SingleSource as JSingleSource
from repro.core import DeltaConfig as JDeltaConfig
from repro.core import DeltaSteppingSolver as JDeltaSteppingSolver
from repro.core import delta_stepping as jdelta_stepping
from repro.graphs import generators as jgen
from repro.tune import TuningCache as JTuningCache
from repro.tune import TuningRecord as JTuningRecord
from repro.tune import candidate_configs as jcandidate_configs
from repro.tune import default_policies as jdefault_policies
from repro.tune import default_strategies as jdefault_strategies
from repro.tune import estimate_delta as jestimate_delta
from repro.tune import fingerprint as jfingerprint
from repro.tune import graph_stats as jgraph_stats
from repro.tune import heuristic_record as jheuristic_record
from repro.tune import resolve_record as jresolve_record
from repro.tune import tune as jtune
from repro.tune import tune_p2p as jtune_p2p
from repro_torch.api import Engine, SingleSource, Tuning
from repro_torch.api.engine import _normalize_tuning
from repro_torch.core import (
    DeltaConfig,
    DeltaSteppingSolver,
    EdgeBackend,
    delta_stepping,
    dijkstra,
    make_backend,
)
from repro_torch.graphs import coo_from_numpy
from repro_torch.tune import (
    TuningCache,
    TuningRecord,
    build_safe_solver,
    candidate_configs,
    default_policies,
    default_strategies,
    estimate_delta,
    fingerprint,
    graph_stats,
    heuristic_record,
    resolve_record,
    tune,
    tune_p2p,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _port(jg):
    return coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                          np.asarray(jg.w), jg.n_nodes)


def _ws():
    """The small-world graph of ``tests/test_tuner.py`` in both
    packages."""
    jg = jgen.watts_strogatz(200, 6, 0.05, seed=0)
    return jg, _port(jg)


def _jcfg(cfg: DeltaConfig) -> JDeltaConfig:
    return JDeltaConfig(**dataclasses.asdict(cfg))


def _same_record(ours: TuningRecord, ref: JTuningRecord) -> None:
    """Field by field; the fingerprint up to ``:dev=``, after which the
    terms differ (an empty fingerprint on both sides is equal)."""
    mine, theirs = ours.to_json(), ref.to_json()
    fp, jfp = mine.pop("fingerprint"), theirs.pop("fingerprint")
    assert mine == theirs
    if fp or jfp:
        head, dev = fp.split(":dev=")
        jhead, jdev = jfp.split(":dev=")
        assert head == jhead and dev != jdev and dev == "torch-cpu1"


def _run(result):
    t = result.telemetry
    return (result.dist.numpy(), result.pred.numpy(), int(t.buckets),
            int(t.inner_iters), bool(t.overflow))


def _jrun(result):
    t = result.telemetry
    return (np.asarray(result.dist), np.asarray(result.pred), int(t.buckets),
            int(t.inner_iters), bool(t.overflow))


def _assert_bitwise(ours, ref, tag):
    for name, a, b in zip(("dist", "pred", "buckets", "inner_iters",
                           "overflow"), ours, ref):
        if isinstance(a, np.ndarray):
            assert a.dtype == np.int32 == b.dtype, (tag, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {name}")
        else:
            assert a == b, (tag, name, a, b)


# ---------------------------------------------------------------------------
# estimator, candidate grid, default axes
# ---------------------------------------------------------------------------

AXES = {
    "default": dict(),
    "edge-fused-delta": dict(strategies=("edge", "fused"),
                             policies=("delta",)),
    "deltas-caps": dict(deltas=(2, 5, 11, 23), cap_fractions=(1.0, 0.5, 0.1),
                        strategies=("edge", "ell", "pallas", "fused",
                                    "sharded_edge")),
}


@pytest.mark.parametrize("axes", sorted(AXES))
def test_candidate_configs_equal_reference(axes):
    jg, g = _ws()
    stats, jstats = graph_stats(g), jgraph_stats(jg)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert estimate_delta(stats) == jestimate_delta(jstats)
    ours = candidate_configs(stats, **AXES[axes])
    assert ours == jcandidate_configs(jstats, **AXES[axes])
    assert ours


def test_default_axes_pinned(monkeypatch):
    """Without a process group the strategy axis is the reference's
    single-device one, whatever the number of visible devices: the port
    shards over the ranks of a group, not over devices (the axis of a
    4-rank group is checked in ``tests/test_torch_sharded.py``)."""
    assert default_strategies() == jdefault_strategies() == (
        "edge", "ell", "fused")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert default_strategies() == ("edge", "ell", "fused")
    assert default_policies() == jdefault_policies()


@pytest.mark.parametrize("probe_ecc", [True, False])
def test_heuristic_record_equals_reference(probe_ecc):
    jg, g = _ws()
    base = DeltaConfig(strategy="fused", frontier_cap=64, policy="rho")
    ours = heuristic_record(g, base, graph_stats(g, probe_ecc=probe_ecc),
                            device="cpu")
    ref = jheuristic_record(jg, _jcfg(base),
                            jgraph_stats(jg, probe_ecc=probe_ecc))
    _same_record(ours, ref)
    assert bool(ours.fingerprint) == probe_ecc
    if not probe_ecc:
        with pytest.raises(ValueError):
            fingerprint(graph_stats(g, probe_ecc=False), "cpu")


# ---------------------------------------------------------------------------
# the search under injected costs
# ---------------------------------------------------------------------------

def _planted(delta, strat, cap, policy, reps):
    if (delta, strat, policy) == (5, "ell", "delta"):
        return 1.0e-6                           # planted winner
    return 1.0e-3 * delta


def _policy_winner(delta, strat, cap, policy, reps):
    return 1.0e-6 if (strat, policy) == ("ell", "rho") else 1.0e-3


def _overflow(delta, strat, cap, policy, reps):
    if cap is not None:
        return float("inf") if cap < 200 else 2.0e-3
    return 1.0e-3 * delta


def _all_fail(delta, strat, cap, policy, reps):
    return float("inf")


SEARCHES = {
    "halving": (_planted, dict(deltas=(2, 5, 11, 23))),
    "policy_winner": (_policy_winner, dict(deltas=(5, 10),
                                           strategies=("edge", "ell"))),
    "overflow_rejected": (_overflow, dict(deltas=(2, 5))),
    "all_rejected": (_all_fail, dict(deltas=(2, 5), strategies=("edge",))),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_tune_record_equals_reference(case, tmp_path):
    """Same injected costs → the same measurements in the same order and
    the same record, field by field; the record round-trips through
    each package's cache."""
    jg, g = _ws()
    fn, kw = SEARCHES[case]
    calls, jcalls = [], []

    def ours_fn(*a):
        calls.append(a)
        return fn(*a)

    def ref_fn(*a):
        jcalls.append(a)
        return fn(*a)

    cache = TuningCache(str(tmp_path / "t.json"))
    ours = tune(g, measure_fn=ours_fn, cache=cache, device="cpu", **kw)
    ref = jtune(jg, measure_fn=ref_fn, cache=JTuningCache(None), **kw)
    assert calls == jcalls
    _same_record(ours, ref)
    if case == "halving":
        assert (ours.delta, ours.strategy, ours.policy) == (5, "ell", "delta")
        assert max(c[-1] for c in calls) > 1
    elif case == "policy_winner":
        assert (ours.strategy, ours.policy) == ("ell", "rho")
    elif case == "overflow_rejected":
        assert ours.frontier_cap is None or ours.frontier_cap >= 200
        assert all(t[2] == -1 or t[2] >= 200 for t in ours.trials)
    else:
        assert ours.source == "heuristic"
    if ours.source == "measured":
        assert TuningCache(cache.path).get(ours.fingerprint) == ours
        again = tune(g, measure_fn=ours_fn, cache=cache, device="cpu", **kw)
        assert again == dataclasses.replace(ours, source="cache")


def test_tune_p2p_equals_reference(tmp_path):
    jg = jgen.square_lattice(10, weighted=True, seed=2)
    g = _port(jg)
    costs = {"early_exit": 3.0, "alt": 2.0, "bidirectional": 1.5,
             "alt_bidirectional": 0.5}
    seen, jseen = [], []
    path = str(tmp_path / "tune.json")
    ours = tune_p2p(g, measure_fn=lambda m: seen.append(m) or costs[m],
                    cache=path, device="cpu")
    ref = jtune_p2p(jg, measure_fn=lambda m: jseen.append(m) or costs[m])
    assert seen == jseen
    _same_record(ours, ref)
    assert ours.p2p_mode == "alt_bidirectional"
    assert ours.to_config(DeltaConfig(delta=10)).p2p_mode == \
        "alt_bidirectional"
    assert TuningCache(path).get(ours.fingerprint).p2p_mode == \
        "alt_bidirectional"


def test_measured_tuned_solve_bitwise_equals_explicit(tmp_path):
    """One real measured search (3 candidates) on the port alone; the
    tuned solve equals the explicit config of the winner — policy and
    p2p mode included — bitwise, and the oracle."""
    _, g = _ws()
    rec = tune(g, deltas=(5, 10), strategies=("edge",),
               policies=("delta", "rho"), device="cpu",
               cache=TuningCache(str(tmp_path / "c.json")))
    assert rec.source == "measured" and len(rec.trials) == 3
    assert [t[4] for t in rec.trials] == sorted(t[4] for t in rec.trials)
    tuned = Engine(g, rec.to_config(DeltaConfig()), device="cpu").plan()
    explicit = Engine(g, DeltaConfig(
        delta=rec.delta, strategy=rec.strategy, frontier_cap=rec.frontier_cap,
        policy=rec.policy, p2p_mode=rec.p2p_mode or "early_exit"),
        device="cpu").plan()
    ours = _run(tuned.solve(SingleSource(0)))
    _assert_bitwise(ours, _run(explicit.solve(SingleSource(0))), "tuned")
    np.testing.assert_array_equal(ours[0].astype(np.int64), dijkstra(g, 0)[0])


# ---------------------------------------------------------------------------
# errors: what rejects a candidate and what propagates
# ---------------------------------------------------------------------------

def test_refused_configs_are_rejected_not_raised():
    """A config the plan refuses (the grid stencil under a non-delta
    policy: ``ValueError``) scores ``inf``, as in the reference."""
    from repro.graphs import grid_map as jgrid_map

    jg, free = jgrid_map(6, 7, 0.1, seed=0)
    g = _port(jg)
    rec = tune(g, deltas=(13,), strategies=("pallas",),
               policies=("delta", "rho"), cap_fractions=(1.0,),
               free_mask=np.asarray(free), device="cpu")
    assert rec.source == "measured"
    assert {t[3] for t in rec.trials} == {"delta"}


@pytest.mark.parametrize("where", ["build", "launch"])
def test_kernel_errors_propagate_out_of_tune(monkeypatch, where):
    """The port narrows the reference's ``except Exception``: a backend
    that fails to build, or a kernel that fails to launch, raises out of
    ``tune`` instead of turning into a quietly rejected candidate."""
    import repro_torch.core.backends as backends

    _, g = _ws()

    def broken(*args, **kw):
        raise RuntimeError(f"frontier_relax failed to {where}")

    if where == "build":
        monkeypatch.setattr(backends.FusedBackend, "build", broken)
    else:
        monkeypatch.setattr(backends, "frontier_relax", broken)
    with pytest.raises(RuntimeError, match=f"failed to {where}"):
        tune(g, deltas=(5,), strategies=("edge", "fused"),
             policies=("delta",), device="cpu")


# ---------------------------------------------------------------------------
# the cache: schema, robustness, both packages' files
# ---------------------------------------------------------------------------

def _record(fp="v1:n=10:m=20:deg=1:w=1-5", **kw):
    fields = dict(delta=7, strategy="ell", frontier_cap=128,
                  source="measured", us_per_solve=123.4,
                  trials=((7, "ell", 128, "delta", 123.4),
                          (3, "edge", -1, "rho", 456.7)))
    return TuningRecord(fingerprint=fp, **(fields | kw))


def test_cache_round_trips_and_reads_reference_files(tmp_path):
    """The JSON round-trips; the JAX cache's file loads in the port with
    equal records and the port's loads in the JAX cache (one schema)."""
    recs = [_record(), _record("v5:x", policy="radius", p2p_mode="alt"),
            _record("v5:y", frontier_cap=None, trials=())]
    ours_path, ref_path = str(tmp_path / "port.json"), str(tmp_path / "j.json")
    cache, jcache = TuningCache(ours_path), JTuningCache(ref_path)
    for r in recs:
        cache.put(r)
        jcache.put(JTuningRecord.from_json(r.to_json()))
    cache.save()
    jcache.save()
    with open(ours_path) as f, open(ref_path) as g:
        assert f.read() == g.read()             # byte-identical files
    for path in (ours_path, ref_path):
        loaded, jloaded = TuningCache(path), JTuningCache(path)
        assert len(loaded) == len(jloaded) == 3
        for r in recs:
            assert loaded.get(r.fingerprint) == r
            assert jloaded.get(r.fingerprint).to_json() == r.to_json()
    with open(ours_path) as f:
        assert json.load(f)["version"] == 1
    assert TuningRecord.from_json(recs[2].to_json()) == recs[2]


def test_cache_corrupt_or_stale_is_a_miss(tmp_path):
    mem = TuningCache(None)
    mem.put(_record())
    mem.save()                                  # no-op, must not raise
    assert _record().fingerprint in mem
    path = tmp_path / "broken.json"
    for garbage in ('{"version": 999, "records": {"x": {}}}',
                    '{"version": 1, "records"', "not json at all",
                    '{"version": 1, "records": {"x": {"delta": "?"}}}'):
        path.write_text(garbage)
        cache = TuningCache(str(path))
        assert len(cache) == 0 == len(JTuningCache(str(path)))
        cache.put(_record())
        cache.save()                            # and writable again
        assert len(TuningCache(str(path))) == 1


def test_record_json_tolerates_pre_policy_records():
    d = _record().to_json()
    del d["policy"]
    d["trials"] = [[7, "ell", 128, 123.4]]      # legacy row shape
    ours, ref = TuningRecord.from_json(d), JTuningRecord.from_json(d)
    assert ours.to_json() == ref.to_json()
    assert ours.policy == "delta"
    assert ours.trials == ((7, "ell", 128, "delta", 123.4),)


def test_reference_record_never_hits_port_fingerprint(tmp_path):
    """A record the JAX package measured (its fingerprint ends in a JAX
    device count) sits in the shared file and is never served to the
    port: the port resolves the estimator's Δ instead."""
    jg, g = _ws()
    path = str(tmp_path / "shared.json")
    jcache = JTuningCache(path)
    jcache.put(JTuningRecord(
        fingerprint=jfingerprint(jgraph_stats(jg)), delta=999,
        strategy="ell", frontier_cap=None, source="measured"))
    jcache.save()
    cfg, rec = resolve_record(g, cache_path=path, device="cpu")
    assert rec.source == "heuristic" and cfg.delta == estimate_delta(
        graph_stats(g))
    assert TuningCache(path).get(rec.fingerprint) is None
    jcfg, jrec = jresolve_record(jg, cache_path=path)
    assert jcfg.delta == 999                    # the reference's own hit


# ---------------------------------------------------------------------------
# resolution paths: the resolved plan bitwise the JAX plan
# ---------------------------------------------------------------------------

RESOLVE = ("cache_hit", "heuristic", "cap_dropped_on_overflow",
           "cap_dropped_sources_none")


@pytest.mark.parametrize("case", RESOLVE)
def test_resolve_record_paths_equal_reference(case, tmp_path):
    jg, g = _ws()
    stats, jstats = graph_stats(g), jgraph_stats(jg)
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    kw = dict(sources=(0,))
    if case == "heuristic":
        kw = dict()
        path = jpath = None
    else:
        if case == "cache_hit":
            fields = dict(delta=4, strategy="edge", frontier_cap=None)
        else:                                   # a cap the graph overflows
            fields = dict(delta=100, strategy="ell", frontier_cap=2)
        cache, jcache = TuningCache(path), JTuningCache(jpath)
        cache.put(TuningRecord(fingerprint=fingerprint(stats, CPU),
                               source="measured", **fields))
        jcache.put(JTuningRecord(fingerprint=jfingerprint(jstats),
                                 source="measured", **fields))
        cache.save()
        jcache.save()
        if case == "cap_dropped_sources_none":
            kw = dict(sources=None)
    cfg, rec = resolve_record(g, cache_path=path, device="cpu", **kw)
    jcfg, jrec = jresolve_record(jg, cache_path=jpath, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _same_record(rec, jrec)
    if case == "heuristic":
        assert rec.fingerprint == "" and cfg.delta == estimate_delta(stats)
    elif case == "cache_hit":
        assert (cfg.delta, rec.source) == (4, "measured")
    else:
        assert cfg.frontier_cap is None and rec.frontier_cap == 2
    ours = Engine(g, cfg, device="cpu").plan().solve(SingleSource(0))
    ref = JEngine(jg, jcfg).plan().solve(JSingleSource(0))
    _assert_bitwise(_run(ours), _jrun(ref), case)
    np.testing.assert_array_equal(ours.dist.numpy().astype(np.int64),
                                  dijkstra(g, 0)[0])


def test_build_safe_solver_keeps_a_cap_that_fits():
    _, g = _ws()
    cfg = DeltaConfig(delta=5, strategy="fused", frontier_cap=200)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        out, solver = build_safe_solver(g, cfg, sources=(0, 7), device="cpu")
    assert out == cfg
    assert not bool(solver.solve(7).overflow)


# ---------------------------------------------------------------------------
# Engine(graph) / tuning= / the shims
# ---------------------------------------------------------------------------

def test_engine_tuning_spellings_and_deprecations(tmp_path):
    """Every ``tuning=`` spelling resolves as the reference's does; the
    legacy knobs warn and resolve to the same plan."""
    jg, g = _ws()
    new = Engine(g, device="cpu").plan()
    ref = JEngine(jg).plan()
    assert dataclasses.asdict(new.config) == dataclasses.asdict(ref.config)
    _same_record(new.record, ref.record)
    assert new.explain()["tuning_source"] == "heuristic"
    assert Engine(g, tuning="auto", device="cpu").plan().config == new.config
    with pytest.deprecated_call(match="config='auto' is deprecated"):
        old = Engine(g, "auto", device="cpu").plan()
    assert old.config == new.config and old.record == new.record

    cache = str(tmp_path / "t.json")
    with pytest.deprecated_call(match="tune=/tune_cache= are deprecated"):
        old = Engine(g, tune=True, tune_cache=cache,
                     device="cpu").plan(sources=(0,))
    assert old.record.source == "measured"
    new = Engine(g, tuning=Tuning(measure=True, cache=cache),
                 device="cpu").plan(sources=(0,))
    assert new.record.source == "cache" and old.config == new.config
    hit = Engine(g, tuning=cache, device="cpu").plan(sources=(0,))
    assert hit.record == old.record and hit.config == old.config
    concrete = Engine(g, DeltaConfig(delta=3), device="cpu").plan()
    assert concrete.record is None
    assert concrete.explain()["tuning_source"] is None

    assert _normalize_tuning("measure") == Tuning(measure=True)
    assert _normalize_tuning("some/path.json") == Tuning(
        cache="some/path.json")
    with pytest.raises(ValueError, match="tuning must be"):
        Engine(g, tuning=3.14, device="cpu")
    with pytest.raises(ValueError, match="unknown config string"):
        Engine(g, "fastest", device="cpu")


def test_engine_tuning_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g = _ws()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune(g, measure_fn=_planted)


def test_make_backend_accepts_auto():
    _, g = _ws()
    backend = make_backend(g, "auto")
    assert isinstance(backend, EdgeBackend)
    assert backend.delta == estimate_delta(graph_stats(g))
    with pytest.raises(ValueError):
        make_backend(g, "bogus")
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        DeltaSteppingSolver(g, "bogus", device="cpu")


def test_record_survives_update_and_radii_beside_cache(tmp_path):
    """The record stays attached through ``update`` (the fingerprint
    keys on structure and the weight range), and radius-stepping's radii
    persist in ``<cache>.radii`` under the reference's file names."""
    jg, g = _ws()
    cache = str(tmp_path / "port.json")
    jcache = str(tmp_path / "jax.json")
    base = DeltaConfig(policy="radius")
    plan = Engine(g, base, tuning=cache, device="cpu").plan()
    JEngine(jg, _jcfg(base), tuning=jcache).plan()
    files = sorted(p.name for p in (tmp_path / "port.json.radii").iterdir())
    assert files and files == sorted(
        p.name for p in (tmp_path / "jax.json.radii").iterdir())
    record = plan.record
    assert record.source == "heuristic" and plan.config.policy == "radius"
    plan.solve(SingleSource(0))
    plan.update([0, 1], [3, 4])
    assert plan.record is record
    assert plan.explain()["tuning_source"] == "heuristic"
    res = plan.resolve()
    g2 = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                        plan.graph.w.numpy(), jg.n_nodes)
    np.testing.assert_array_equal(res.dist.numpy().astype(np.int64),
                                  dijkstra(g2, 0)[0])


def test_solver_shims_bitwise_reference():
    """``DeltaSteppingSolver`` (``config="auto"``, ``solve`` and
    ``solve_many``) and ``delta_stepping`` warn as the reference's and
    answer bitwise as the JAX shims do."""
    jg, g = _ws()
    with pytest.deprecated_call(match="DeltaSteppingSolver is deprecated"):
        solver = DeltaSteppingSolver(g, "auto", device="cpu")
    with pytest.warns(DeprecationWarning):
        jsolver = JDeltaSteppingSolver(jg, "auto")
    assert dataclasses.asdict(solver.config) == dataclasses.asdict(
        jsolver.config)
    assert solver.plan.explain()["tuning_source"] == "heuristic"
    for s in (0, 7):
        r, jr = solver.solve(s), jsolver.solve(s)
        _assert_bitwise((r.dist.numpy(), r.pred.numpy(), int(r.outer_iters),
                         int(r.inner_iters), bool(r.overflow)),
                        tuple(np.asarray(x) if i < 2 else x.item()
                              for i, x in enumerate(jr)), f"solve({s})")
    many, jmany = solver.solve_many([0, 3, 7]), jsolver.solve_many(
        np.asarray([0, 3, 7], np.int32))
    for a, b in zip(many, jmany):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.deprecated_call(match="delta_stepping is deprecated"):
        one = delta_stepping(g, 7, "auto", device="cpu")
    with pytest.warns(DeprecationWarning):
        jone = jdelta_stepping(jg, 7, "auto")
    for a, b in zip(one, jone):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.warns(DeprecationWarning):
        pinned = DeltaSteppingSolver(g, DeltaConfig(delta=5), device="cpu")
    assert pinned.config == DeltaConfig(delta=5)


def test_launcher_tune_and_tune_cache_on_cpu(tmp_path, capsys):
    """``--tune --tune-cache`` measures and persists; ``--tune-cache``
    alone then resolves the stored record without a search, and both
    runs verify against Dijkstra."""
    from repro_torch.launch.sssp import main

    path = str(tmp_path / "tc.json")
    args = ["--nodes", "300", "--degree", "6", "--device", "cpu",
            "--verify", "--tune-cache", path]
    main(args + ["--tune"])
    first = capsys.readouterr().out
    main(args)
    again = capsys.readouterr().out
    for out in (first, again):
        assert "record=measured" in out and "verify vs Dijkstra: OK" in out
    point = [line.split(" record=")[0] for line in (first + again).splitlines()
             if line.startswith("[sssp] tuned config")]
    assert len(point) == 2 and point[0] == point[1]
    assert len(TuningCache(path)) == 1
