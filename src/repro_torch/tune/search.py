"""Empirical (Δ, strategy, frontier cap, policy) tuner of the PyTorch
port (counterpart of ``repro.tune.search``, DESIGN.md §7).

The search space, the successive-halving loop, the record and its JSON
form are the reference's, line for line: a geometric Δ grid centred on
``estimator.estimate_delta``, the relaxation strategy, the compaction
capacity of the ELL-family strategies (full |V| or a fraction;
candidates whose probe solve overflows are rejected, never returned)
and the frontier policy. Every surviving candidate is timed with one
solve after a warm-up, the slower half is dropped, the repetitions
double, until one remains.

Every entry point takes ``device`` (default: CUDA, or raise; ``"cpu"``
runs the kernels' twins), and the same device goes to every candidate's
plan and to ``fingerprint(stats, device)``, so a record measured on one
kind of hardware never keys another. A timed solve ends in
``torch.cuda.synchronize`` on CUDA.

Where the port differs from the reference: ``_candidate_solver``
rejects a candidate only when its probe solve overflows or when its
plan refuses the config (``ValueError`` / ``NotImplementedError``, e.g.
a grid plan under a non-delta policy).
Any other error — a kernel that fails to build or launch, a CUDA error
— propagates out of ``tune``: the reference scores such a candidate as
``inf`` and may fall back to the heuristic record, which would hide a
broken kernel behind a quietly rejected candidate.

In a process group of more than one rank (one process per GPU) the
sharded strategies join the strategy axis, every rank runs the same
search, and each candidate's time is the maximum over the ranks
(``all_reduce(MAX)``) before ranking, so every rank keeps the same
survivors and the same record (a rank that picked another winner would
hang the next collective). Only rank 0 writes the cache file.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.backends import all_reduce, group_size, resolve_n_shards
from repro_torch.core.delta_stepping import DeltaConfig, DeltaSteppingSolver
from repro_torch.device import resolve_device
from repro_torch.graphs.structures import COOGraph
from repro_torch.tune.estimator import (
    GraphStats,
    estimate_delta,
    fingerprint,
    graph_stats,
)

# Δ grid: estimate × these factors (deduplicated, floored at 1).
_DELTA_FACTORS = (0.25, 0.5, 1.0, 2.0, 4.0)

# Frontier packing: compaction capacity as a fraction of |V| (ELL-family
# strategies only; 1.0 is the always-safe full-width buffer).
_CAP_FRACTIONS = (1.0, 0.25)

_MIN_CAP = 32


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One tuned operating point for one graph fingerprint — the
    reference's record field for field, with the same JSON form.

    ``source`` is ``'heuristic'`` (estimator only), ``'measured'``
    (successive-halving search) or ``'cache'`` (loaded from a
    ``TuningCache``). ``trials`` keeps the latest measurement of every
    viable candidate as ``(Δ, strategy, cap or -1, policy, µs)``,
    fastest first."""

    fingerprint: str
    delta: int
    strategy: str
    frontier_cap: Optional[int]
    source: str
    us_per_solve: Optional[float] = None
    trials: Tuple[Tuple[int, str, int, str, float], ...] = ()
    n_shards: Optional[int] = None
    # the measured point-to-point mode of tune_p2p; None = never measured
    p2p_mode: Optional[str] = None
    # records predating the policy axis deserialize as 'delta'
    policy: str = "delta"

    def to_config(self, base: Optional[DeltaConfig] = None) -> DeltaConfig:
        """Concrete engine config: the tuned fields over the caller's
        base for everything else (pred_mode, ...)."""
        base = base if base is not None else DeltaConfig()
        return dataclasses.replace(
            base,
            delta=self.delta,
            strategy=self.strategy,
            frontier_cap=self.frontier_cap,
            n_shards=self.n_shards if self.n_shards is not None else base.n_shards,
            p2p_mode=self.p2p_mode if self.p2p_mode is not None else base.p2p_mode,
            policy=self.policy,
        )

    def to_json(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "delta": self.delta,
            "strategy": self.strategy,
            "frontier_cap": self.frontier_cap,
            "source": self.source,
            "us_per_solve": self.us_per_solve,
            "trials": [list(t) for t in self.trials],
            "n_shards": self.n_shards,
            "p2p_mode": self.p2p_mode,
            "policy": self.policy,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TuningRecord":
        def trial(row):
            # pre-policy records carried (Δ, strategy, cap, µs) rows
            if len(row) == 4:
                a, b, c, t = row
                p = "delta"
            else:
                a, b, c, p, t = row
            return (int(a), str(b), int(c), str(p), float(t))

        return cls(
            fingerprint=d["fingerprint"],
            delta=int(d["delta"]),
            strategy=d["strategy"],
            frontier_cap=(
                None if d.get("frontier_cap") is None else int(d["frontier_cap"])
            ),
            source=d.get("source", "cache"),
            us_per_solve=d.get("us_per_solve"),
            trials=tuple(trial(row) for row in d.get("trials", [])),
            n_shards=(None if d.get("n_shards") is None else int(d["n_shards"])),
            p2p_mode=d.get("p2p_mode"),
            policy=str(d.get("policy", "delta")),
        )


def heuristic_record(
    graph: COOGraph,
    base: Optional[DeltaConfig] = None,
    stats: Optional[GraphStats] = None,
    *,
    device=None,
) -> TuningRecord:
    """Zero-measurement record: estimator Δ, base strategy/packing.
    ``fingerprint`` is empty when the stats skipped the hop-radius probe
    (nothing to key a cache with)."""
    dev = resolve_device(device)
    base = base if base is not None else DeltaConfig()
    stats = stats if stats is not None else graph_stats(graph)
    return TuningRecord(
        fingerprint=fingerprint(stats, dev) if stats.ecc0 >= 0 else "",
        delta=estimate_delta(stats),
        strategy=base.strategy,
        frontier_cap=base.frontier_cap,
        source="heuristic",
        policy=base.policy,
    )


def default_strategies() -> Tuple[str, ...]:
    """The tuner's default strategy axis: the single-device strategies
    always, plus the sharded ones in a process group of more than one
    rank (the reference adds them where it sees more than one device);
    the group's size is pinned by the fingerprint's ``:dev=`` term."""
    if group_size() > 1:
        return ("edge", "ell", "fused", "sharded_edge", "sharded_ell",
                "sharded_fused")
    return ("edge", "ell", "fused")


def default_policies() -> Tuple[str, ...]:
    """The tuner's algorithm axis (DESIGN.md §15): every frontier policy
    competes — each one is exact, so the axis only ever moves time."""
    return ("delta", "rho", "radius")


def candidate_configs(
    stats: GraphStats,
    strategies: Optional[Sequence[str]] = None,
    deltas: Optional[Sequence[int]] = None,
    cap_fractions: Sequence[float] = _CAP_FRACTIONS,
    policies: Optional[Sequence[str]] = None,
) -> list:
    """The (Δ, strategy, frontier_cap, policy) grid the tuner searches,
    in the reference's order. ``edge`` ignores packing (one candidate
    per Δ); the ELL-family strategies get one per cap fraction; the
    sharded strategies one per Δ at full width. The non-delta policies
    enter at the single central Δ of the grid."""
    if strategies is None:
        strategies = default_strategies()
    if deltas is None:
        est = estimate_delta(stats)
        deltas = sorted({max(1, int(round(est * f))) for f in _DELTA_FACTORS})
    if policies is None:
        policies = default_policies()
    n = stats.n_nodes
    out = []
    for policy in policies:
        pol_deltas = (
            deltas if policy == "delta"
            else [sorted(deltas)[len(deltas) // 2]]
        )
        for delta in pol_deltas:
            for strat in strategies:
                if strat in ("ell", "pallas", "fused"):
                    for frac in cap_fractions:
                        cap = (None if frac >= 1.0
                               else max(_MIN_CAP, int(n * frac)))
                        out.append((delta, strat, cap, policy))
                else:
                    out.append((delta, strat, None, policy))
    return out


def _solver_no_warn(graph, cfg, device, free_mask=None):
    """The tuner measures through the deprecated solver shape (one warm
    object per candidate), without surfacing its DeprecationWarning to
    callers of the supported entry points."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return DeltaSteppingSolver(graph, cfg, free_mask=free_mask,
                                   device=device)


def _candidate_solver(graph, cfg, sources, device, free_mask=None):
    """Build, warm up and validate one candidate's solver; ``None`` when
    its plan refuses the config or a probe solve overflows (an
    overflowed run is a wrong-answer run; its time never competes).
    Every other error propagates (module note)."""
    try:
        solver = _solver_no_warn(graph, cfg, device, free_mask=free_mask)
    except (ValueError, NotImplementedError):
        return None
    for s in sources:  # warm up (kernel build) + validate every source
        if bool(solver.solve(int(s)).overflow):
            return None
    return solver


def _time_solver(solver, sources, reps: int, device) -> float:
    """Median seconds per solve on an already-warm solver, each solve
    ended by a device synchronisation."""
    times = []
    for _ in range(reps):
        for s in sources:
            t0 = time.perf_counter()
            solver.solve(int(s))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def build_safe_solver(
    graph: COOGraph,
    cfg: DeltaConfig,
    *,
    sources: Sequence[int] = (0,),
    free_mask=None,
    device=None,
):
    """Build a solver whose ``frontier_cap`` is validated against the
    caller's actual sources — the one enforcement point of 'tuning may
    move time, never answers'. Returns ``(config, solver)``; on overflow
    the cap is dropped and the solver rebuilt full-width."""
    dev = resolve_device(device)

    def build(c):
        return _solver_no_warn(
            graph, c, dev,
            free_mask=free_mask if c.strategy == "pallas" else None,
        )

    solver = build(cfg)
    if cfg.frontier_cap is not None:
        srcs = [int(s) for s in sources]
        if len(srcs) > 1:
            tripped = bool(torch.as_tensor(
                solver.solve_many(srcs).overflow).any())
        else:
            tripped = bool(solver.solve(srcs[0]).overflow)
        if tripped:
            cfg = dataclasses.replace(cfg, frontier_cap=None)
            solver = build(cfg)
    return cfg, solver


def tune(
    graph: COOGraph,
    base: Optional[DeltaConfig] = None,
    *,
    sources: Sequence[int] = (0,),
    strategies: Optional[Sequence[str]] = None,
    deltas: Optional[Sequence[int]] = None,
    cap_fractions: Sequence[float] = _CAP_FRACTIONS,
    policies: Optional[Sequence[str]] = None,
    cache=None,
    free_mask=None,
    measure_fn=None,
    device=None,
) -> TuningRecord:
    """Measured search with successive-halving pruning.

    ``base`` supplies the non-searched config fields (pred_mode is
    ``'none'`` while measuring and restored by ``to_config``).
    ``cache`` (a ``TuningCache``) is consulted first and updated and
    saved after the search. ``measure_fn(delta, strategy, cap, policy,
    reps) -> seconds`` overrides the timing primitive (tests inject
    deterministic costs)."""
    dev = resolve_device(device)
    base = base if base is not None else DeltaConfig()
    stats = graph_stats(graph)
    fp = fingerprint(stats, dev)
    if cache is not None:
        hit = cache.get(fp)
        if hit is not None:
            return dataclasses.replace(hit, source="cache")

    bench_cfg = dataclasses.replace(base, pred_mode="none")
    if measure_fn is None:
        # one solver (one build + overflow validation) per candidate for
        # the whole search: later rounds re-time the warm solver
        solvers = {}

        def measure_fn(delta, strat, cap, policy, reps):
            key = (delta, strat, cap, policy)
            if key not in solvers:
                cfg = dataclasses.replace(
                    bench_cfg, delta=delta, strategy=strat,
                    frontier_cap=cap, policy=policy,
                )
                solvers[key] = _candidate_solver(
                    graph, cfg, sources, dev, free_mask=free_mask
                )
            if solvers[key] is None:
                return float("inf")
            return _time_solver(solvers[key], sources, reps, dev)

    survivors = candidate_configs(
        stats, strategies=strategies, deltas=deltas,
        cap_fractions=cap_fractions, policies=policies,
    )
    if group_size() > 1:
        local_fn = measure_fn

        def measure_fn(delta, strat, cap, policy, reps):
            # the slowest rank's time: the same on every rank
            t = torch.tensor([local_fn(delta, strat, cap, policy, reps)],
                             dtype=torch.float64, device=dev)
            return float(all_reduce(t, dist.ReduceOp.MAX, dist.group.WORLD))

    reps = 1
    evidence = {}  # candidate -> its latest (best-sampled) measurement
    timed = []
    while True:
        timed = [(measure_fn(d, s, c, p, reps), (d, s, c, p))
                 for d, s, c, p in survivors]
        timed.sort(key=lambda x: x[0])
        timed = [t for t in timed if np.isfinite(t[0])]
        evidence.update({cand: t for t, cand in timed})
        if not timed:
            # every candidate overflowed or was refused
            return heuristic_record(graph, base, stats, device=dev)
        if len(timed) == 1:
            break
        survivors = [cand for _, cand in timed[: (len(timed) + 1) // 2]]
        if len(survivors) == 1:
            # one final, better-sampled measurement of the winner
            reps *= 2
            d, s, c, p = survivors[0]
            timed = [(measure_fn(d, s, c, p, reps), (d, s, c, p))]
            evidence[(d, s, c, p)] = timed[0][0]
            break
        reps *= 2

    best_t, (delta, strat, cap, policy) = timed[0]
    # a sharded winner pins the shard count it was measured on
    shards = (resolve_n_shards(base.n_shards) if strat.startswith("sharded")
              else None)
    record = TuningRecord(
        fingerprint=fp,
        delta=delta,
        strategy=strat,
        frontier_cap=cap,
        source="measured",
        us_per_solve=round(best_t * 1e6, 1),
        trials=tuple(
            (d, s, -1 if c is None else c, p, round(t * 1e6, 1))
            for (d, s, c, p), t in sorted(evidence.items(), key=lambda kv: kv[1])
        ),
        n_shards=shards,
        policy=policy,
    )
    if cache is not None:
        cache.put(record)
        if group_size() == 1 or dist.get_rank() == 0:
            cache.save()
    return record


def resolve_record(
    graph: COOGraph,
    base: Optional[DeltaConfig] = None,
    *,
    free_mask=None,
    cache_path: Optional[str] = None,
    measure: bool = False,
    sources: Optional[Sequence[int]] = (0,),
    device=None,
) -> Tuple[DeltaConfig, TuningRecord]:
    """The ``tuning=`` resolution path: cache hit → tuned config;
    otherwise the zero-measurement estimator (or, with ``measure=True``,
    the measured search, persisted when a cache path is given). Returns
    ``(config, record)``.

    A tuning-chosen ``frontier_cap`` never reaches the engine
    unvalidated: with ``sources`` given it is re-validated against
    exactly those sources and dropped on overflow; with
    ``sources=None`` it is dropped outright."""
    dev = resolve_device(device)
    base = base if base is not None else DeltaConfig()
    if cache_path is not None or measure:
        from repro_torch.tune.cache import TuningCache

        cache = TuningCache(cache_path)
        probe = sources if sources is not None else (0,)
        if measure:
            rec = tune(graph, base, sources=probe, cache=cache,
                       free_mask=free_mask, device=dev)
        else:
            stats = graph_stats(graph)
            rec = cache.get(fingerprint(stats, dev))
            if rec is None:
                rec = heuristic_record(graph, base, stats, device=dev)
        cfg = rec.to_config(base)
        # only a record fresh from THIS call's measured search was
        # validated against these probe sources
        tuned_cap = (
            cfg.frontier_cap is not None and cfg.frontier_cap != base.frontier_cap
        )
        validated = measure and rec.source == "measured" and sources is not None
        if tuned_cap and not validated:
            if sources is None:
                cfg = dataclasses.replace(cfg, frontier_cap=None)
            else:
                cfg, _ = build_safe_solver(
                    graph, cfg, sources=sources, free_mask=free_mask,
                    device=dev,
                )
        return cfg, rec
    # pure-heuristic path: degrees and weights are enough — skip the
    # O(diameter·|E|) hop-radius probe (no cache key to build)
    stats = graph_stats(graph, probe_ecc=False)
    rec = heuristic_record(graph, base, stats, device=dev)
    return rec.to_config(base), rec


def resolve_config(
    graph: COOGraph,
    base: Optional[DeltaConfig] = None,
    *,
    free_mask=None,
    cache_path: Optional[str] = None,
    measure: bool = False,
    sources: Optional[Sequence[int]] = (0,),
    device=None,
) -> DeltaConfig:
    """Config-only wrapper of :func:`resolve_record`."""
    cfg, _ = resolve_record(
        graph,
        base,
        free_mask=free_mask,
        cache_path=cache_path,
        measure=measure,
        sources=sources,
        device=device,
    )
    return cfg


def tune_p2p(
    graph: COOGraph,
    record: Optional[TuningRecord] = None,
    *,
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    modes: Optional[Sequence[str]] = None,
    reps: int = 3,
    landmarks: Optional[dict] = None,
    free_mask=None,
    cache=None,
    measure_fn=None,
    device=None,
) -> TuningRecord:
    """Measured query-time search over the point-to-point algorithm
    (``DeltaConfig.p2p_mode``, DESIGN.md §14): times each mode on
    ``pairs`` through a real Plan and records the winner. ``modes=None``
    searches ``early_exit`` plus, on canonical (w >= 1) graphs, the
    three landmark modes; ``landmarks`` are ``Plan.prepare_landmarks``
    kwargs (the tables are built before the clock starts). ``cache`` (a
    ``TuningCache`` or a path) persists the extended record.
    ``measure_fn(mode) -> seconds`` overrides the timing."""
    from repro_torch.api import Engine, PointToPoint  # api builds on tune
    from repro_torch.core.backends import graph_is_canonical

    dev = resolve_device(device)
    if record is None:
        record = heuristic_record(graph, device=dev)
    base = record.to_config(DeltaConfig(pred_mode="none"))
    if modes is None:
        modes = ("early_exit",)
        if graph_is_canonical(graph):
            from repro_torch.landmarks import LANDMARK_MODES

            modes = modes + LANDMARK_MODES
    n = graph.n_nodes
    if pairs is None:
        rng = np.random.default_rng(0)
        pairs = tuple(
            (int(rng.integers(n)), int(rng.integers(n))) for _ in range(4)
        )
    plan = Engine(graph, base, free_mask=free_mask, device=dev).plan()
    if landmarks:
        plan.prepare_landmarks(**landmarks)
    best_mode, best_t = None, None
    for mode in modes:
        if measure_fn is not None:
            elapsed = float(measure_fn(mode))
        else:

            def run(m=mode):
                for s, t in pairs:
                    plan.solve(PointToPoint(s, t, mode=m))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

            run()  # kernel build and lazy table build off the clock
            elapsed = None
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                run()
                dt = time.perf_counter() - t0
                elapsed = dt if elapsed is None else min(elapsed, dt)
        if best_t is None or elapsed < best_t:
            best_mode, best_t = mode, elapsed
    record = dataclasses.replace(record, p2p_mode=best_mode)
    if cache is not None:
        if isinstance(cache, str):
            from repro_torch.tune.cache import TuningCache

            cache = TuningCache(cache)
        cache.put(record)
        cache.save()
    return record


__all__ = [
    "TuningRecord",
    "build_safe_solver",
    "candidate_configs",
    "default_policies",
    "default_strategies",
    "heuristic_record",
    "resolve_config",
    "resolve_record",
    "tune",
    "tune_p2p",
]
