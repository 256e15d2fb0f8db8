"""The Query/Plan façade of the PyTorch port (counterpart of
``repro.api.engine``).

``Engine(graph, config, free_mask=..., device=...)`` holds the graph
(and a game map's occupancy mask) on its device; ``Engine.plan()``
builds the relaxation backend once, binds the solve drivers of its
frontier policy and returns a ``Plan``; ``plan.solve(query)`` runs the
loop and recovers predecessors. Ported query kinds, on every ported
strategy and policy: ``SingleSource``; ``MultiSource`` (lane ``b``
bitwise ``SingleSource(sources[b])``; ``edge`` and ``ell`` solve the
lanes as one ``[B, n]`` loop, the kernel strategies lane by lane);
``PointToPoint`` in mode ``early_exit`` (the target settles, the loop
stops; the path comes from the predecessor tree); ``BoundedRadius``
(the loop stops once nothing within ``radius`` can change; farther
vertices report as unreachable); ``ManyToMany`` (tiled
``MultiSource`` solves).

Policies (``DeltaConfig.policy``): ``delta`` binds the bucket-loop
drivers, ``rho`` and ``radius`` the frontier-policy loop over the same
backend (``core/policies.py``).

Overflow: with ``Engine.plan(fallback=True)`` and a ``frontier_cap``, a
query whose solve trips the compacted-frontier overflow flag is
re-answered on a full-width twin plan, the plan demotes to it for good
and the result's ``telemetry.fallback`` is set. Without it the flag is
only reported.

Dynamic graphs (``repro_torch.dynamic``, DESIGN.md §11): a plan is
also the unit of *residency*. Solving ``SingleSource`` keeps the
converged answer and the weight tensor it was solved against on the
plan (device tensors; they reach the host only inside ``resolve``);
``plan.update(edge_ids, new_weights)`` swaps edge costs (topology
fixed), and ``plan.resolve(warm=True)`` re-solves the resident problem
by warm-start repair — bitwise identical to a cold solve of the updated
graph. ``plan.solve(UpdateBatch(...))`` is the query-algebra packaging
of the same pair.

Game maps: ``free_mask`` (bool[H, W], H * W = n) routes
``strategy='pallas'`` to the grid stencil ``kernels/grid_relax``; other
strategies ignore it, as in the reference. A grid plan refuses packed
words and non-delta policies with ``ValueError`` and edge-weight
updates with ``UpdateRefused(reason="grid_costs")``, as the reference
does.

Device: ``device=None`` means ``"cuda"``. Without a CUDA device the
engine raises unless the caller asked for ``device="cpu"``; it never
falls back to the CPU quietly. On CUDA the ``pallas`` and ``fused``
strategies launch the hand-written kernels; on the CPU their twins run.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): tuning (``Engine(graph)`` without a config, ROADMAP Queue 1 item
11), the landmark ``PointToPoint`` modes and their update hook (item
10) and the sharded strategies (item 12).
"""
from __future__ import annotations

import copy
import dataclasses
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.paths import extract_path
from repro_torch.api.queries import (
    BoundedRadius,
    BoundedRadiusResult,
    ManyToMany,
    ManyToManyResult,
    MultiSource,
    MultiSourceResult,
    PointToPoint,
    PointToPointResult,
    Query,
    Result,
    SingleSource,
    SingleSourceResult,
    Telemetry,
    UpdateBatch,
)
from repro_torch.core.backends import (
    EllBackend,
    FusedBackend,
    GridPallasBackend,
    PallasEllBackend,
    dist_of,
    make_backend,
)
from repro_torch.core.delta_stepping import (
    DeltaConfig,
    RunOut,
    _finish_pred,
    _finish_pred_many,
    _run_lanes,
    _run_many_vmapped,
    _run_one,
    _run_one_bounded,
    _run_one_p2p,
    _run_one_warm,
    _run_policy_bounded,
    _run_policy_one,
    _run_policy_p2p,
    _run_policy_warm,
    pred_argmin,
)
from repro_torch.core.policies import make_policy
from repro_torch.core.grid import free_mask_tensor
from repro_torch.device import resolve_device
from repro_torch.dynamic import Resident, apply_weight_update, plan_repair
from repro_torch.graphs.structures import COOGraph, INF32

_INF = int(INF32)


class UpdateRefused(ValueError):
    """Structured refusal of a dynamic update the plan cannot apply.

    ``reason`` is a stable machine-readable tag (``"grid_costs"``:
    grid-stencil plans take their costs from ``DeltaConfig.grid_costs``,
    not the COO weight array). Direct callers get an ordinary
    ``ValueError`` (this is a subclass).

    >>> try:
    ...     raise UpdateRefused("no", reason="grid_costs")
    ... except ValueError as e:
    ...     e.reason
    'grid_costs'
    """

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


def _mark_fallback(res: Result) -> Result:
    tel = dataclasses.replace(res.telemetry, fallback=True)
    return dataclasses.replace(res, telemetry=tel)


def _check_vertex(name: str, v, n: int) -> int:
    """Host-side id validation: an out-of-range id would otherwise index
    past the tent buffer."""
    v = int(v)
    if not 0 <= v < n:
        raise ValueError(f"{name} {v} out of range for a {n}-vertex graph")
    return v


def _check_vertices(name: str, arr: np.ndarray, n: int) -> None:
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= n):
        raise ValueError(f"{name} contain ids out of range, graph has {n}")


class Plan:
    """A built operating point for one graph: config, relaxation backend,
    the solve drivers of its frontier policy, and the device the solve
    runs on; updatable in place for dynamic edge costs via ``update`` /
    ``resolve``. ``host_syncs`` holds the host synchronisations of the
    last query (summed over its lanes, tiles, a fallback's two solves,
    or a warm re-solve's two runs when the repair twin overflowed)."""

    def __init__(self, graph: COOGraph, config: DeltaConfig, *,
                 free_mask=None, fallback: bool = False):
        if config.policy != "delta" and (
                free_mask is not None and config.strategy == "pallas"):
            # a grid plan (make_backend's routing): the stencil
            # recomputes bucket membership in-kernel from tent // Δ, so
            # it has no frontier-mask input a policy loop could drive
            raise ValueError(
                "the grid-stencil game-map path is delta-only; "
                f"policy={config.policy!r} needs a mask-driven backend")
        self.graph = graph
        self.config = config
        self.device = graph.device
        self.backend = make_backend(graph, config, free_mask=free_mask)
        self._packed = config.pred_mode == "packed"
        self._policy = make_policy(graph, config)
        self._bind_drivers()
        # the one overflow-fallback point: only armed when a capped
        # compaction can overflow
        self._fallback = bool(fallback) and config.frontier_cap is not None
        self._demoted: Optional[Plan] = None
        self.host_syncs: Optional[int] = None
        # dynamic residency: the last SingleSource answer and the weight
        # tensor it was solved against
        self._resident: Optional[Resident] = None
        # warm-repair twin backend cache: (cap, graph version) -> backend
        self._graph_version = 0
        self._repair_twin = None
        self._repair_twin_key = None
        self._twin_cap_floor = 64   # escalates on twin overflow (sticky)
        # host copies of the fixed topology (int64 src, dst) and the
        # weight-independent ELL pad width, made on first use
        self._topology = None
        self._twin_width = None

    def _bind_drivers(self) -> None:
        """Partially apply the solve drivers for the plan's policy. Every
        query kind dispatches through these five attributes, so the
        policy axis is invisible past this point."""
        kw = dict(n=self.graph.n_nodes, packed=self._packed,
                  device=self.device)
        if self.config.policy == "delta":
            self._run1 = partial(_run_one, **kw)
            self._run_many = (
                partial(_run_many_vmapped, **kw) if self.backend.supports_vmap
                else partial(_run_lanes, _run_one, **kw))
            self._run_p2p = partial(_run_one_p2p, **kw)
            self._run_bounded = partial(_run_one_bounded, **kw)
            self._run_warm = partial(_run_one_warm, **kw)
        else:
            pol = self._policy
            self._run1 = partial(_run_policy_one, policy=pol, **kw)
            self._run_many = partial(_run_lanes, _run_policy_one, policy=pol,
                                     **kw)
            self._run_p2p = partial(_run_policy_p2p, policy=pol, **kw)
            self._run_bounded = partial(_run_policy_bounded, policy=pol,
                                        **kw)
            self._run_warm = partial(_run_policy_warm, policy=pol, **kw)

    def solve(self, query: Query) -> Result:
        """Answer one query. With fallback armed, a solve that trips the
        compacted-frontier overflow flag is re-answered by the
        full-width twin plan, and the plan demotes to it for good.

        ``UpdateBatch`` is the one query kind that mutates the plan: it
        routes through ``update`` + ``resolve`` and takes no part in
        overflow demotion (the warm contract refuses an overflowed
        resident state, and the re-solve reports its own overflow
        flag)."""
        if isinstance(query, UpdateBatch):
            self.update(query.edge_ids, query.new_weights)
            return self.resolve(warm=query.warm)
        if self._demoted is not None:
            res = _mark_fallback(self._demoted._dispatch(query))
            self.host_syncs = self._demoted.host_syncs
            return res
        res = self._dispatch(query)
        if self._fallback and bool(
                torch.as_tensor(res.telemetry.overflow).any()):
            capped_syncs = self.host_syncs
            self._demoted = self._full_width_twin()
            res = _mark_fallback(self._demoted._dispatch(query))
            self.host_syncs = capped_syncs + self._demoted.host_syncs
        return res

    def _full_width_twin(self) -> "Plan":
        """The plan with no frontier cap. Only the ELL-family backends
        can overflow, and their blocks do not depend on the cap, so the
        twin shares them, the graph and the policy, and only widens
        ``cap`` to ``n`` (the reference rebuilds the whole plan; the
        answers are the same). The resident state rides along: it was
        solved on the same graph and pred mode."""
        twin = copy.copy(self)
        twin.config = dataclasses.replace(self.config, frontier_cap=None)
        twin.backend = dataclasses.replace(self.backend,
                                           cap=self.graph.n_nodes)
        twin._fallback = False
        twin._bind_drivers()
        return twin

    # -- dynamic updates (repro_torch.dynamic, DESIGN.md §11) ---------------

    def update(self, edge_ids, new_weights) -> "Plan":
        """Apply an edge-cost update batch to the plan in place: swap
        weights (topology fixed), rebuild the relaxation backend on the
        updated graph, and leave the resident answer untouched until the
        next ``resolve`` diffs against its snapshot — so several batches
        between resolves compose. A grid plan refuses them, as the
        reference does. Returns ``self``."""
        if isinstance(self.backend, GridPallasBackend):
            raise UpdateRefused(
                "grid-stencil (game-map) plans take their costs from "
                "DeltaConfig.grid_costs, not the COO weight array; "
                "edge-weight updates do not apply to them",
                reason="grid_costs")
        graph = apply_weight_update(self.graph, edge_ids, new_weights)
        self._install(graph, self._rebuild_backend(graph))
        if self._demoted is not None:
            # the full-width twin shares the rebuilt blocks (and the
            # radius policy), as at demotion
            self._demoted._install(
                graph, dataclasses.replace(self.backend, cap=graph.n_nodes),
                self._policy)
        return self

    def _install(self, graph: COOGraph, backend, policy=None) -> None:
        """Make ``graph`` (and its ``backend``) the plan's current one.
        Radius-stepping's step radii derive from the weights: recomputed
        (or taken as ``policy``) and the drivers rebound."""
        self.graph = graph
        self.backend = backend
        self._graph_version += 1
        if self.config.policy == "radius":
            self._policy = (policy if policy is not None
                            else make_policy(graph, self.config))
            self._bind_drivers()

    def _rebuild_backend(self, graph: COOGraph):
        """Backend over the updated weights. The ELL strategies pad their
        light/heavy blocks to the tightest width at plan time, a width
        that moves with edge costs (the split is w <= Δ); rebuilds pin
        the weight-independent full adjacency degree instead, as the
        reference does, so every update yields the same shapes."""
        cls = {"ell": EllBackend, "pallas": PallasEllBackend,
               "fused": FusedBackend}.get(self.config.strategy)
        if cls is None:
            return make_backend(graph, self.config)
        return cls.build(graph, self.config, max_deg=self._adjacency_width())

    def _host_topology(self):
        """Host int64 copies of ``src``/``dst``, made once per plan:
        topology never changes, so repair planning never pulls it back
        from the device."""
        if self._topology is None:
            self._topology = tuple(
                t.cpu().numpy().astype(np.int64)
                for t in (self.graph.src, self.graph.dst))
        return self._topology

    def _adjacency_width(self) -> int:
        """Max out-degree — the weight-independent ELL pad width."""
        if self._twin_width is None:
            deg = np.bincount(self._host_topology()[0],
                              minlength=self.graph.n_nodes)
            self._twin_width = max(1, int(deg.max())) if deg.size else 1
        return self._twin_width

    def _warm_backend(self, repaired: int):
        """Backend for a warm repair solve. Repair frontiers are small,
        so ``edge``, ``ell`` and ``fused`` sweep a frontier-compacted
        twin whose capacity is a power-of-two head-room over the seed
        count (at least 64, doubled until it is 2 × ``repaired``): an
        ``ell`` twin for ``edge``/``ell``, a ``fused`` twin for
        ``fused``, at the pinned pad width. Safe because the overflow
        flag guards a full-width re-run in ``resolve``, and exact
        because every warm-eligible mode has a schedule-free fixed
        point. ``ell``/``fused`` twins share the plan's rebuilt blocks
        and only narrow ``cap`` (the reference builds them anew; the
        arrays are the same); ``edge``'s ELL twin is built once per
        (cap, graph version). ``pallas`` keeps its own backend."""
        strategy = self.config.strategy
        if strategy not in ("edge", "ell", "fused"):
            return self.backend
        n = self.graph.n_nodes
        cap = self._twin_cap_floor
        while cap < repaired * 2:
            cap *= 2
        own_cap = self.config.frontier_cap or n
        if cap >= n or (strategy in ("ell", "fused") and cap >= own_cap):
            return self.backend
        key = (cap, self._graph_version)
        if self._repair_twin_key != key:
            if strategy == "edge":
                cfg = dataclasses.replace(self.config, strategy="ell",
                                          frontier_cap=cap)
                self._repair_twin = EllBackend.build(
                    self.graph, cfg, max_deg=self._adjacency_width())
            else:
                self._repair_twin = dataclasses.replace(self.backend,
                                                        cap=cap)
            self._repair_twin_key = key
        return self._repair_twin

    def resolve(self, warm: bool = True) -> SingleSourceResult:
        """Re-solve the plan's resident single-source problem against the
        current (updated) weights. ``warm=True`` repairs from the
        resident answer: changed edges seed a repair frontier (decreases
        enter their new bucket directly; increases reset and re-seed the
        predecessor-tree cone) and the bucket loop re-settles only what
        the perturbation can reach — bitwise identical to the cold
        solve. Updates outside the warm contract (``plan_repair``'s
        refusals) re-solve cold; telemetry reports which path ran
        (``warm``/``repaired``/``cone``)."""
        if self._demoted is not None:
            res = _mark_fallback(self._demoted.resolve(warm=warm))
            self.host_syncs = self._demoted.host_syncs
            return res
        r = self._resident
        if r is None:
            raise ValueError(
                "resolve() repairs the plan's resident state — solve a "
                "SingleSource query first to establish it")
        rep = None
        if warm:
            src, dst = self._host_topology()
            rep, _ = plan_repair(
                COOGraph(src, dst, self.graph.w, self.graph.n_nodes), r,
                pred_mode=self.config.pred_mode)
        if rep is not None and rep.repaired == 0:
            # distance-neutral churn: distances stand. argmin preds are a
            # function of (distances, *current* weights), and a tie can
            # move without any distance moving, so the tree is recomputed
            # against the updated graph; packed ties are covered by the
            # repair's word-order seeds, and 'none' tracks no tree
            dist, pred = r.dist, r.pred
            if self.config.pred_mode == "argmin":
                g = self.graph
                pred = pred_argmin(dist, g.src, g.dst, g.w, r.source,
                                   n=g.n_nodes)
            self._remember(r.source, dist, pred, r.overflow)
            self.host_syncs = 0
            return SingleSourceResult(dist, pred, Telemetry(
                0, 0, False, warm=True, repaired=0, cone=0))
        if rep is not None:
            tent0 = torch.from_numpy(rep.tent0).to(self.device)
            explored0 = torch.from_numpy(rep.explored0).to(self.device)
            backend = self._warm_backend(rep.repaired)
            out = self._run_warm(backend, tent0, explored0)
            syncs = out.host_syncs
            if backend is not self.backend and out.overflow:
                # the repair cascade outgrew the capped twin: re-run the
                # same warm state full-width (the cap moves time, never
                # answers) and escalate the floor for later repairs
                self._twin_cap_floor = min(backend.cap * 4,
                                           self.graph.n_nodes)
                out = self._run_warm(self.backend, tent0, explored0)
                syncs += out.host_syncs
            tel = Telemetry(out.outer_iters, out.inner_iters, out.overflow,
                            warm=True, repaired=rep.repaired, cone=rep.cone)
        else:
            out = self._run1(self.backend, r.source)
            syncs = out.host_syncs
            tel = Telemetry(out.outer_iters, out.inner_iters, out.overflow)
        self.host_syncs = syncs
        dist, pred = _finish_pred(out.tent, self.graph, r.source,
                                  self.config)
        self._remember(r.source, dist, pred, out.overflow)
        return SingleSourceResult(dist, pred, tel)

    def _remember(self, source: int, dist, pred, overflow: bool) -> None:
        """Keep the answer resident. Device copies of ``dist``/``pred``
        (a caller may write into the tensors it got back); the weight
        tensor is held as is, since updates never write it."""
        self._resident = Resident(int(source), dist.clone(), pred.clone(),
                                  self.graph.w, bool(overflow))

    def explain(self) -> dict:
        """Plan provenance: the operating point, whether the overflow
        fallback has demoted the plan, and the resident source. Landmarks
        and tuning are not ported (ROADMAP Queue 1 items 10, 11), so
        their fields are ``None``."""
        cfg = self.config
        return {
            "delta": cfg.delta,
            "strategy": cfg.strategy,
            "policy": cfg.policy,
            "pred_mode": cfg.pred_mode,
            "frontier_cap": cfg.frontier_cap,
            "n_shards": cfg.n_shards,
            "p2p_mode": cfg.p2p_mode,
            "landmarks": None,
            "tuning_source": None,
            "fallback_taken": self._demoted is not None,
            "resident_source": (None if self._resident is None
                                else self._resident.source),
        }

    def _dispatch(self, query: Query) -> Result:
        if isinstance(query, SingleSource):
            return self._single(query)
        if isinstance(query, MultiSource):
            return self._multi(query)
        if isinstance(query, PointToPoint):
            return self._point_to_point(query)
        if isinstance(query, BoundedRadius):
            return self._bounded(query)
        if isinstance(query, ManyToMany):
            return self._many_to_many(query)
        raise TypeError(f"unknown query kind {type(query).__name__!r}")

    def _finish(self, out: RunOut, source: int):
        self.host_syncs = out.host_syncs
        dist, pred = _finish_pred(out.tent, self.graph, source, self.config)
        return dist, pred, Telemetry(out.outer_iters, out.inner_iters,
                                     out.overflow)

    def _single(self, q: SingleSource) -> SingleSourceResult:
        src = _check_vertex("source", q.source, self.graph.n_nodes)
        out = self._run1(self.backend, src)
        dist, pred, tel = self._finish(out, src)
        self._remember(src, dist, pred, out.overflow)    # residency
        return SingleSourceResult(dist, pred, tel)

    def _multi(self, q: MultiSource) -> MultiSourceResult:
        host = np.asarray(q.sources, np.int64)
        if host.ndim != 1:
            raise ValueError("sources must be a 1-D array of vertex ids")
        _check_vertices("sources", host, self.graph.n_nodes)
        sources = host.tolist()
        out = self._run_many(self.backend, sources)
        self.host_syncs = out.host_syncs
        dist, pred = _finish_pred_many(out.tent, self.graph, sources,
                                       self.config)
        return MultiSourceResult(dist, pred, Telemetry(
            out.outer_iters, out.inner_iters, out.overflow))

    def _point_to_point(self, q: PointToPoint) -> PointToPointResult:
        n = self.graph.n_nodes
        src = _check_vertex("source", q.source, n)
        tgt = _check_vertex("target", q.target, n)
        mode = q.mode if q.mode is not None else self.config.p2p_mode
        if mode != "early_exit":
            if self.config.policy != "delta":
                raise ValueError(
                    "landmark p2p modes (alt/bidirectional) run the bucket "
                    "loop's all-light drivers and are delta-only; "
                    f"policy={self.config.policy!r} plans answer "
                    "PointToPoint via mode='early_exit'")
            raise NotImplementedError(
                f"PointToPoint mode {mode!r} is not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 10, landmarks)")
        out = self._run_p2p(self.backend, src, tgt)
        # every vertex on a shortest source->target path is settled at
        # early exit, so the partial predecessor state is exact along
        # the returned path
        dist, pred, tel = self._finish(out, src)
        distance = int(dist[tgt])
        path = None
        if distance < _INF and self.config.pred_mode != "none":
            path = extract_path(pred.cpu().numpy(), src, tgt, n)
        return PointToPointResult(distance, path, tel)

    def _bounded(self, q: BoundedRadius) -> BoundedRadiusResult:
        radius = int(q.radius)
        if not 0 <= radius < _INF:
            raise ValueError(f"radius must be in [0, INF32), got {radius}")
        src = _check_vertex("source", q.source, self.graph.n_nodes)
        out = self._run_bounded(self.backend, src, radius)
        dist, pred, tel = self._finish(out, src)
        # every vertex with true distance <= radius is settled; the rest
        # are filtered to the unreachable sentinels (their tent values
        # are bounds, not answers)
        within = dist <= radius
        return BoundedRadiusResult(torch.where(within, dist, _INF),
                                   torch.where(within, pred, -1), radius, tel)

    def _many_to_many(self, q: ManyToMany) -> ManyToManyResult:
        n = self.graph.n_nodes
        sources = [_check_vertex("source", s, n) for s in q.sources]
        targets = np.asarray([int(t) for t in q.targets], np.int64)
        if not sources or targets.size == 0:
            raise ValueError("ManyToMany needs non-empty sources and targets")
        _check_vertices("targets", targets, n)
        tile = int(q.tile) if q.tile is not None else min(len(sources), 8)
        if tile < 1:
            raise ValueError(f"tile must be >= 1, got {tile}")
        cols = torch.as_tensor(targets, device=self.device)
        matrix = torch.full((len(sources), targets.size), _INF,
                            dtype=torch.int64)
        buckets, inner, over, syncs = 0, 0, False, 0
        for lo in range(0, len(sources), tile):
            chunk = sources[lo:lo + tile]
            # short tiles repeat the last source, so every tile has one
            # shape; the padded lanes are discarded
            out = self._run_many(self.backend,
                                 chunk + [chunk[-1]] * (tile - len(chunk)))
            d = dist_of(out.tent, self._packed)[:len(chunk)][:, cols]
            matrix[lo:lo + len(chunk)] = d.cpu().to(torch.int64)
            buckets = max(buckets, int(out.outer_iters.max()))
            inner += int(out.inner_iters.sum())
            over = over or bool(out.overflow.any())
            syncs += out.host_syncs
        self.host_syncs = syncs
        return ManyToManyResult(matrix, Telemetry(buckets, inner, over))


class Engine:
    """Façade entry point: holds the graph (and a game map's occupancy
    mask), moved to ``device``, and a concrete ``DeltaConfig``, and
    mints ``Plan``s."""

    def __init__(self, graph: COOGraph, config: Optional[DeltaConfig] = None,
                 *, free_mask=None, tuning=None, device=None):
        if config is None or isinstance(config, str) or tuning is not None:
            raise NotImplementedError(
                "tuning (Engine(graph), config='auto', tuning=...) is not "
                "ported to repro_torch yet (ROADMAP Queue 1 item 11); pass "
                "a concrete DeltaConfig")
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.config = config
        self.free_mask = (None if free_mask is None else
                          free_mask_tensor(free_mask, self.device))

    def plan(self, *, sources: Optional[Sequence[int]] = None,
             fallback: bool = False) -> Plan:
        """Build the ``Plan``. ``sources`` only feeds tuning in the
        reference (a tuned frontier cap is validated against them);
        tuning is not ported (ROADMAP Queue 1 item 11), so it is accepted
        and unused. ``fallback=True`` arms the overflow fallback of a
        plan with a ``frontier_cap``."""
        del sources
        return Plan(self.graph, self.config, free_mask=self.free_mask,
                    fallback=fallback)


__all__ = ["Engine", "Plan", "UpdateRefused", "resolve_device"]
