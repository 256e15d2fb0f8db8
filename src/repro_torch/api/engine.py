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
11), the landmark ``PointToPoint`` modes (item 10), weight updates on
sparse graphs (``Plan.update``/``UpdateBatch``, item 9) and the sharded
strategies (item 12).
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
from repro_torch.core.backends import GridPallasBackend, dist_of, make_backend
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
    _run_policy_bounded,
    _run_policy_one,
    _run_policy_p2p,
)
from repro_torch.core.policies import make_policy
from repro_torch.core.grid import free_mask_tensor
from repro_torch.device import resolve_device
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
    runs on. ``host_syncs`` holds the host synchronisations of the last
    query (summed over its lanes, tiles, and a fallback's two solves)."""

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

    def _bind_drivers(self) -> None:
        """Partially apply the solve drivers for the plan's policy. Every
        query kind dispatches through these four attributes, so the
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
        else:
            pol = self._policy
            self._run1 = partial(_run_policy_one, policy=pol, **kw)
            self._run_many = partial(_run_lanes, _run_policy_one, policy=pol,
                                     **kw)
            self._run_p2p = partial(_run_policy_p2p, policy=pol, **kw)
            self._run_bounded = partial(_run_policy_bounded, policy=pol,
                                        **kw)

    def solve(self, query: Query) -> Result:
        """Answer one query. With fallback armed, a solve that trips the
        compacted-frontier overflow flag is re-answered by the
        full-width twin plan, and the plan demotes to it for good."""
        if isinstance(query, UpdateBatch):
            # refused on a grid plan, not ported on others: both raise
            self.update(query.edge_ids, query.new_weights)
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
        answers are the same)."""
        twin = copy.copy(self)
        twin.config = dataclasses.replace(self.config, frontier_cap=None)
        twin.backend = dataclasses.replace(self.backend,
                                           cap=self.graph.n_nodes)
        twin._fallback = False
        twin._bind_drivers()
        return twin

    def update(self, edge_ids, new_weights) -> "Plan":
        """Edge-cost updates. A grid plan refuses them as the reference
        does; on other plans they are not ported yet."""
        if isinstance(self.backend, GridPallasBackend):
            raise UpdateRefused(
                "grid-stencil (game-map) plans take their costs from "
                "DeltaConfig.grid_costs, not the COO weight array; "
                "edge-weight updates do not apply to them",
                reason="grid_costs")
        raise NotImplementedError(
            "dynamic updates (Plan.update, UpdateBatch) are not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 9)")

    def explain(self) -> dict:
        """Plan provenance: the operating point, and whether the overflow
        fallback has demoted the plan. Landmarks, tuning and dynamic
        residency are not ported (ROADMAP Queue 1 items 10, 11, 9), so
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
            "resident_source": None,
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
        return SingleSourceResult(*self._finish(self._run1(self.backend, src),
                                                src))

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
