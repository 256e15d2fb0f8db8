"""The Query/Plan façade of the PyTorch port (counterpart of
``repro.api.engine``).

``Engine(graph, config, free_mask=..., device=...)`` holds the graph
(and a game map's occupancy mask) on its device; ``Engine.plan()``
builds the relaxation backend once and returns a ``Plan``;
``plan.solve(query)`` runs the Δ-stepping loop and recovers
predecessors. Ported query kinds: ``SingleSource``,
``PointToPoint`` in mode ``early_exit`` (the target's bucket settles,
the loop stops; the path comes from the predecessor tree) and
``BoundedRadius`` (the loop stops past ``radius // Δ``; farther
vertices report as unreachable), on every ported strategy.

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
11), ``MultiSource`` and ``ManyToMany`` (item 4), the landmark
``PointToPoint`` modes (item 10), weight updates on sparse graphs
(``Plan.update``/``UpdateBatch``, item 9), the sharded strategies
(item 12) and the non-delta frontier policies (item 8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.paths import extract_path
from repro_torch.api.queries import (
    BoundedRadius,
    BoundedRadiusResult,
    ManyToMany,
    MultiSource,
    PointToPoint,
    PointToPointResult,
    Query,
    Result,
    SingleSource,
    SingleSourceResult,
    Telemetry,
    UpdateBatch,
)
from repro_torch.core.backends import GridPallasBackend, make_backend
from repro_torch.core.delta_stepping import (
    DeltaConfig,
    RunOut,
    _finish_pred,
    _run_one,
    _run_one_bounded,
    _run_one_p2p,
)
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


def _check_vertex(name: str, v, n: int) -> int:
    """Host-side id validation: an out-of-range id would otherwise index
    past the tent buffer."""
    v = int(v)
    if not 0 <= v < n:
        raise ValueError(f"{name} {v} out of range for a {n}-vertex graph")
    return v


class Plan:
    """A built operating point for one graph: config, relaxation
    backend, and the device the solve runs on. ``host_syncs`` holds the
    host synchronisations of the last solve."""

    def __init__(self, graph: COOGraph, config: DeltaConfig, *,
                 free_mask=None):
        self.graph = graph
        self.config = config
        self.device = graph.device
        self.backend = make_backend(graph, config, free_mask=free_mask)
        self._packed = config.pred_mode == "packed"
        self.host_syncs: Optional[int] = None

    def solve(self, query: Query) -> Result:
        if isinstance(query, UpdateBatch):
            # refused on a grid plan, not ported on others: both raise
            self.update(query.edge_ids, query.new_weights)
        if isinstance(query, SingleSource):
            return self._single(query)
        if isinstance(query, PointToPoint):
            return self._point_to_point(query)
        if isinstance(query, BoundedRadius):
            return self._bounded(query)
        if isinstance(query, (MultiSource, ManyToMany)):
            raise NotImplementedError(
                f"{type(query).__name__} queries are not ported to "
                "repro_torch yet (ROADMAP Queue 1 item 4)")
        raise TypeError(f"unknown query kind {type(query).__name__!r}")

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

    def _finish(self, out: RunOut, source: int):
        self.host_syncs = out.host_syncs
        dist, pred = _finish_pred(out.tent, self.graph, source, self.config)
        return dist, pred, Telemetry(out.outer_iters, out.inner_iters,
                                     out.overflow)

    def _single(self, q: SingleSource) -> SingleSourceResult:
        n = self.graph.n_nodes
        src = _check_vertex("source", q.source, n)
        out = _run_one(self.backend, src, n=n, packed=self._packed,
                       device=self.device)
        return SingleSourceResult(*self._finish(out, src))

    def _point_to_point(self, q: PointToPoint) -> PointToPointResult:
        n = self.graph.n_nodes
        src = _check_vertex("source", q.source, n)
        tgt = _check_vertex("target", q.target, n)
        mode = q.mode if q.mode is not None else self.config.p2p_mode
        if mode != "early_exit":
            raise NotImplementedError(
                f"PointToPoint mode {mode!r} is not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 10, landmarks)")
        out = _run_one_p2p(self.backend, src, tgt, n=n, packed=self._packed,
                           device=self.device)
        # every vertex on a shortest source->target path is settled at
        # early exit (its bucket precedes the target's), so the partial
        # predecessor state is exact along the returned path
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
        n = self.graph.n_nodes
        src = _check_vertex("source", q.source, n)
        out = _run_one_bounded(self.backend, src, radius, n=n,
                               packed=self._packed, device=self.device)
        dist, pred, tel = self._finish(out, src)
        # all buckets <= radius // delta were processed, so every vertex
        # with true distance <= radius is settled; the rest are filtered
        # to the unreachable sentinels (their tent values are bounds,
        # not answers)
        within = dist <= radius
        return BoundedRadiusResult(torch.where(within, dist, _INF),
                                   torch.where(within, pred, -1), radius, tel)


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
        if config.policy != "delta":
            if free_mask is not None and config.strategy == "pallas":
                # a grid plan (make_backend's routing): the stencil
                # recomputes bucket membership in-kernel from tent // Δ,
                # so it has no frontier-mask input a policy loop could
                # drive
                raise ValueError(
                    "the grid-stencil game-map path is delta-only; "
                    f"policy={config.policy!r} needs a mask-driven backend")
            raise NotImplementedError(
                f"policy={config.policy!r} is not ported to repro_torch yet "
                "(ROADMAP Queue 1 item 8)")
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.config = config
        self.free_mask = (None if free_mask is None else
                          free_mask_tensor(free_mask, self.device))

    def plan(self) -> Plan:
        return Plan(self.graph, self.config, free_mask=self.free_mask)


__all__ = ["Engine", "Plan", "UpdateRefused", "resolve_device"]
