"""The Query/Plan façade of the PyTorch port (counterpart of
``repro.api.engine``, cold single-source slice).

``Engine(graph, config, device=...)`` holds the graph on its device;
``Engine.plan()`` builds the relaxation backend once and returns a
``Plan``; ``plan.solve(SingleSource(s))`` runs the Δ-stepping loop
and recovers predecessors.

Device: ``device=None`` means ``"cuda"``. Without a CUDA device the
engine raises unless the caller asked for ``device="cpu"`` — it never
falls back to the CPU quietly. On CUDA the ``pallas`` and ``fused``
strategies launch the hand-written kernels; on the CPU their twins run.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): tuning (``Engine(graph)`` without a config, ROADMAP Queue 1 item
11), the other query kinds (item 4; ``UpdateBatch`` item 9), the
sharded strategies (item 12), the game-map path (item 7) and the
non-delta frontier policies (item 8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.queries import (
    Query,
    SingleSource,
    SingleSourceResult,
    Telemetry,
    UpdateBatch,
)
from repro_torch.core.backends import make_backend
from repro_torch.core.delta_stepping import DeltaConfig, _finish_pred, _run_one
from repro_torch.graphs.structures import COOGraph


def resolve_device(device) -> torch.device:
    """``None`` → CUDA. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU "
            "unless the caller passes device='cpu'")
    return dev


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

    def __init__(self, graph: COOGraph, config: DeltaConfig):
        self.graph = graph
        self.config = config
        self.device = graph.device
        self.backend = make_backend(graph, config)
        self._packed = config.pred_mode == "packed"
        self.host_syncs: Optional[int] = None

    def solve(self, query: Query) -> SingleSourceResult:
        if not isinstance(query, SingleSource):
            item = "9" if isinstance(query, UpdateBatch) else "4"
            raise NotImplementedError(
                f"{type(query).__name__} queries are not ported to "
                f"repro_torch yet (ROADMAP Queue 1 item {item})")
        n = self.graph.n_nodes
        src = _check_vertex("source", query.source, n)
        out = _run_one(self.backend, src, n=n, packed=self._packed,
                       device=self.device)
        self.host_syncs = out.host_syncs
        dist, pred = _finish_pred(out.tent, self.graph, src, self.config)
        return SingleSourceResult(
            dist, pred,
            Telemetry(out.outer_iters, out.inner_iters, out.overflow))


class Engine:
    """Façade entry point: holds the graph (moved to ``device``) and a
    concrete ``DeltaConfig``, and mints ``Plan``s."""

    def __init__(self, graph: COOGraph, config: Optional[DeltaConfig] = None,
                 *, free_mask=None, tuning=None, device=None):
        if config is None or isinstance(config, str) or tuning is not None:
            raise NotImplementedError(
                "tuning (Engine(graph), config='auto', tuning=...) is not "
                "ported to repro_torch yet (ROADMAP Queue 1 item 11); pass "
                "a concrete DeltaConfig")
        if config.policy != "delta":
            raise NotImplementedError(
                f"policy={config.policy!r} is not ported to repro_torch yet "
                "(ROADMAP Queue 1 item 8)")
        if free_mask is not None:
            raise NotImplementedError(
                "game-map graphs (free_mask) are not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 7)")
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.config = config

    def plan(self) -> Plan:
        return Plan(self.graph, self.config)


__all__ = ["Engine", "Plan", "resolve_device"]
