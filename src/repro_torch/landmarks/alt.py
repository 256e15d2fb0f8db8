"""ALT potentials and the goal-directed point-to-point solvers
(counterpart of ``repro.landmarks.alt``, DESIGN.md §14).

The three landmark-backed ``p2p_mode`` values all reduce to the stock
Δ-stepping bucket loop over a *reweighted* (and, for the bidirectional
pair, *doubled*) graph:

* ``alt``               — forward Δ-stepping over reduced edge costs
  ``w'(u, v) = w + π(v) − π(u)`` with the landmark potential π, behind
  the early-exit stop (``_run_one_p2p(all_light=True)``); the true
  distance is the reduced one plus ``π(s)``.
* ``bidirectional``     — forward and backward searches as ONE solve
  over the disjoint union of the graph with its reversed copy
  (``graphs.union_with_reverse``), stopped by the meeting rule
  (``_run_one_bidir``).
* ``alt_bidirectional`` — both: the same π reduces both union halves
  (the backward half with the opposite sign), and the meeting sum
  telescopes to ``dist(s, t) − π(s)``.

Potentials (Goldberg & Harrelson): per landmark L the triangle
inequality bounds dist(v, t) below by ``d(L, t) − d(L, v)`` and
``d(v, L) − d(t, L)``; π(v) is their max over landmarks, floored at 0
and clamped to ``POTENTIAL_CLIP`` so reduced int32 arithmetic cannot
overflow. π is computed on the host in int64, the reference's loop,
and goes to the device as int32 once per query.

The query solves run over an all-light ELL adjacency: the full (union)
adjacency as one ELL block with an empty heavy block, at full width
(``cap = n``), so no frontier can overflow. The block structure is
weight-independent, so per-query reweighting is one gather and add on
the device. The blocks, and the COO triples path recovery runs over,
are built once per weight version and stay on the plan's device.

Path recovery never walks the reduced space: converged reduced tents
are turned back into original-space distance bounds (exact on every
shortest s–t path vertex) and ``pred_argmin`` runs over the ORIGINAL
forward / reversed edges — which needs w >= 1, so every landmark mode
is gated to canonical graphs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.backends import EllBackend, graph_is_canonical
from repro_torch.core.delta_stepping import (
    P2P_MODES,
    _run_one_bidir,
    _run_one_p2p,
    pred_argmin,
)
from repro_torch.graphs.structures import (
    COOGraph,
    ELLGraph,
    INF32,
    coo_to_csr,
    csr_to_ell,
    union_with_reverse,
)
from repro_torch.landmarks.store import LandmarkStore
from repro_torch.landmarks.tables import (
    LandmarkTables,
    SELECT_STRATEGIES,
    build_tables,
    graph_whash,
)

# π is clamped to [0, 2^28]; with w + 2·clip < 2^31 the reduced weights
# and the engine's no-overflow distance assumption both stay in int32
POTENTIAL_CLIP = np.int64(2**28)

LANDMARK_MODES = tuple(m for m in P2P_MODES if m != "early_exit")
_INF = int(INF32)


def potentials(tables: LandmarkTables, target: int) -> np.ndarray:
    """ALT potential π for ``target``: int64[n] on the host, 0 <= π <=
    clip, π(target) == 0, consistent and admissible w.r.t. the weights
    the tables were built at (and any elementwise-increased weights)."""
    t = int(target)
    clip = np.int64(POTENTIAL_CLIP)
    d_out = tables.d_out.astype(np.int64)
    d_in = tables.d_in.astype(np.int64)
    pi = np.zeros(tables.n, np.int64)
    for j in range(tables.k):
        d_lt = d_out[j, t]
        if d_lt < _INF:
            # d_out[j] == INF makes the term very negative: excluded
            pi = np.maximum(pi, np.minimum(d_lt - d_out[j], clip))
        d_tl = d_in[j, t]
        if d_tl < _INF:
            term = np.where(d_in[j] < _INF,
                            np.minimum(d_in[j] - d_tl, clip), clip)
            pi = np.maximum(pi, term)
    return pi


def _take_clip(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, mode="clip")``: indices clamped into range."""
    return x[idx.clamp(0, x.shape[0] - 1).to(torch.int64)]


def reduce_forward(w_ell, nbr, pi, n: int):
    """Reduced weights of a forward ELL adjacency ((n+1, D) with
    sentinel row n): ``w' = w + π[nbr] − π[row]`` in int32 (wrapping,
    as the reference's); invalid slots keep INF32. ``pi`` int32[n] on
    the adjacency's device."""
    pi_ext = torch.cat([pi, pi.new_zeros(1)])
    diff = _take_clip(pi_ext, nbr) - pi_ext[:, None]
    return torch.where(w_ell < _INF, w_ell + diff, _INF)


def reduce_union(w_ell, nbr, pi, half: int):
    """Reduced weights of the union ELL adjacency ((2·half+1, D),
    sentinel row 2·half). Forward rows get ``w + π[v] − π[u]``; backward
    rows the opposite sign, so the backward copy of edge (u, v) carries
    exactly the forward reduced cost."""
    pi_ext = torch.cat([pi, pi, pi.new_zeros(1)])
    rows = torch.arange(2 * half + 1, dtype=torch.int32, device=pi.device)
    sign = torch.where(rows < half, 1, -1).to(torch.int32)[:, None]
    diff = _take_clip(pi_ext, nbr) - pi_ext[:, None]
    return torch.where(w_ell < _INF, w_ell + sign * diff, _INF)


def _all_light_backend(nbr, w_ell, n: int, delta: int) -> EllBackend:
    """EllBackend whose light block is the FULL adjacency and whose
    heavy block is empty (width-1 all-sentinel). ``canonical=False`` is
    inert (only read in packed mode; the landmark solves run
    packed=False). ``cap=n`` (full width) rules out frontier overflow."""
    light = ELLGraph(nbr, w_ell, n, int(nbr.shape[1]))
    heavy = ELLGraph(
        torch.full((n + 1, 1), n, dtype=torch.int32, device=nbr.device),
        torch.full((n + 1, 1), _INF, dtype=torch.int32, device=nbr.device),
        n, 1)
    return EllBackend(light, heavy, delta, n, n, False)


def require_canonical(graph: COOGraph) -> None:
    if not graph_is_canonical(graph):
        raise ValueError(
            "landmark p2p modes require canonical weights (w >= 1): the "
            "path-recovery walk needs strictly decreasing distances")


@dataclasses.dataclass(frozen=True)
class LandmarkSpec:
    """Landmark residency policy of one Plan (``Plan.prepare_landmarks``).

    ``store`` is a directory for the persistent :class:`LandmarkStore`
    (``None`` = in-memory). ``on_update`` picks the stale-table policy
    for weight batches that DECREASE some weight below its table-build
    value (increase-only batches always keep the tables):

    * ``recompute`` — drop the tables; the next ALT query lazily
      rebuilds against the new weights.
    * ``refuse``    — reject the batch with ``LandmarkRefused`` BEFORE
      any weight is applied.
    """

    k: int = 4
    strategy: str = "farthest"
    seed: int = 0
    store: Optional[str] = None
    on_update: str = "recompute"

    def __post_init__(self):
        if self.strategy not in SELECT_STRATEGIES:
            raise ValueError(f"unknown landmark strategy {self.strategy!r}")
        if self.on_update not in ("recompute", "refuse"):
            raise ValueError(f"unknown on_update policy {self.on_update!r}")
        if self.k < 1:
            raise ValueError("need at least one landmark")


class P2PSolve(NamedTuple):
    """Raw landmark-mode solve result; the Plan façade turns it into a
    PointToPointResult (path stitching lives in ``api.paths``).
    ``host_syncs`` counts the solve loop's host synchronisations."""

    distance: int
    pred_f: Optional[torch.Tensor]  # forward tree (original graph)
    pred_b: Optional[torch.Tensor]  # backward tree (reversed graph)
    meet: Optional[int]             # meeting vertex (bidirectional only)
    outer: int
    inner: int
    overflow: bool
    host_syncs: int = 0


class LandmarkState:
    """Landmark residency of one Plan: the distance tables (host) plus
    the weight-independent all-light ELL structure the goal-directed
    modes solve over (device). Tables build lazily (store hit or
    precompute) on the first ALT query; ``note_update`` re-validates
    them against the bound-repair condition after every weight batch."""

    def __init__(self, spec: LandmarkSpec, delta: int,
                 store: Optional[LandmarkStore] = None):
        self.spec = spec
        self.delta = int(delta)
        self.store = store if store is not None else LandmarkStore(spec.store)
        self.tables: Optional[LandmarkTables] = None
        self._w_base: Optional[np.ndarray] = None   # weights at table build
        self._version = 0                           # bumped per weight batch
        self._ell_version: Optional[int] = None
        self._union_ell: Optional[ELLGraph] = None
        self._fwd_ell: Optional[ELLGraph] = None
        self._coo_f = None                          # device COO, forward
        self._coo_b = None                          # device COO, reversed

    # -- tables -----------------------------------------------------------

    def ensure_tables(self, graph: COOGraph) -> LandmarkTables:
        if self.tables is None:
            from repro_torch.tune.estimator import fingerprint, graph_stats

            fp = fingerprint(graph_stats(graph), graph.device)
            wh = graph_whash(graph)
            s = self.spec
            hit = self.store.get(fp, wh, min(s.k, graph.n_nodes),
                                 s.strategy, s.seed)
            if hit is None:
                hit = build_tables(graph, k=s.k, strategy=s.strategy,
                                   seed=s.seed, delta=self.delta,
                                   fingerprint=fp)
                self.store.put(hit)
            self.tables = hit
            self._w_base = graph.w.cpu().numpy().astype(np.int64)
        return self.tables

    def would_invalidate(self, edge_ids, new_weights) -> bool:
        """True iff applying the batch drops some weight below its
        table-build value (last-wins duplicate semantics, matching
        ``dynamic.apply_weight_update``)."""
        if self.tables is None:
            return False
        ids = np.asarray(edge_ids, np.int64).ravel()[::-1]
        nw = np.asarray(new_weights, np.int64).ravel()[::-1]
        uniq, first = np.unique(ids, return_index=True)
        return bool((nw[first] < self._w_base[uniq]).any())

    def note_update(self, graph: COOGraph) -> str:
        """Record an applied weight batch: always invalidates the ELL
        weight caches; keeps the tables iff every current weight still
        dominates its table-build value (π stays admissible AND
        consistent)."""
        self._version += 1
        if self.tables is None:
            return "none"
        w_now = graph.w.cpu().numpy().astype(np.int64)
        if w_now.shape == self._w_base.shape and (w_now >= self._w_base).all():
            return "kept"
        self.tables = None
        self._w_base = None
        return "stale"

    # -- query path -------------------------------------------------------

    def _ells(self, graph: COOGraph):
        """Weight-version cache of everything query-independent, on the
        graph's device: the union / forward all-light ELL adjacencies
        (built on the host once per version) and the COO triples path
        recovery scatters over (the graph's own tensors), so the
        per-query host work is O(n) (π and the answer's readback)."""
        if self._ell_version != self._version or self._union_ell is None:
            self._union_ell = csr_to_ell(coo_to_csr(union_with_reverse(graph)))
            self._fwd_ell = csr_to_ell(coo_to_csr(graph))
            self._coo_f = (graph.src, graph.dst, graph.w)
            self._coo_b = (graph.dst, graph.src, graph.w)
            self._ell_version = self._version
        return self._union_ell, self._fwd_ell

    def solve_p2p(self, graph: COOGraph, source, target, mode: str, *,
                  want_pred: bool = True) -> P2PSolve:
        if mode not in LANDMARK_MODES:
            raise ValueError(f"unknown landmark p2p mode {mode!r}")
        require_canonical(graph)
        s, t = int(source), int(target)
        use_alt = mode in ("alt", "alt_bidirectional")
        pi = None
        if use_alt:
            pi = potentials(self.ensure_tables(graph), t)
        union_ell, fwd_ell = self._ells(graph)
        if mode == "alt":
            return self._solve_alt_forward(graph, fwd_ell, pi, s, t,
                                           want_pred)
        return self._solve_bidir(graph, union_ell, pi, s, t, use_alt,
                                 want_pred)

    def _solve_alt_forward(self, graph, ell, pi, s, t, want_pred):
        n = graph.n_nodes
        dev = ell.nbr.device
        pi32 = torch.from_numpy(pi.astype(np.int32)).to(dev)
        w_red = reduce_forward(ell.w, ell.nbr, pi32, n)
        backend = _all_light_backend(ell.nbr, w_red, n, self.delta)
        out = _run_one_p2p(backend, s, t, n=n, packed=False, device=dev,
                           all_light=True)
        counters = (out.outer_iters, out.inner_iters, out.overflow,
                    out.host_syncs)
        th = out.tent.cpu().numpy().astype(np.int64)
        if th[t] >= _INF:
            return P2PSolve(_INF, None, None, None, *counters)
        distance = int(th[t] + pi[s])               # π(t) == 0
        pred_f = None
        if want_pred:
            # back to original space: d̂(v) = tent'(v) + π(s) − π(v),
            # an upper bound everywhere and exact on the s–t path
            dhat = np.where(th < _INF, th + (pi[s] - pi), np.int64(_INF))
            dhat = np.minimum(dhat, _INF).astype(np.int32)
            src, dst, w = self._coo_f
            pred_f = pred_argmin(torch.from_numpy(dhat).to(dev), src, dst,
                                 w, s, n=n)
        return P2PSolve(distance, pred_f, None, None, *counters)

    def _solve_bidir(self, graph, ell, pi, s, t, use_alt, want_pred):
        n = graph.n_nodes
        dev = ell.nbr.device
        if use_alt:
            pi32 = torch.from_numpy(pi.astype(np.int32)).to(dev)
            w_use = reduce_union(ell.w, ell.nbr, pi32, n)
        else:
            w_use = ell.w
        backend = _all_light_backend(ell.nbr, w_use, 2 * n, self.delta)
        tent0 = torch.full((2 * n,), _INF, dtype=torch.int32, device=dev)
        tent0[s] = 0
        tent0[t + n] = 0
        explored0 = torch.full((2 * n,), _INF, dtype=torch.int32, device=dev)
        out = _run_one_bidir(backend, tent0, explored0, n=2 * n,
                             packed=False, device=dev, all_light=True)
        counters = (out.outer_iters, out.inner_iters, out.overflow,
                    out.host_syncs)
        th = out.tent.cpu().numpy().astype(np.int64)
        f, b = th[:n], th[n:]
        fin = (f < _INF) & (b < _INF)
        sums = np.where(fin, f + b, np.int64(_INF))
        mu = int(sums.min())
        if mu >= _INF:
            return P2PSolve(_INF, None, None, None, *counters)
        meet = int(sums.argmin())
        distance = mu + (int(pi[s]) if use_alt else 0)
        pred_f = pred_b = None
        if want_pred:
            if use_alt:
                df = np.where(f < _INF, f + (pi[s] - pi), np.int64(_INF))
                db = np.where(b < _INF, b + pi, np.int64(_INF))
            else:
                df, db = f, b
            df = torch.from_numpy(np.minimum(df, _INF).astype(np.int32))
            db = torch.from_numpy(np.minimum(db, _INF).astype(np.int32))
            sf, tf, wf = self._coo_f
            sb, tb, wb = self._coo_b
            pred_f = pred_argmin(df.to(dev), sf, tf, wf, s, n=n)
            pred_b = pred_argmin(db.to(dev), sb, tb, wb, t, n=n)
        return P2PSolve(distance, pred_f, pred_b, meet, *counters)


__all__ = [
    "LANDMARK_MODES",
    "LandmarkSpec",
    "LandmarkState",
    "P2PSolve",
    "POTENTIAL_CLIP",
    "potentials",
    "reduce_forward",
    "reduce_union",
    "require_canonical",
]
