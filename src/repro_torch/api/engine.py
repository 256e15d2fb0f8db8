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
``PointToPoint`` in every mode: ``early_exit`` (the target settles, the
loop stops; the path comes from the predecessor tree) and the landmark
modes ``alt``, ``bidirectional`` and ``alt_bidirectional``
(``repro_torch.landmarks``, DESIGN.md §14: tables from
``Plan.prepare_landmarks`` or built on the first ALT query, solves on an
all-light ``EllBackend`` over the reduced or doubled graph, whatever
the plan's strategy; delta policy only); ``BoundedRadius``
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
of the same pair. A batch that lowers a weight below its landmark-table
build value drops the tables (``on_update="recompute"``) or is refused
before any weight changes (``"refuse"``, ``LandmarkRefused``).

Game maps: ``free_mask`` (bool[H, W], H * W = n) routes
``strategy='pallas'`` to the grid stencil ``kernels/grid_relax``; other
strategies ignore it, as in the reference. A grid plan refuses packed
words and non-delta policies with ``ValueError`` and edge-weight
updates with ``UpdateRefused(reason="grid_costs")``, as the reference
does.

Resolution (DESIGN.md §7/§10) happens in one place, ``Engine.plan``,
steered by the one ``tuning=`` knob, as in the reference: a concrete
``DeltaConfig`` with ``tuning=None`` is used as is; ``tuning="auto"`` /
``"measure"`` / a cache path / a ``Tuning(...)``, with any concrete
config as the tuning *base*, goes through ``tune.resolve_record`` on the
engine's device, which re-validates a tuning-chosen ``frontier_cap``
against ``plan(sources=...)`` (dropped on overflow) or drops it when the
plan cannot know its sources. The winning ``TuningRecord`` attaches to
the plan (``plan.record``, ``explain()["tuning_source"]``) and survives
``update``. ``Engine(graph)`` means ``tuning="auto"``; ``config="auto"``,
``tune=`` and ``tune_cache=`` are deprecated spellings of the same. With
a persistent cache, radius-stepping's radii persist beside it
(``<cache>.radii``).

Device: ``device=None`` means ``"cuda"``. Without a CUDA device the
engine raises unless the caller asked for ``device="cpu"``; it never
falls back to the CPU quietly. On CUDA the ``pallas`` and ``fused``
strategies launch the hand-written kernels; on the CPU their twins run.

Sharded strategies (``sharded_edge|ell|fused``, DESIGN.md §9): one
process per GPU, every rank builds the same plan and runs the same
queries; each relaxes its own shard and the collectives of
``torch.distributed`` merge the shards' words, so every host decision
(loop flags, the next bucket, stop predicates, the overflow fallback,
telemetry) reads replicated state. Plans, every query kind, the
overflow fallback (the twin widens the per-shard capacity) and updates
(``_rebuild_backend``'s default build; warm solves keep the plan's own
backend) go through ``Plan`` as on one device; ``explain()["n_shards"]``
is the config's. The shard count is the initialised process group's
size (1 without a group: one shard, no collective).
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from functools import partial
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.paths import extract_path, stitch_bidirectional_path
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
from repro_torch.core.policies import RadiiStore, make_policy
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


class LandmarkRefused(UpdateRefused):
    """Refusal of a weight batch that would invalidate the plan's
    landmark tables under the ``on_update="refuse"`` policy
    (``Plan.prepare_landmarks``): some new weight drops below its
    table-build value, so the ALT potentials would stop being
    admissible. Raised BEFORE any weight is applied — the plan and its
    tables are untouched.

    >>> try:
    ...     raise LandmarkRefused("no", reason="landmarks_stale")
    ... except UpdateRefused as e:
    ...     e.reason
    'landmarks_stale'
    """


@dataclasses.dataclass(frozen=True)
class Tuning:
    """The one tuning knob of ``Engine``: how the operating point is
    resolved. ``measure=True`` runs the successive-halving measured
    search (DESIGN.md §7); ``cache`` names the persistent fingerprint-
    keyed record store consulted first (and written back after a
    measured search). ``Tuning()`` is the zero-measurement estimator,
    spelled ``tuning="auto"``; ``tuning="measure"`` is
    ``Tuning(measure=True)``; any other string is a cache path.

    >>> Tuning(measure=True, cache="tuning.json").measure
    True
    """

    measure: bool = False
    cache: Optional[str] = None


def _normalize_tuning(tuning) -> Optional[Tuning]:
    if tuning is None or isinstance(tuning, Tuning):
        return tuning
    if isinstance(tuning, str):
        if tuning == "auto":
            return Tuning()
        if tuning == "measure":
            return Tuning(measure=True)
        return Tuning(cache=tuning)
    raise ValueError(
        "tuning must be None, 'auto', 'measure', a cache path or a "
        f"Tuning(...), got {tuning!r}"
    )


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
    ``resolve``. ``record`` is the ``TuningRecord`` the config came from
    (``None`` for a concrete config); ``radii_store`` a directory where
    radius-stepping's radii persist. ``host_syncs`` holds the host
    synchronisations of the last query (summed over its lanes, tiles, a
    fallback's two solves, or a warm re-solve's two runs when the repair
    twin overflowed)."""

    def __init__(self, graph: COOGraph, config: DeltaConfig, *,
                 free_mask=None, record=None, fallback: bool = False,
                 radii_store: Optional[str] = None):
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
        self.record = record
        self.device = graph.device
        self.backend = make_backend(graph, config, free_mask=free_mask)
        self._packed = config.pred_mode == "packed"
        # radius-stepping's radii persist beside the tuning cache when the
        # engine hands a store directory down
        self._radii = None if radii_store is None else RadiiStore(radii_store)
        self._policy = make_policy(graph, config, store=self._radii)
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
        # landmark residency (repro_torch.landmarks): made by
        # prepare_landmarks, or with the default spec on the first
        # landmark-mode PointToPoint
        self._landmarks = None

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
        ``cap`` to ``n`` (to the shard's vertex count on a sharded
        backend; the reference rebuilds the whole plan; the
        answers are the same). The resident state and the landmark
        state ride along: both depend on the graph, never on the cap."""
        twin = copy.copy(self)
        twin.config = dataclasses.replace(self.config, frontier_cap=None)
        twin.backend = self.backend.full_width()
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
        reference does. A batch that would drop a weight below its
        landmark-table build value under ``on_update="refuse"`` raises
        ``LandmarkRefused`` before any weight changes; otherwise the
        landmark state re-validates its tables after the swap. Returns
        ``self``."""
        if isinstance(self.backend, GridPallasBackend):
            raise UpdateRefused(
                "grid-stencil (game-map) plans take their costs from "
                "DeltaConfig.grid_costs, not the COO weight array; "
                "edge-weight updates do not apply to them",
                reason="grid_costs")
        states = self._landmark_states()
        if any(lm.spec.on_update == "refuse"
               and lm.would_invalidate(edge_ids, new_weights)
               for lm in states):
            # checked BEFORE applying: a refused batch leaves both the
            # weights and the landmark tables exactly as they were
            raise LandmarkRefused(
                "weight decrease below the landmark-table build values "
                "would invalidate the precomputed ALT potentials (plan "
                "prepared with on_update='refuse')",
                reason="landmarks_stale")
        graph = apply_weight_update(self.graph, edge_ids, new_weights)
        self._install(graph, self._rebuild_backend(graph))
        if self._demoted is not None:
            # the full-width twin shares the rebuilt blocks (and the
            # radius policy), as at demotion
            self._demoted._install(graph, self.backend.full_width(),
                                   self._policy)
        for lm in states:
            lm.note_update(graph)
        return self

    def _landmark_states(self) -> list:
        """The landmark states this plan's updates must keep honest: its
        own, and its full-width twin's where that one made its own (a
        landmark query answered after demotion)."""
        out = []
        for plan in (self, self._demoted):
            lm = None if plan is None else plan._landmarks
            if lm is not None and all(lm is not x for x in out):
                out.append(lm)
        return out

    def _install(self, graph: COOGraph, backend, policy=None) -> None:
        """Make ``graph`` (and its ``backend``) the plan's current one.
        Radius-stepping's step radii derive from the weights: recomputed
        (or taken as ``policy``) and the drivers rebound."""
        self.graph = graph
        self.backend = backend
        self._graph_version += 1
        if self.config.policy == "radius":
            self._policy = (policy if policy is not None
                            else make_policy(graph, self.config,
                                             store=self._radii))
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

    # -- landmark residency (repro_torch.landmarks, DESIGN.md §14) ---------

    def prepare_landmarks(
        self,
        k: int = 4,
        strategy: str = "farthest",
        seed: int = 0,
        *,
        store: Optional[str] = None,
        on_update: str = "recompute",
        build: bool = True,
    ) -> "Plan":
        """Attach landmark residency to the plan: ``k`` landmarks chosen
        by ``strategy`` (``farthest``/``random``), distance tables
        persisted in the fingerprint-keyed ``store`` directory (``None``
        = in-memory), and the ``on_update`` policy for weight batches
        that would invalidate the tables (``recompute`` drops and lazily
        rebuilds them; ``refuse`` rejects the batch with
        ``LandmarkRefused`` before applying it). ``build=False`` defers
        the precompute to the first landmark-mode query. Returns
        ``self``."""
        from repro_torch.landmarks import (LandmarkSpec, LandmarkState,
                                           require_canonical)

        spec = LandmarkSpec(k=k, strategy=strategy, seed=seed,
                            store=store, on_update=on_update)
        self._landmarks = LandmarkState(spec, self.config.delta)
        if build:
            # deferred builds re-check at the first landmark-mode query
            require_canonical(self.graph)
            self._landmarks.ensure_tables(self.graph)
        if self._demoted is not None:
            self._demoted._landmarks = self._landmarks
        return self

    def _landmark_state(self):
        """The plan's landmark residency, created with the default spec
        on first use (a landmark-mode query against an unprepared plan
        pays the table build lazily)."""
        if self._landmarks is None:
            from repro_torch.landmarks import LandmarkSpec, LandmarkState

            self._landmarks = LandmarkState(LandmarkSpec(), self.config.delta)
        return self._landmarks

    @property
    def landmark_tables(self):
        """The resident ``LandmarkTables``, or ``None`` when unprepared,
        not yet built, or invalidated by a weight update."""
        return None if self._landmarks is None else self._landmarks.tables

    def explain(self) -> dict:
        """Plan provenance: the operating point, the landmark count of
        the resident tables, the source of the tuning record it came from
        (``None`` for a concrete config), whether the overflow fallback
        has demoted the plan, and the resident source."""
        cfg = self.config
        return {
            "delta": cfg.delta,
            "strategy": cfg.strategy,
            "policy": cfg.policy,
            "pred_mode": cfg.pred_mode,
            "frontier_cap": cfg.frontier_cap,
            "n_shards": cfg.n_shards,
            "p2p_mode": cfg.p2p_mode,
            "landmarks": (None if self.landmark_tables is None
                          else self.landmark_tables.k),
            "tuning_source": (None if self.record is None
                              else self.record.source),
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
            return self._p2p_landmark(src, tgt, mode)
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

    def _p2p_landmark(self, src: int, tgt: int,
                      mode: str) -> PointToPointResult:
        """Goal-directed point-to-point (repro_torch.landmarks): the
        landmark state solves over a reduced / doubled graph and hands
        back original-space predecessor trees; the distance is bitwise
        the early-exit answer, and the path goes through the same
        cycle-guarded extractors as every other query."""
        if self.config.policy != "delta":
            raise ValueError(
                "landmark p2p modes (alt/bidirectional) run the bucket "
                "loop's all-light drivers and are delta-only; "
                f"policy={self.config.policy!r} plans answer "
                "PointToPoint via mode='early_exit'")
        want_pred = self.config.pred_mode != "none"
        r = self._landmark_state().solve_p2p(self.graph, src, tgt, mode,
                                             want_pred=want_pred)
        self.host_syncs = r.host_syncs
        tel = Telemetry(r.outer, r.inner, r.overflow)
        if r.distance >= _INF or not want_pred:
            return PointToPointResult(r.distance, None, tel)
        n = self.graph.n_nodes
        if r.pred_b is None:
            path = extract_path(r.pred_f.cpu().numpy(), src, tgt, n)
        else:
            path = stitch_bidirectional_path(
                r.pred_f.cpu().numpy(), r.pred_b.cpu().numpy(), src, tgt,
                r.meet, n)
        return PointToPointResult(r.distance, path, tel)

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
    mask), moved to ``device``, and the tuning inputs, and mints
    ``Plan``s. ``config`` is a concrete ``DeltaConfig`` (used as is, or
    as the tuning *base* whose non-searched fields carry into the
    resolved plan) or ``None``; ``tuning`` is ``None`` (the concrete
    config as is), ``"auto"`` (zero-measurement estimator),
    ``"measure"`` (measured search), a cache path, or a
    ``Tuning(measure=..., cache=...)``. ``Engine(graph)`` with neither
    means ``tuning="auto"``. ``config="auto"``, ``tune=True`` and
    ``tune_cache=path`` are deprecated spellings of the same."""

    def __init__(
        self,
        graph: COOGraph,
        config: Union[DeltaConfig, str, None] = None,
        *,
        free_mask=None,
        tuning: Union[Tuning, str, None] = None,
        tune: bool = False,
        tune_cache: Optional[str] = None,
        device=None,
    ):
        if isinstance(config, str):
            if config != "auto":
                raise ValueError(
                    f"unknown config string {config!r} (did you mean "
                    "'auto' or a DeltaConfig?)"
                )
            warnings.warn(
                "config='auto' is deprecated: use Engine(graph, "
                "tuning='auto') (or just Engine(graph))",
                DeprecationWarning,
                stacklevel=2,
            )
            config = None
            if tuning is None and not (tune or tune_cache is not None):
                tuning = "auto"
        if tune or tune_cache is not None:
            warnings.warn(
                "tune=/tune_cache= are deprecated: use tuning="
                "Tuning(measure=..., cache=...)",
                DeprecationWarning,
                stacklevel=2,
            )
            if tuning is None:
                tuning = Tuning(measure=bool(tune), cache=tune_cache)
        if config is None and tuning is None:
            tuning = "auto"  # Engine(graph) keeps its auto-resolve default
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.config = config
        self.free_mask = (None if free_mask is None else
                          free_mask_tensor(free_mask, self.device))
        self._tuning = _normalize_tuning(tuning)

    def plan(self, *, sources: Optional[Sequence[int]] = None,
             fallback: bool = False) -> Plan:
        """Resolve the operating point once and build the ``Plan``.
        ``sources`` are the vertices the caller will solve from: a
        tuning-chosen ``frontier_cap`` is validated against exactly
        those and dropped on overflow; ``sources=None`` drops a tuned
        cap outright. ``fallback=True`` arms the overflow fallback of a
        plan with a ``frontier_cap``."""
        cfg, record = self._resolve(sources)
        return Plan(self.graph, cfg, free_mask=self.free_mask, record=record,
                    fallback=fallback, radii_store=self._radii_store_path())

    def _radii_store_path(self) -> Optional[str]:
        """Radius-stepping's radii live beside the tuning cache
        (``<cache>.radii/``) when the engine has a persistent cache."""
        if self._tuning is not None and self._tuning.cache:
            return f"{self._tuning.cache}.radii"
        return None

    def _resolve(self, sources):
        if self._tuning is None:
            return self.config, None  # concrete config, no tuning: as is
        from repro_torch.tune import resolve_record  # tune builds on core

        base = DeltaConfig() if self.config is None else self.config
        return resolve_record(
            self.graph,
            base,
            free_mask=self.free_mask,
            cache_path=self._tuning.cache,
            measure=self._tuning.measure,
            sources=sources,
            device=self.device,
        )


__all__ = ["Engine", "LandmarkRefused", "Plan", "Tuning", "UpdateRefused",
           "resolve_device"]
