"""The query algebra and typed results of the Query/Plan façade — a copy
of ``repro.api.queries`` (plain dataclasses). ``Plan.solve`` answers
every kind, ``PointToPoint``'s landmark modes included.

A query names *what* to compute against a planned graph; the ``Plan``
(engine.py) decides *how* — which pre-lowered solve loop runs and
which early-exit rule applies (DESIGN.md §10):

* ``SingleSource``  — the paper's kernel: full distance vector (+ tree).
* ``MultiSource``   — batched sources, one vmapped program; lane ``i``
  is bitwise identical to ``SingleSource(sources[i])``.
* ``PointToPoint``  — one (source, target) pair with early exit once
  the target's bucket settles (Kainer & Träff 2019): a settled bucket
  bounds all later tent values, so the target's distance is final as
  soon as its bucket index drops below the next bucket to process.
* ``BoundedRadius`` — all vertices within distance ``radius`` of the
  source (nearest-POI workloads); the outer loop stops at the first
  bucket past ``radius // delta`` and everything farther reports as
  unreachable.
* ``ManyToMany``    — an |S| x |T| distance matrix assembled from tiled
  multi-source solves (betweenness/matrix workloads); every tile runs
  the same compiled multi-source program.
* ``UpdateBatch``   — a dynamic-graph edge-cost update plus re-solve of
  the plan's resident single-source problem (DESIGN.md §11); with
  ``warm=True`` the re-solve repairs from the previous answer instead
  of starting cold, bitwise identically.

Every result carries a ``Telemetry`` record of what the solve actually
did — buckets processed, light-phase inner iterations, the compacted-
frontier overflow flag, whether the plan's overflow fallback re-solved
the query full-width, and (for dynamic re-solves) how many vertices the
warm repair actually touched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class SingleSource:
    """Full SSSP from one source: distance vector + predecessor tree.

    Solving it also establishes the plan's *resident* state — the
    starting point ``Plan.update`` / ``Plan.resolve`` repair from.

    >>> SingleSource(7)
    SingleSource(source=7)
    """

    source: int


@dataclasses.dataclass(frozen=True)
class MultiSource:
    """Batched SSSP from several sources (one vmapped program; each
    lane is bitwise identical to the corresponding ``SingleSource``).

    >>> MultiSource([0, 3, 5]).sources
    [0, 3, 5]
    """

    sources: Sequence[int]


@dataclasses.dataclass(frozen=True)
class PointToPoint:
    """One source -> target distance (and path, when the plan tracks
    predecessors). ``mode`` picks the point-to-point algorithm
    (``core.P2P_MODES``): ``early_exit`` stops once the target's bucket
    settles; ``alt`` / ``bidirectional`` / ``alt_bidirectional`` are the
    goal-directed landmark modes (repro.landmarks, DESIGN.md §14) — all
    four return bitwise-identical distances. ``None`` defers to the
    plan's ``DeltaConfig.p2p_mode`` (tunable, see ``tune.tune_p2p``).

    >>> q = PointToPoint(source=0, target=42)
    >>> (q.source, q.target, q.mode)
    (0, 42, None)
    """

    source: int
    target: int
    mode: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BoundedRadius:
    """Distances of every vertex within ``radius`` of the source;
    vertices farther than ``radius`` report as unreachable.

    >>> BoundedRadius(0, 150).radius
    150
    """

    source: int
    radius: int


@dataclasses.dataclass(frozen=True)
class ManyToMany:
    """|S| x |T| distance matrix, assembled from multi-source solves
    tiled ``tile`` sources at a time (default: min(|S|, 8)).

    >>> ManyToMany(sources=[0, 1], targets=[5, 6, 7]).tile is None
    True
    """

    sources: Sequence[int]
    targets: Sequence[int]
    tile: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """Edge-cost update batch + re-solve of the resident single-source
    problem: ``plan.solve(UpdateBatch(ids, weights))`` is exactly
    ``plan.update(ids, weights)`` followed by ``plan.resolve(warm=...)``
    and returns the refreshed ``SingleSourceResult``. ``edge_ids`` index
    the graph's COO edge arrays; topology never changes, only costs.

    >>> UpdateBatch(edge_ids=[3, 9], new_weights=[12, 1])
    UpdateBatch(edge_ids=[3, 9], new_weights=[12, 1], warm=True)
    """

    edge_ids: Sequence[int]
    new_weights: Sequence[int]
    warm: bool = True


Query = Union[
    SingleSource,
    MultiSource,
    PointToPoint,
    BoundedRadius,
    ManyToMany,
    UpdateBatch,
]


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """What one solve actually did. ``buckets`` / ``inner_iters`` /
    ``overflow`` are the solve loop's raw counters (host ints and a bool in
    the port; jax scalars in the reference, or arrays
    with a leading batch axis for ``MultiSource``); ``fallback`` is True
    when the plan's overflow fallback answered the query full-width.

    The dynamic-update fields describe a ``Plan.resolve`` /
    ``UpdateBatch`` re-solve: ``warm`` is True when the answer came from
    the warm-start repair path (False: cold re-solve, e.g. an update
    outside the warm contract); ``repaired`` counts the vertices the
    repair re-seeded or reset, of which ``cone`` were reset by the
    increase cone — both ``None`` on ordinary queries.

    >>> t = Telemetry(buckets=4, inner_iters=9, overflow=False)
    >>> (t.fallback, t.warm, t.repaired, t.cone)
    (False, False, None, None)
    """

    buckets: Any
    inner_iters: Any
    overflow: Any
    fallback: bool = False
    warm: bool = False
    repaired: Optional[int] = None
    cone: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SingleSourceResult:
    """``dist`` int32[n] (INF32 = unreachable), ``pred`` int32[n]
    (-1 = source/unreachable) — bitwise identical to the deprecated
    ``DeltaSteppingSolver.solve`` fields."""

    dist: Any
    pred: Any
    telemetry: Telemetry


@dataclasses.dataclass(frozen=True)
class MultiSourceResult:
    """Per-lane ``dist`` int32[B, n] / ``pred`` int32[B, n] — bitwise
    identical to the deprecated ``DeltaSteppingSolver.solve_many``."""

    dist: Any
    pred: Any
    telemetry: Telemetry


@dataclasses.dataclass(frozen=True)
class PointToPointResult:
    """``distance`` is a host int (INF32 sentinel when unreachable);
    ``path`` is the source->target vertex list, or None when the target
    is unreachable or the plan tracks no predecessors."""

    distance: int
    path: Optional[List[int]]
    telemetry: Telemetry


@dataclasses.dataclass(frozen=True)
class BoundedRadiusResult:
    """``dist``/``pred`` filtered to the radius: vertices with
    dist > radius carry the INF32 / -1 sentinels (their true distances
    were never settled — the whole point of the early exit)."""

    dist: Any
    pred: Any
    radius: int
    telemetry: Telemetry


@dataclasses.dataclass(frozen=True)
class ManyToManyResult:
    """``matrix`` int64[|S|, |T|] host array with the INF32 sentinel for
    unreachable pairs; telemetry aggregates across tiles (max buckets,
    summed inner iterations, any-overflow)."""

    matrix: Any
    telemetry: Telemetry


Result = Union[
    SingleSourceResult,
    MultiSourceResult,
    PointToPointResult,
    BoundedRadiusResult,
    ManyToManyResult,
]

__all__ = [
    "BoundedRadius",
    "BoundedRadiusResult",
    "ManyToMany",
    "ManyToManyResult",
    "MultiSource",
    "MultiSourceResult",
    "PointToPoint",
    "PointToPointResult",
    "Query",
    "Result",
    "SingleSource",
    "SingleSourceResult",
    "Telemetry",
    "UpdateBatch",
]
