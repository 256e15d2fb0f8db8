"""Warm-start repair planning (counterpart of ``repro.dynamic.repair``,
DESIGN.md §11).

After a plan has solved ``SingleSource(s)`` once, a weight perturbation
does not invalidate the whole tentative-distance array — it invalidates
a bounded region, and the bucket structure is exactly the machinery
that re-settles that region cheaply. This module computes, on the host
in numpy (the reference's arithmetic), the warm ``(tent0, explored0)``
state the bucket loop (``core.delta_stepping._run_one_warm``) is
entered with:

* **decreases** seed their endpoint's tent directly with the improved
  candidate word — the vertex lands in its *new* bucket, satisfies the
  frontier rule ``tent < explored`` and re-relaxes from there;
* **increases** reset every vertex whose shortest path might have used
  a worsened edge — the predecessor-tree descendants of each *suspect
  root* (a tree child across an increased edge) — to INF and re-seed it
  from the cone boundary, with *updated* weights.

The repaired warm solve converges to exactly the state a cold solve of
the updated graph converges to: dist always, and packed (cost, pred)
words on the canonical-ties class (all weights >= 1). ``plan_repair``
refuses, with a reason, the cases outside that contract: packed mode on
zero-weight graphs, increases without a predecessor tree, and a
resident solve that tripped the overflow flag.

The resident state is the plan's device tensors; ``plan_repair`` moves
what it needs to the host. ``src``/``dst`` may already lie there (a
plan keeps one host copy of its fixed topology), as int32 or int64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pack as packing
from repro_torch.graphs.structures import COOGraph, INF32

_INF = int(INF32)
_MASK32 = packing.MASK32
_INF_PACKED = packing.INF_PACKED


def _host(x, dtype) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a host array of
    ``dtype``; no copy where it already is one."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


@dataclasses.dataclass(frozen=True)
class Resident:
    """The state a ``Plan`` keeps resident after a ``SingleSource``
    solve: converged distances and predecessors, the weight tensor they
    were solved against (updates are diffed against it, so update
    batches compose; ``apply_weight_update`` never writes it), and the
    overflow flag (an overflowed resident state is not trustworthy
    warm-start material). Tensors on the plan's device."""

    source: int
    dist: torch.Tensor      # int32[n], INF32 sentinel
    pred: torch.Tensor      # int32[n], -1 sentinel
    w: torch.Tensor         # int32[E] weights at solve time
    overflow: bool


@dataclasses.dataclass(frozen=True)
class RepairPlan:
    """Warm entry state for the bucket loop plus its telemetry counts.
    ``repaired == 0`` means the update batch was distance-neutral (no
    effective weight change) and the resident answer stands as-is."""

    tent0: Optional[np.ndarray]      # int32[n] dist or int64[n] packed words
    explored0: Optional[np.ndarray]  # int32[n]
    cone: int                        # vertices reset by the increase cone
    repaired: int                    # cone + directly re-seeded vertices


def resident_words(dist, pred, source: int, packed: bool) -> np.ndarray:
    """Reconstruct the converged tent-word array from (dist, pred) —
    bit for bit what the solver's final state held: ``pack(dist, pred)``
    for reachable vertices, ``pack(0, source)`` at the source (the cold
    init word, which ``_finish_pred``'s -1 masking hides), INF words for
    unreachable vertices."""
    dist = _host(dist, np.int64)
    if not packed:
        return np.where(dist < _INF, dist, _INF).astype(np.int32)
    pred = _host(pred, np.int64)
    words = np.where(
        dist < _INF,
        (dist << 32) | (pred & _MASK32),
        np.int64(_INF_PACKED),
    ).astype(np.int64)
    words[source] = np.int64(source)          # pack(0, source)
    return words


def _grow_descendants(in_cone: np.ndarray, pred: np.ndarray, n: int) -> None:
    """Mark every pred-tree descendant of the vertices already set in
    ``in_cone`` (in place). Level-order BFS over a sorted child list:
    O(n log n) to build the list once plus O(level size) per level. Safe
    on a cyclic pred array (the argmin zero-weight hazard): marked
    vertices are never re-expanded."""
    kids = np.nonzero(pred >= 0)[0]
    if kids.size == 0:
        return
    order = np.argsort(pred[kids], kind="stable")
    kids_s = kids[order]
    par_s = pred[kids][order]
    begins = np.searchsorted(par_s, np.arange(n))
    ends = np.searchsorted(par_s, np.arange(n) + 1)
    frontier = np.nonzero(in_cone)[0]
    while frontier.size:
        b0, cnt = begins[frontier], ends[frontier] - begins[frontier]
        total = int(cnt.sum())
        if total == 0:
            break
        # vectorized multi-range gather of every frontier vertex's kids
        csum = np.cumsum(cnt)
        idx = np.arange(total) + np.repeat(b0 - (csum - cnt), cnt)
        children = kids_s[idx]
        frontier = children[~in_cone[children]]
        in_cone[frontier] = True


def plan_repair(
    graph: COOGraph, resident: Resident, *, pred_mode: str
) -> Tuple[Optional[RepairPlan], Optional[str]]:
    """Diff the graph's current weights against the resident snapshot
    and compute the warm entry state. Returns ``(plan, reason)``:
    ``reason`` explains why the update lies outside the warm contract
    and the caller must re-solve cold."""
    packed = pred_mode == "packed"
    n = graph.n_nodes
    source = int(resident.source)
    if resident.overflow:
        return None, "resident solve tripped the frontier-cap overflow flag"
    w_new = _host(graph.w, np.int32)
    w_old = _host(resident.w, np.int32)
    if packed and (int(w_old.min(initial=1)) < 1
                   or int(w_new.min(initial=1)) < 1):
        return None, (
            "packed (cost, pred) repair needs the canonical-ties graph "
            "class (all weights >= 1, DESIGN.md §11)"
        )

    changed = np.nonzero(w_new != w_old)[0]
    if changed.size == 0:
        return RepairPlan(None, None, 0, 0), None
    increased = changed[w_new[changed] > w_old[changed]]
    decreased = changed[w_new[changed] < w_old[changed]]
    if increased.size and pred_mode == "none":
        return None, (
            "weight increases need the predecessor tree to bound the "
            "repair cone; pred_mode='none' tracks none"
        )
    src = _host(graph.src, np.int64)
    dst = _host(graph.dst, np.int64)
    dist = _host(resident.dist, np.int64)
    pred = _host(resident.pred, np.int64)

    # increase cone: pred-tree descendants of every suspect root (a tree
    # child across an increased edge). Over-approximate — a suspect whose
    # duplicate-edge tightness survives just costs re-settling work.
    in_cone = np.zeros(n, bool)
    if increased.size:
        a, b = src[increased], dst[increased]
        hit = (b != source) & (pred[b] == a)
        in_cone[b[hit]] = True
        if in_cone.any():
            _grow_descendants(in_cone, pred, n)
    cone = int(in_cone.sum())

    base = resident_words(dist, pred, source, packed)
    tent0 = base.copy()
    explored0 = np.where(dist < _INF, dist, _INF).astype(np.int32)
    if cone:
        tent0[in_cone] = np.int64(_INF_PACKED) if packed else np.int32(_INF)
        explored0[in_cone] = np.int32(_INF)

    # seeds: (a) every edge entering the cone from a settled outside
    # vertex (updated weights — the cone's whole re-entry surface, heavy
    # edges included, since settled vertices never re-enter the
    # frontier); (b) every decreased edge whose source is outside the
    # cone (its old distance is still a valid upper bound there).
    live = dist[src] < _INF
    mask = live & ~in_cone[src] & in_cone[dst]
    if decreased.size:
        mdec = np.zeros(src.shape[0], bool)
        mdec[decreased] = True
        mask |= mdec & live & ~in_cone[src]
    e = np.nonzero(mask)[0]
    if e.size:
        cand = dist[src[e]] + w_new[e].astype(np.int64)
        keep = cand < _INF
        e, cand = e[keep], cand[keep]
    if e.size:
        if packed:
            words = (cand << 32) | (src[e] & _MASK32)
            np.minimum.at(tent0, dst[e], words)
        else:
            np.minimum.at(tent0, dst[e], cand.astype(np.int32))
    seeded = int(np.count_nonzero((tent0 != base) & ~in_cone))
    if cone == 0 and seeded == 0:
        # weight churn with no effect on any settled upper bound
        return RepairPlan(None, None, 0, 0), None
    return RepairPlan(tent0, explored0, cone, cone + seeded), None


__all__ = ["Resident", "RepairPlan", "plan_repair", "resident_words"]
