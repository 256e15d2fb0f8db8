"""Landmark selection and distance-table precompute (counterpart of
``repro.landmarks.tables``, DESIGN.md §14).

A landmark table holds, for ``k`` chosen vertices ``L``, both distance
rows the ALT potentials need on a directed graph: ``d_out[L, v] =
dist(L -> v)`` and ``d_in[L, v] = dist(v -> L)``. Both rows of one
landmark come out of ONE batched solve over the disjoint union of the
graph with its reversed copy (``graphs.union_with_reverse``): lane
``L`` in the forward half yields the out-row, lane ``L + n`` in the
reversed half the in-row — the ``[B, n]`` loop of ``_run_many_vmapped``
on the ``edge`` backend, so table entries are the engine's own
distances. The rows come back to the host as numpy arrays.

Selection strategies (Goldberg & Harrelson):

* ``random``   — ``k`` distinct vertices from a seeded generator; one
  batched solve computes all ``2k`` rows.
* ``farthest`` — greedy k-center on the table rows themselves: each new
  landmark maximizes the minimum (in/out) distance to the chosen set.

Both draw from ``np.random.default_rng(seed)`` in the reference's call
order, so picks and rows are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.backends import EdgeBackend
from repro_torch.core.delta_stepping import DeltaConfig, _run_many_vmapped
from repro_torch.graphs.structures import COOGraph, INF32, union_with_reverse

SELECT_STRATEGIES = ("farthest", "random")


@dataclasses.dataclass(frozen=True)
class LandmarkTables:
    """Precomputed landmark distance rows for one (graph, selection)
    pair, as host arrays. ``fingerprint`` is the estimator's structural
    fingerprint (``tune.estimator.fingerprint``); ``whash`` a content
    hash of the exact (src, dst, w) arrays — a table reused across
    same-fingerprint graphs with other weights would move *answers*, so
    the store keys on both. ``d_out``/``d_in`` are int32[k, n] with the
    INF32 unreachable sentinel."""

    fingerprint: str
    whash: str
    strategy: str
    seed: int
    landmarks: np.ndarray   # int32[k]
    d_out: np.ndarray       # int32[k, n]: dist(L -> v)
    d_in: np.ndarray        # int32[k, n]: dist(v -> L)

    @property
    def k(self) -> int:
        return int(self.landmarks.shape[0])

    @property
    def n(self) -> int:
        return int(self.d_out.shape[1])


def graph_whash(graph: COOGraph) -> str:
    """Content hash of the exact edge arrays: SHA-1 over the int32 bytes
    of ``src``, ``dst``, ``w`` (the reference's digest)."""
    h = hashlib.sha1()
    for t in (graph.src, graph.dst, graph.w):
        h.update(np.ascontiguousarray(t.cpu().numpy(), np.int32).tobytes())
    return h.hexdigest()[:16]


def _solve_rows(union: COOGraph, sources, delta: int) -> np.ndarray:
    """Distance rows of a batch of union-graph sources, through the
    engine's batched loop on the ``edge`` backend (pred-free)."""
    cfg = DeltaConfig(delta=delta, strategy="edge", pred_mode="none")
    backend = EdgeBackend.build(union, cfg)
    out = _run_many_vmapped(backend, [int(s) for s in sources],
                            n=union.n_nodes, packed=False,
                            device=union.device)
    return out.tent.cpu().numpy().astype(np.int32)


def select_landmarks(
    graph: COOGraph,
    k: int,
    strategy: str = "farthest",
    seed: int = 0,
    delta: int = 10,
):
    """Pick ``k`` landmarks and return ``(landmarks, d_out, d_in)``
    (host arrays). :func:`build_tables` is the packaged entry point."""
    if strategy not in SELECT_STRATEGIES:
        raise ValueError(f"unknown landmark strategy {strategy!r}")
    n = graph.n_nodes
    k = max(1, min(int(k), n))
    rng = np.random.default_rng(seed)
    union = union_with_reverse(graph)
    if strategy == "random":
        lms = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
        rows = _solve_rows(union, np.concatenate([lms, lms + n]), delta)
        return lms, rows[:k, :n], rows[k:, n:]
    # farthest: greedy k-center on min(in, out) distance to the chosen set
    lms = [int(rng.integers(n))]
    outs, ins = [], []
    cover = np.full(n, np.iinfo(np.int64).max, np.int64)
    while True:
        L = lms[-1]
        rows = _solve_rows(union, [L, L + n], delta)
        d_out_row = rows[0, :n]
        d_in_row = rows[1, n:]
        outs.append(d_out_row)
        ins.append(d_in_row)
        if len(lms) == k:
            break
        both = np.minimum(d_out_row.astype(np.int64),
                          d_in_row.astype(np.int64))
        cover = np.minimum(cover, both)
        cand = cover.copy()
        cand[np.asarray(lms)] = -1          # never re-pick a landmark
        finite = cand < int(INF32)
        if finite.any():
            cand[~finite] = -1
            nxt = int(cand.argmax())
        else:                               # chosen set sees nothing new:
            free = np.setdiff1d(np.arange(n), np.asarray(lms))
            nxt = int(rng.choice(free))     # fall back to a random pick
        lms.append(nxt)
    order = np.argsort(np.asarray(lms))
    return (
        np.asarray(lms, np.int32)[order],
        np.stack(outs)[order].astype(np.int32),
        np.stack(ins)[order].astype(np.int32),
    )


def build_tables(
    graph: COOGraph,
    *,
    k: int = 4,
    strategy: str = "farthest",
    seed: int = 0,
    delta: int = 10,
    fingerprint: str = "",
) -> LandmarkTables:
    """Select landmarks and precompute their distance rows. ``delta``
    steers the solves only (any value is exact); ``fingerprint`` is
    attached verbatim (computed once by the caller, so the
    O(diameter·|E|) probe is not re-paid per build)."""
    lms, d_out, d_in = select_landmarks(
        graph, k, strategy=strategy, seed=seed, delta=delta)
    return LandmarkTables(
        fingerprint=fingerprint,
        whash=graph_whash(graph),
        strategy=strategy,
        seed=int(seed),
        landmarks=lms,
        d_out=d_out,
        d_in=d_in,
    )


__all__ = [
    "LandmarkTables",
    "SELECT_STRATEGIES",
    "build_tables",
    "graph_whash",
    "select_landmarks",
]
