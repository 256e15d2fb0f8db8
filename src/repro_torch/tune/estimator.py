"""Heuristic Δ estimation from graph statistics (counterpart of
``repro.tune.estimator``, DESIGN.md §7).

Meyer & Sanders' analysis puts the useful bucket width at Δ = Θ(w̄/d̄):
wide enough that a bucket holds real parallel work, narrow enough that
re-relaxation stays bounded. ``DELTA_C = 12`` lands on the paper's
hand-picked Δ = 10 for both small-world and R-MAT instances.

Everything here is host-side numpy over host copies of the COO
tensors, the reference's arithmetic line for line. ``GraphStats`` is
also the key material of the tuning cache and the landmark store
(``fingerprint``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.backends import group_size
from repro_torch.graphs.structures import COOGraph

# Calibration constant of the Δ ≈ c·w̄/d̄ rule (see module docstring).
DELTA_C = 12.0

# Fallback Δ when the graph has no edges at all (any value is correct:
# a single bucket settles the source and the loop terminates).
DEFAULT_DELTA = 10

# Log-degree histogram buckets: deg 0, 1, 2-3, 4-7, ..., >= 128.
_HIST_BUCKETS = 9

# BFS level cap for the eccentricity probe: beyond this the hop-radius
# bucket saturates (keeps the probe O(cap·|E|) on huge long graphs).
_ECC_CAP = 1024


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Host-side summary of a ``COOGraph`` — the estimator's input and
    the cache- and store-key material."""

    n_nodes: int
    n_edges: int
    mean_degree: float
    max_degree: int
    degree_hist: Tuple[int, ...]  # log2-bucketed out-degree counts
    w_min: int
    w_max: int
    w_mean: float
    ecc0: int  # BFS eccentricity of vertex 0 (hop-diameter proxy);
    #            -1 = not probed (heuristic-only stats, no cache key)


def _bfs_eccentricity(src, dst, n: int, start: int = 0) -> int:
    """Unweighted BFS level count from ``start``: a cheap hop-diameter
    proxy. Degree statistics alone cannot tell a long-diameter graph
    from a short one, and diameter moves Δ's optimum (paper Fig. 1), so
    the fingerprint must see it."""
    visited = np.zeros(n, bool)
    visited[start] = True
    frontier = visited.copy()
    levels = 0
    while levels < _ECC_CAP:
        nxt = np.zeros(n, bool)
        nxt[dst[frontier[src]]] = True
        nxt &= ~visited
        if not nxt.any():
            break
        visited |= nxt
        frontier = nxt
        levels += 1
    return levels


def graph_stats(graph: COOGraph, probe_ecc: bool = True) -> GraphStats:
    """Compute ``GraphStats`` on the host. ``probe_ecc=False`` skips the
    O(diameter·|E|) BFS probe — enough for the Δ estimate but not for a
    fingerprint."""
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    w = graph.w.cpu().numpy()
    n, m = graph.n_nodes, int(src.shape[0])
    if m == 0:
        hist = [n] + [0] * (_HIST_BUCKETS - 1)
        return GraphStats(n, 0, 0.0, 0, tuple(hist), 0, 0, 0.0, 0)
    deg = np.bincount(src, minlength=n)
    # bucket index: 0 for deg 0, else 1 + floor(log2(deg)), capped
    idx = np.zeros(n, np.int64)
    nz = deg > 0
    idx[nz] = 1 + np.log2(deg[nz]).astype(np.int64)
    idx = np.minimum(idx, _HIST_BUCKETS - 1)
    hist = np.bincount(idx, minlength=_HIST_BUCKETS)
    return GraphStats(
        n_nodes=n,
        n_edges=m,
        mean_degree=float(m) / max(n, 1),
        max_degree=int(deg.max()),
        degree_hist=tuple(int(c) for c in hist),
        w_min=int(w.min()),
        w_max=int(w.max()),
        w_mean=float(w.mean()),
        ecc0=_bfs_eccentricity(src, dst, n) if probe_ecc else -1,
    )


def estimate_delta(stats: GraphStats, c: float = DELTA_C) -> int:
    """Zero-measurement bucket width: Δ ≈ c·w̄/d̄, clamped to
    [1, 4·w_max]. Always finite, even on degenerate graphs."""
    if stats.n_edges == 0 or stats.mean_degree <= 0:
        return DEFAULT_DELTA
    delta = c * stats.w_mean / stats.mean_degree
    hi = max(1, 4 * stats.w_max)
    return int(np.clip(round(delta), 1, hi))


def _device_term(device) -> str:
    """``torch-<type><count>``: the framework, and the device type the
    graph lives on with the number of such devices visible; in a
    process group of more than one rank ``-r<ranks>`` follows, so a
    record measured on 4 ranks never keys a 1-rank run."""
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    ranks = group_size()
    return f"torch-{dev.type}{count}" + (f"-r{ranks}" if ranks > 1 else "")


def fingerprint(stats: GraphStats, device) -> str:
    """Stable key of structural statistics (not edge identity): the
    reference's string up to ``:dev=``, character for character. The
    reference ends in ``jax.device_count()``; the port names the
    framework and ``device``'s type and count instead (``torch-cuda1``,
    ``torch-cpu1``; ``-r<ranks>`` appended in a group of more than one
    rank), so a key built by one package never matches a key built by
    the other, nor one built for other hardware or another group size."""
    if stats.ecc0 < 0:
        raise ValueError(
            "stats were computed with probe_ecc=False — no cache key "
            "without the hop-radius term"
        )
    hist = ",".join(str(c) for c in stats.degree_hist)
    ecc = 0 if stats.ecc0 == 0 else 1 + int(np.log2(stats.ecc0))
    return (
        f"v5:n={stats.n_nodes}:m={stats.n_edges}"
        f":deg={hist}:w={stats.w_min}-{stats.w_max}:ecc={ecc}"
        f":dev={_device_term(device)}"
    )


__all__ = [
    "DEFAULT_DELTA",
    "DELTA_C",
    "GraphStats",
    "estimate_delta",
    "fingerprint",
    "graph_stats",
]
