"""Reference SSSP oracles of the PyTorch port (host-side, numpy/heapq) —
a copy of ``repro.core.ref``, so the port verifies without importing the
reference package.

``dijkstra`` mirrors the Boost Graph Library baseline the paper compares
against (binary-heap Dijkstra, O(|V| log |V| + |E|)); ``bellman_ford`` is
a second independent oracle used by the property-based tests so that a
bug in one reference cannot mask an engine bug. Graph arrays may be torch
tensors on any device; they are copied to the host.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

from repro_torch.graphs.structures import COOGraph, INF32

__all__ = ["dijkstra", "bellman_ford", "validate_pred_tree",
           "walk_pred_tree"]


def _np(t) -> np.ndarray:
    """Host numpy copy of a graph array (torch tensor on any device)."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _to_adj(g: COOGraph):
    src = _np(g.src)
    dst = _np(g.dst)
    w = _np(g.w)
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    row_ptr = np.zeros(g.n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=g.n_nodes), out=row_ptr[1:])
    return row_ptr, dst, w


def dijkstra(g: COOGraph, source: int) -> Tuple[np.ndarray, np.ndarray]:
    """Binary-heap Dijkstra. Returns (dist int64[n] with INF32 sentinel,
    pred int32[n] with -1 for unreachable/source)."""
    row_ptr, dst, w = _to_adj(g)
    n = g.n_nodes
    dist = np.full(n, int(INF32), dtype=np.int64)
    pred = np.full(n, -1, dtype=np.int32)
    dist[source] = 0
    heap = [(0, source)]
    done = np.zeros(n, dtype=bool)
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(row_ptr[u], row_ptr[u + 1]):
            v = dst[e]
            nd = d + int(w[e])
            if nd < dist[v]:
                dist[v] = nd
                pred[v] = u
                heapq.heappush(heap, (nd, v))
    return dist, pred


def bellman_ford(g: COOGraph, source: int) -> np.ndarray:
    """Vectorized Bellman-Ford over the edge list. O(V·E) worst case but
    each round is a single numpy sweep; fine at test sizes."""
    src = _np(g.src).astype(np.int64)
    dst = _np(g.dst).astype(np.int64)
    w = _np(g.w).astype(np.int64)
    n = g.n_nodes
    dist = np.full(n, int(INF32), dtype=np.int64)
    dist[source] = 0
    for _ in range(n):
        cand = dist[src] + w
        nxt = dist.copy()
        np.minimum.at(nxt, dst, cand)
        if np.array_equal(nxt, dist):
            break
        dist = nxt
    return dist


def validate_pred_tree(g: COOGraph, source: int, dist: np.ndarray,
                       pred: np.ndarray) -> bool:
    """Check that ``pred`` encodes a valid shortest-path tree for ``dist``:
    every reachable non-source v has an edge (pred[v], v) with
    dist[pred[v]] + w == dist[v]. (Multiple valid trees exist; we check
    validity, not equality with the oracle's tree.)"""
    src = _np(g.src)
    dst = _np(g.dst)
    w = _np(g.w).astype(np.int64)
    edge_w: dict[tuple[int, int], int] = {}
    for s, d, ww in zip(src, dst, w):
        key = (int(s), int(d))
        edge_w[key] = min(edge_w.get(key, 1 << 62), int(ww))
    for v in range(g.n_nodes):
        if v == source or dist[v] >= int(INF32):
            continue
        p = int(pred[v])
        if p < 0:
            return False
        key = (p, v)
        if key not in edge_w:
            return False
        if dist[p] + edge_w[key] != dist[v]:
            return False
    return True


def walk_pred_tree(g: COOGraph, source: int, dist: np.ndarray,
                   pred: np.ndarray) -> bool:
    """Stronger check than :func:`validate_pred_tree`: *walk* the pred
    chain of every reachable vertex all the way to the source — the
    chains must be acyclic (a tree rooted at the source, <= n hops) and
    the accumulated edge weights along each chain must reproduce
    ``dist`` exactly. This is the global invariant a torn (cost, pred)
    write (the paper's C3 worry) or a stale-parent race (C4) would
    break while leaving every *individual* edge locally consistent."""
    src = _np(g.src)
    dst = _np(g.dst)
    w = _np(g.w).astype(np.int64)
    edge_w: dict[tuple[int, int], int] = {}
    for s, d, ww in zip(src, dst, w):
        key = (int(s), int(d))
        edge_w[key] = min(edge_w.get(key, 1 << 62), int(ww))
    n = g.n_nodes
    for v in range(n):
        if v == source or dist[v] >= int(INF32):
            continue
        acc = 0
        u = v
        for _ in range(n):                      # > n hops = a cycle
            p = int(pred[u])
            if p < 0:
                return False                    # chain broke off-tree
            key = (p, u)
            if key not in edge_w:
                return False                    # pred edge not in graph
            acc += edge_w[key]
            u = p
            if u == source:
                break
        else:
            return False                        # never reached the source
        if acc != int(dist[v]):
            return False                        # weights don't reproduce dist
    return True
