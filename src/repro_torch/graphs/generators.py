"""Synthetic graph generators of the PyTorch port (counterpart of
``repro.graphs.generators``).

Host-side numpy with the reference's exact ``np.random.default_rng``
call order, so every generator returns arrays equal to the reference's
for the same seed. Weight conventions follow the paper (§4):

* small-world / scale-free: integer weights from U(1, 20);
* game maps: 10 for straight moves, 14 for diagonal moves;
* lattices: unit or U(1, 20) weights.

Every generator takes ``device`` (default CPU) for the returned tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graphs.structures import COOGraph, coo_from_numpy

__all__ = [
    "watts_strogatz",
    "rmat",
    "grid_map",
    "square_lattice",
    "random_graph",
]


def _uniform_weights(rng: np.random.Generator, m: int,
                     lo: int = 1, hi: int = 20) -> np.ndarray:
    return rng.integers(lo, hi + 1, size=m, dtype=np.int32)


def watts_strogatz(n: int, k: int, p: float, seed: int = 0,
                   w_lo: int = 1, w_hi: int = 20, device="cpu") -> COOGraph:
    """Watts–Strogatz small-world graph: ring lattice with ``k`` nearest
    neighbours, one endpoint of each lattice edge rewired with
    probability ``p``; self loops dropped, rare duplicates kept, both
    directions emitted with the same weight."""
    if k % 2 != 0:
        raise ValueError("k must be even for a ring lattice")
    rng = np.random.default_rng(seed)
    half = k // 2
    u = np.repeat(np.arange(n, dtype=np.int64), half)
    offs = np.tile(np.arange(1, half + 1, dtype=np.int64), n)
    v = (u + offs) % n
    rew = rng.random(u.shape[0]) < p
    rand_v = rng.integers(0, n, size=u.shape[0], dtype=np.int64)
    v = np.where(rew, rand_v, v)
    keep = u != v
    u, v = u[keep], v[keep]
    w = _uniform_weights(rng, u.shape[0], w_lo, w_hi)
    return coo_from_numpy(np.concatenate([u, v]), np.concatenate([v, u]),
                          np.concatenate([w, w]), n, device)


def rmat(n: int, m: int, a: float = 0.5, b: float = 0.25, c: float = 0.1,
         d: float = 0.15, seed: int = 0, w_lo: int = 1, w_hi: int = 20,
         device="cpu") -> COOGraph:
    """R-MAT scale-free generator (a=.5 b=.25 c=.1 d=.15): quadrant
    recursion over the next power of two, ids folded back modulo ``n``;
    directed, self loops dropped, duplicates kept."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for _ in range(scale):
        r = rng.random(m)
        src <<= 1
        dst <<= 1
        right = (r >= a) & (r < ab) | (r >= abc)
        down = r >= ab
        dst += right.astype(np.int64)
        src += down.astype(np.int64)
    src %= n
    dst %= n
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = _uniform_weights(rng, src.shape[0], w_lo, w_hi)
    return coo_from_numpy(src, dst, w, n, device)


def grid_map(height: int, width: int, obstacle_frac: float = 0.1,
             seed: int = 0, straight_cost: int = 10, diag_cost: int = 14,
             device="cpu") -> Tuple[COOGraph, np.ndarray]:
    """Game-map occupancy grid. Returns ``(graph, free_mask)`` with the
    (H, W) bool occupancy grid (True = accessible); node id =
    r * width + c; 8-neighbour edges between free cells."""
    rng = np.random.default_rng(seed)
    free = rng.random((height, width)) >= obstacle_frac
    idx = np.arange(height * width, dtype=np.int64).reshape(height, width)
    srcs, dsts, ws = [], [], []
    moves = [(-1, 0, straight_cost), (1, 0, straight_cost),
             (0, -1, straight_cost), (0, 1, straight_cost),
             (-1, -1, diag_cost), (-1, 1, diag_cost),
             (1, -1, diag_cost), (1, 1, diag_cost)]
    for dr, dc, cost in moves:
        rs = slice(max(0, -dr), height - max(0, dr))
        cs = slice(max(0, -dc), width - max(0, dc))
        rs2 = slice(max(0, dr), height + min(0, dr))
        cs2 = slice(max(0, dc), width + min(0, dc))
        ok = free[rs, cs] & free[rs2, cs2]
        srcs.append(idx[rs, cs][ok])
        dsts.append(idx[rs2, cs2][ok])
        ws.append(np.full(int(ok.sum()), cost, dtype=np.int32))
    g = coo_from_numpy(np.concatenate(srcs), np.concatenate(dsts),
                       np.concatenate(ws), height * width, device)
    return g, free


def square_lattice(side: int, seed: int = 0, weighted: bool = False,
                   device="cpu") -> COOGraph:
    """2-D 4-neighbour square lattice (the large-diameter worst case)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(side * side, dtype=np.int64).reshape(side, side)
    srcs, dsts = [], []
    for dr, dc in [(0, 1), (1, 0)]:
        srcs.append(idx[0:side - dr, 0:side - dc].ravel())
        dsts.append(idx[dr:side, dc:side].ravel())
    u = np.concatenate(srcs)
    v = np.concatenate(dsts)
    if weighted:
        w = _uniform_weights(rng, u.shape[0])
    else:
        w = np.ones(u.shape[0], dtype=np.int32)
    return coo_from_numpy(np.concatenate([u, v]), np.concatenate([v, u]),
                          np.concatenate([w, w]), side * side, device)


def random_graph(n: int, m: int, seed: int = 0, w_lo: int = 1,
                 w_hi: int = 20, undirected: bool = False,
                 device="cpu") -> COOGraph:
    """Erdős–Rényi-style G(n, m) (self loops dropped)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = _uniform_weights(rng, src.shape[0], w_lo, w_hi)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return coo_from_numpy(src, dst, w, n, device)
