"""Vertex partitioning for the multi-GPU Δ-stepping of the PyTorch port
(counterpart of ``repro.graphs.partition``).

The paper distributes bucket entries over OpenMP threads with static
scheduling; the port maps that to a static 1-D partition of the vertex
set over the ranks of a process group. Shard ``i`` owns the contiguous
vertex range ``[i * S, (i + 1) * S)`` (``S = ceil(n / P)``) and every
outgoing edge of that range (CSR row ownership). Shards are padded to a
common size so that they stack into dense ``[P, ...]`` tensors: padding
edges carry the sentinel source ``n`` and weight ``INF32``, padding ELL
slots the sentinel neighbour ``n`` and weight ``INF32``.

The layouts are built on the host in numpy with the reference's
arithmetic, so they are bitwise the reference's arrays, and handed back
on ``device`` (default: the graph's). A rank that relaxes only its own
shard builds them on the CPU and moves its own row to its GPU.

* ``partition_edges`` → ``VertexPartition``: flat per-shard edge arrays
  (``sharded_edge`` and ``core.distributed``);
* ``partition_ell``   → ``ELLPartition``: per-shard light/heavy ELL row
  blocks over the owned range (``sharded_ell``, ``sharded_fused``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.structures import (
    INF32,
    COOGraph,
    _dev,
    _host,
    coo_to_csr,
    light_heavy_split,
)


@dataclasses.dataclass(frozen=True)
class VertexPartition:
    """Stacked per-shard edge arrays.

    ``src``/``dst``/``w``: int32[n_shards, max_edges_per_shard]. Padding
    slots have src == n_nodes (sentinel) and w == INF32. ``vstart``:
    int32[n_shards] first owned vertex of each shard."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    vstart: torch.Tensor
    n_nodes: int
    n_shards: int
    shard_nodes: int

    @property
    def edges_per_shard(self) -> int:
        return int(self.src.shape[1])


def partition_edges(g: COOGraph, n_shards: int,
                    device=None) -> VertexPartition:
    """Static 1-D partition: shard i owns vertices [i*S, (i+1)*S) and all
    their outgoing edges, each shard's block padded to a multiple of 128
    edges. Host-side numpy; tensors on ``device`` (default the graph's)."""
    src, dst, w = _host(g.src), _host(g.dst), _host(g.w)
    n = g.n_nodes
    shard_nodes = -(-n // n_shards)  # ceil
    owner = np.minimum(src // shard_nodes, n_shards - 1).astype(np.int64)
    order = np.argsort(owner, kind="stable")
    src, dst, w, owner = src[order], dst[order], w[order], owner[order]
    counts = np.bincount(owner, minlength=n_shards)
    cap = int(counts.max()) if counts.size else 1
    cap = max(1, -(-cap // 128) * 128)
    ps = np.full((n_shards, cap), n, dtype=np.int32)
    pd = np.zeros((n_shards, cap), dtype=np.int32)
    pw = np.full((n_shards, cap), INF32, dtype=np.int32)
    starts = np.zeros(n_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for i in range(n_shards):
        lo, hi = starts[i], starts[i + 1]
        ps[i, : hi - lo] = src[lo:hi]
        pd[i, : hi - lo] = dst[lo:hi]
        pw[i, : hi - lo] = w[lo:hi]
    vstart = (np.arange(n_shards) * shard_nodes).astype(np.int32)
    dev = g.device if device is None else device
    return VertexPartition(_dev(ps, dev), _dev(pd, dev), _dev(pw, dev),
                           _dev(vstart, dev), n, n_shards, int(shard_nodes))


@dataclasses.dataclass(frozen=True)
class ELLPartition:
    """Stacked per-shard light/heavy ELL row blocks.

    ``light_nbr``/``light_w`` int32[n_shards, shard_nodes + 1, light_deg]
    (``heavy_*`` likewise): row ``r`` of shard ``i`` holds the light
    (heavy) outgoing edges of global vertex ``i * shard_nodes + r`` with
    *global* neighbour ids. Invalid slots — padding columns, rows past
    ``n_nodes`` and the sentinel row ``shard_nodes`` — carry neighbour
    ``n_nodes`` and weight ``INF32``."""

    light_nbr: torch.Tensor
    light_w: torch.Tensor
    heavy_nbr: torch.Tensor
    heavy_w: torch.Tensor
    n_nodes: int
    n_shards: int
    shard_nodes: int
    light_deg: int
    heavy_deg: int


def _stack_ell_blocks(csr, n_shards: int, shard_nodes: int, device):
    """One CSR split → stacked per-shard ELL blocks (numpy host-side)."""
    row_ptr, col, w = _host(csr.row_ptr), _host(csr.col), _host(csr.w)
    n = csr.n_nodes
    deg = row_ptr[1:] - row_ptr[:-1]
    max_deg = max(int(deg.max()) if deg.size else 0, 1)
    nbr = np.full((n_shards, shard_nodes + 1, max_deg), n, dtype=np.int32)
    ww = np.full((n_shards, shard_nodes + 1, max_deg), INF32, dtype=np.int32)
    if col.size:
        slot = np.arange(col.shape[0], dtype=np.int64) \
            - row_ptr[:-1].repeat(deg)
        v = np.arange(n, dtype=np.int64).repeat(deg)
        nbr[v // shard_nodes, v % shard_nodes, slot] = col
        ww[v // shard_nodes, v % shard_nodes, slot] = w
    return _dev(nbr, device), _dev(ww, device), max_deg


def partition_ell(g: COOGraph, n_shards: int, delta: int,
                  device=None) -> ELLPartition:
    """Static 1-D row partition of the light/heavy ELL blocks: shard i
    owns the ELL rows of vertices [i*S, (i+1)*S). Host-side numpy;
    tensors on ``device`` (default the graph's)."""
    csr = coo_to_csr(g)
    light, heavy = light_heavy_split(csr, delta)
    shard_nodes = -(-g.n_nodes // n_shards)  # ceil
    dev = g.device if device is None else device
    l_nbr, l_w, l_deg = _stack_ell_blocks(light, n_shards, shard_nodes, dev)
    h_nbr, h_w, h_deg = _stack_ell_blocks(heavy, n_shards, shard_nodes, dev)
    return ELLPartition(l_nbr, l_w, h_nbr, h_w, g.n_nodes, n_shards,
                        int(shard_nodes), l_deg, h_deg)


__all__ = [
    "ELLPartition",
    "VertexPartition",
    "partition_edges",
    "partition_ell",
]
