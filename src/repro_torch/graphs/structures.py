"""Graph containers of the PyTorch port (counterpart of
``repro.graphs.structures``).

Three layouts, as in the reference:

* ``COOGraph`` — flat (src, dst, w) int32 edge tensors. The edge-centric
  relaxation and predecessor recovery consume this.
* ``CSRGraph`` — row_ptr/col/w. Host-side construction format.
* ``ELLGraph`` — padded (n+1, max_deg) neighbor/weight tensors with an
  all-sentinel row ``n`` (neighbor ``n``, weight ``INF32``), so a gather
  through a padding frontier slot reads INF and can never win a
  scatter-min.

Containers are frozen dataclasses of tensors; every tensor of one
container lies on one device, and ``.to(device)`` moves the whole
graph. Preprocessing (CSR conversion, light/heavy split, ELL padding)
runs on the host in numpy — exactly the reference's arithmetic — and
hands the result back on the graph's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

INF32 = np.int32(2**31 - 1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(device)


@dataclasses.dataclass(frozen=True)
class COOGraph:
    """Edge-list graph. ``src``/``dst`` int32[E], ``w`` int32[E] >= 0."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def reversed(self) -> "COOGraph":
        return COOGraph(self.dst, self.src, self.w, self.n_nodes)

    def to(self, device) -> "COOGraph":
        return COOGraph(self.src.to(device), self.dst.to(device),
                        self.w.to(device), self.n_nodes)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row. ``row_ptr`` int32[n+1], ``col``/``w`` int32[E]."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    w: torch.Tensor
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.col.shape[0])

    def degrees(self):
        return self.row_ptr[1:] - self.row_ptr[:-1]


@dataclasses.dataclass(frozen=True)
class ELLGraph:
    """ELLPACK-padded adjacency with one sentinel row: ``nbr``/``w`` have
    shape (n_nodes + 1, max_deg); padding slots hold neighbor
    ``n_nodes`` and weight ``INF32``, and row ``n_nodes`` is all
    padding."""

    nbr: torch.Tensor
    w: torch.Tensor
    n_nodes: int
    max_deg: int

    @property
    def valid(self):
        return self.nbr != self.n_nodes

    def to(self, device) -> "ELLGraph":
        return ELLGraph(self.nbr.to(device), self.w.to(device),
                        self.n_nodes, self.max_deg)


def coo_from_numpy(src, dst, w, n_nodes: int, device="cpu") -> COOGraph:
    """Build a ``COOGraph`` from host arrays (numpy, or anything
    ``np.asarray`` takes — e.g. ``np.asarray(jax_graph.src)``), so that
    two implementations can solve the very same instance."""
    return COOGraph(_dev(np.asarray(src), device), _dev(np.asarray(dst), device),
                    _dev(np.asarray(w), device), int(n_nodes))


def coo_to_csr(g: COOGraph) -> CSRGraph:
    """Host-side COO→CSR (stable sort by source, as the reference)."""
    src, dst, w = _host(g.src), _host(g.dst), _host(g.w)
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    counts = np.bincount(src, minlength=g.n_nodes).astype(np.int32)
    row_ptr = np.zeros(g.n_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    dev = g.device
    return CSRGraph(_dev(row_ptr, dev), _dev(dst, dev), _dev(w, dev),
                    g.n_nodes)


def csr_to_ell(g: CSRGraph, max_deg: int | None = None) -> ELLGraph:
    """Pad a CSR graph to ELL. Rows longer than ``max_deg`` are an error
    (no SSSP edge is ever dropped silently)."""
    row_ptr, col, w = _host(g.row_ptr), _host(g.col), _host(g.w)
    n = g.n_nodes
    deg = row_ptr[1:] - row_ptr[:-1]
    d = int(deg.max()) if deg.size else 0
    if max_deg is None:
        max_deg = max(d, 1)
    if d > max_deg:
        raise ValueError(f"max degree {d} exceeds ELL width {max_deg}")
    nbr = np.full((n + 1, max_deg), n, dtype=np.int32)
    ww = np.full((n + 1, max_deg), INF32, dtype=np.int32)
    slot = np.arange(col.shape[0], dtype=np.int64) - row_ptr[:-1].repeat(deg)
    row = np.arange(n, dtype=np.int64).repeat(deg)
    nbr[row, slot] = col
    ww[row, slot] = w
    dev = g.row_ptr.device
    return ELLGraph(_dev(nbr, dev), _dev(ww, dev), n, max_deg)


def union_with_reverse(g: COOGraph) -> COOGraph:
    """Disjoint union of ``g`` with its edge-reversed copy: vertices
    ``0..n-1`` carry the original graph, vertices ``n..2n-1`` the
    reversed one (edge ``(u, v, w)`` also appears as ``(v+n, u+n, w)``).
    One Δ-stepping solve seeded at ``s`` (forward half) and ``t+n``
    (reversed half) runs a forward and a backward search in bucket
    lockstep — the substrate of the bidirectional point-to-point modes
    and of the landmark table rows (``repro_torch.landmarks``). Built
    on the graph's device, int32, in the reference's edge order."""
    n = g.n_nodes
    return COOGraph(torch.cat([g.src, g.dst + n]),
                    torch.cat([g.dst, g.src + n]),
                    torch.cat([g.w, g.w]), 2 * n)


def light_heavy_split(g: CSRGraph, delta: int) -> Tuple[CSRGraph, CSRGraph]:
    """Paper Alg. 1 lines 3–5: split outgoing edges into light (w <= Δ)
    and heavy (w > Δ) CSR structures (host-side)."""
    row_ptr, col, w = _host(g.row_ptr), _host(g.col), _host(g.w)
    n = g.n_nodes
    deg = row_ptr[1:] - row_ptr[:-1]
    row = np.arange(n, dtype=np.int64).repeat(deg)
    light = w <= delta
    dev = g.row_ptr.device

    def build(mask):
        counts = np.bincount(row[mask], minlength=n).astype(np.int32)
        rp = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(counts, out=rp[1:])
        return CSRGraph(_dev(rp, dev), _dev(col[mask], dev),
                        _dev(w[mask], dev), n)

    return build(light), build(~light)
