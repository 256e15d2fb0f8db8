"""Frontier-selection policies of the PyTorch port (counterpart of
``repro.core.policies``): "which pending vertices step this round" as a
pluggable axis (DESIGN.md §15).

Each round picks a non-empty subset of the *pending* vertices
(``tent < explored``), marks it explored, and relaxes all of its edges.
Any such policy reaches the exact distance fixpoint; the policy only
shapes the round structure.

* ``delta``  — the paper's bucket loop, run by ``_run_backend``;
  :class:`DeltaPolicy` is a routing marker, never stepped.
* ``rho``    — ρ-stepping: the round threshold is the ρ-th smallest
  pending tent, and every pending vertex at or below it steps.
* ``radius`` — radius-stepping: θ = min over pending of
  ``tent(v) + r(v)``, and the round re-steps until nothing pending is
  left at or below θ.

``compute_radii`` is the reference's surrogate: r(v) is the k-th
smallest outgoing edge weight. Radii persist through
:class:`RadiiStore`, one ``.npz`` per (graph content hash, k) with the
reference's fields, atomically replaced; an unreadable or mismatched
file is a miss.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.graphs.structures import COOGraph, INF32

POLICIES = ("delta", "rho", "radius")
_INF = int(INF32)


class DeltaPolicy:
    """Marker for the classic Δ-stepping bucket loop: plans with this
    policy bind the ``_run_backend`` drivers; the policy loop never sees
    it."""

    name = "delta"
    closure = False

    def threshold(self, d, explored):
        raise NotImplementedError("DeltaPolicy routes to the bucket loop")


class RhoPolicy:
    """ρ-stepping: the round threshold is the ρ-th smallest pending tent
    (INF when fewer than ρ vertices are pending — then the whole pending
    set steps)."""

    name = "rho"
    closure = False

    def __init__(self, rho: int):
        self.rho = int(rho)

    def threshold(self, d, explored):
        pend = torch.where(d < explored, d, _INF)
        k = min(self.rho, int(d.shape[0]))
        # the k-th smallest value: the reference's sort(pend)[k - 1]
        return torch.kthvalue(pend, k).values


class RadiusPolicy:
    """Radius-stepping: θ = min over pending of ``tent(v) + r(v)``; the
    closure drains everything at or below θ. ``r`` is int32[n] on the
    plan's device, >= 0."""

    name = "radius"
    closure = True

    def __init__(self, r: torch.Tensor):
        self.r = r
        self._r64 = r.to(torch.int64)

    def threshold(self, d, explored):
        pend = d < explored
        # the reference adds in int32, where a lane may wrap; the sum is
        # formed in int64 and wrapped explicitly (d, r in [0, 2^31), so
        # one subtraction suffices), then masked before the min
        s = d.to(torch.int64) + self._r64
        s = torch.where(s > _INF, s - (1 << 32), s)
        return torch.where(pend, s, _INF).min().to(torch.int32)


# ---------------------------------------------------------------------------
# radius preprocessing + persistence
# ---------------------------------------------------------------------------

def compute_radii(graph: COOGraph, k: int) -> np.ndarray:
    """Per-vertex step radii: r(v) = k-th smallest outgoing edge weight
    (the largest when deg(v) < k; 0 for a vertex without out-edges).
    Host-side numpy."""
    if k < 1:
        raise ValueError("radius_k must be >= 1")
    n = graph.n_nodes
    src = graph.src.cpu().numpy()
    w = graph.w.cpu().numpy()
    r = np.zeros((n,), np.int32)
    if src.size == 0:
        return r
    order = np.lexsort((w, src))
    ws = w[order]
    deg = np.bincount(src, minlength=n)
    starts = np.zeros((n,), np.int64)
    starts[1:] = np.cumsum(deg)[:-1]
    has = deg > 0
    idx = starts + np.minimum(k - 1, np.maximum(deg - 1, 0))
    r[has] = ws[idx[has]]
    return r.astype(np.int32)


def graph_weight_hash(graph: COOGraph) -> str:
    """Content hash of (src, dst, w, n) — the same hex digest as the
    reference's for the same graph."""
    h = hashlib.sha1()
    for a in (graph.src, graph.dst, graph.w):
        h.update(np.ascontiguousarray(a.cpu().numpy().astype(np.int64))
                 .tobytes())
    h.update(str(int(graph.n_nodes)).encode())
    return h.hexdigest()


class RadiiStore:
    """Persistent per-graph radii: one ``.npz`` per (graph content hash,
    k), atomically replaced; unreadable or mismatched files are misses,
    never errors. ``path=None`` keeps an in-memory store."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: dict = {}
        if path is not None:
            os.makedirs(path, exist_ok=True)

    def _key(self, whash: str, k: int) -> str:
        return hashlib.sha1(f"{whash}|k={int(k)}".encode()).hexdigest()

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"radii_{key}.npz")

    def get(self, graph: COOGraph, k: int) -> Optional[np.ndarray]:
        whash = graph_weight_hash(graph)
        key = self._key(whash, k)
        if key in self._mem:
            return self._mem[key]
        if self.path is None:
            return None
        try:
            with np.load(self._file(key), allow_pickle=False) as z:
                if (str(z["whash"]) != whash or int(z["k"]) != int(k)
                        or int(z["n"]) != int(graph.n_nodes)):
                    return None
                r = np.asarray(z["r"], np.int32)
        except (OSError, KeyError, ValueError):
            return None
        if r.shape != (graph.n_nodes,):
            return None
        self._mem[key] = r
        return r

    def put(self, graph: COOGraph, k: int, r: np.ndarray) -> None:
        whash = graph_weight_hash(graph)
        key = self._key(whash, k)
        r = np.asarray(r, np.int32)
        self._mem[key] = r
        if self.path is None:
            return
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, r=r, whash=np.str_(whash),
                         k=np.int64(k), n=np.int64(graph.n_nodes))
            os.replace(tmp, self._file(key))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def default_rho(n: int) -> int:
    """ρ when ``DeltaConfig.rho`` is unset: large batches, clipped so
    tiny graphs still form multi-vertex rounds."""
    return max(32, n // 8)


def make_policy(graph: COOGraph, cfg, store: Optional[RadiiStore] = None):
    """The frontier policy named by ``cfg.policy`` for ``graph``, its
    tensors on the graph's device. ``store`` persists and reuses the
    radius preprocessing."""
    if cfg.policy == "delta":
        return DeltaPolicy()
    if cfg.policy == "rho":
        rho = cfg.rho if cfg.rho is not None else default_rho(graph.n_nodes)
        return RhoPolicy(rho=int(rho))
    if cfg.policy == "radius":
        r = store.get(graph, cfg.radius_k) if store is not None else None
        if r is None:
            r = compute_radii(graph, cfg.radius_k)
            if store is not None:
                store.put(graph, cfg.radius_k, r)
        return RadiusPolicy(torch.as_tensor(r, dtype=torch.int32,
                                            device=graph.device))
    raise ValueError(f"unknown policy {cfg.policy!r}")


__all__ = [
    "POLICIES",
    "DeltaPolicy",
    "RadiiStore",
    "RadiusPolicy",
    "RhoPolicy",
    "compute_radii",
    "default_rho",
    "graph_weight_hash",
    "make_policy",
]
