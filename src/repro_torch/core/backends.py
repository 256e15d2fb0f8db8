"""Relaxation backends of the PyTorch port (single-device part of
``repro.core.backends``).

Every strategy of the reference's main path, over the same primitives:

* ``edge``   — edge-centric |E| sweep (tensor scatter-min), no
  preprocessing; the light mask is evaluated on the fly.
* ``ell``    — frontier-compacted expansion of light/heavy ELL blocks.
* ``pallas`` — the ELL expansion with candidates from the hand-written
  ``kernels/ell_relax`` CUDA kernel and every bucket scan on
  ``kernels/bucket_scan`` (the name is the reference's; in the port it
  means "the hand-kernel ELL strategy").
* ``fused``  — the solve loop's fused light phase: one
  ``kernels/frontier_relax`` step per inner iteration (scan +
  compaction + row gather), then the shared candidate path and a
  scatter-min.
* ``pallas`` with a ``free_mask`` (game maps) — the masked 8-neighbour
  stencil of the hand-written ``kernels/grid_relax`` kernel over the
  occupancy grid, with every bucket scan on ``kernels/bucket_scan``.

A backend provides ``sweep(tent, mask, bucket_i, light=, packed=) →
(tent', overflow)`` (``overflow`` a device bool, or ``None`` for a
backend with no frontier buffer to overflow) and ``scan(dist, explored, bucket_i) → (frontier,
any, next_bucket)``, plus host-side preprocessing in ``build``. Its
tensors live on one device; on CUDA the kernels run, on the CPU their
plain twins (the ops dispatchers decide by the tensor's device).

Batched sources: the ``sweep`` and ``scan`` of ``edge`` and ``ell``
(``supports_vmap``, the reference's split) also take a whole ``[B, n]``
batch, every lane with its own bucket index, compaction and overflow
flag — the tensor form of the reference's ``vmap``. The kernel
strategies run a batch lane by lane, as the reference runs them under
``lax.map``.

The reference leans on ``jnp.take(..., mode="fill")`` and
``.at[].min(..., mode="drop")`` for the sentinel id ``n``. Torch raises
on out-of-range indices, so every gather through an index that may be
``n`` reads a buffer with an explicit slot ``n`` (INF), and every
scatter through one writes an ``n+1`` buffer whose slot ``n`` is
discarded (``_take`` / ``_scatter_min`` / ``_scatter_set``). The
scatter-min is ``scatter_reduce_(…, "amin")``: order-free, so bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import pack as packing
from repro_torch.core.grid import free_mask_tensor
from repro_torch.graphs.structures import (
    COOGraph,
    ELLGraph,
    INF32,
    coo_to_csr,
    csr_to_ell,
    light_heavy_split,
)
from repro_torch.kernels.bucket_scan import bucket_scan
from repro_torch.kernels.ell_relax import ell_relax
from repro_torch.kernels.frontier_relax import compact_ref, frontier_relax
from repro_torch.kernels.grid_relax import grid_relax

_INF = int(INF32)
_IMAX = 2**31 - 1


# ---------------------------------------------------------------------------
# sentinel-slot gathers and scatters (the reference's fill / drop modes)
# ---------------------------------------------------------------------------

def _take(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(x, idx, mode="fill", fill_value=fill)`` for idx in
    [0, n]: slot n of the extended buffer holds ``fill``."""
    return torch.cat([x, x.new_full((1,), fill)])[idx]


def _scatter_min(tent: torch.Tensor, idx: torch.Tensor, words: torch.Tensor,
                 fill) -> torch.Tensor:
    """``tent.at[idx].min(words, mode="drop")`` for idx in [0, n]."""
    n = tent.shape[0]
    ext = torch.cat([tent, tent.new_full((1,), fill)])
    ext.scatter_reduce_(0, idx.reshape(-1).to(torch.int64), words.reshape(-1),
                        "amin", include_self=True)
    return ext[:n]


def _scatter_set(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")`` for idx in [0, n] whose
    in-range entries are distinct."""
    n = x.shape[0]
    ext = torch.cat([x, x.new_zeros(1)])
    vals = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
    ext.scatter_(0, idx.to(torch.int64), vals.expand(idx.shape).contiguous())
    return ext[:n]


# ---------------------------------------------------------------------------
# value-word helpers: every backend is generic over 'plain int32 distance'
# vs 'packed int64 (distance, predecessor)' words (paper C3, pack.py)
# ---------------------------------------------------------------------------

def inf_word(packed: bool) -> int:
    return packing.INF_PACKED if packed else _INF


def init_tent(n: int, source: int, packed: bool, device) -> torch.Tensor:
    if packed:
        tent = torch.full((n,), packing.INF_PACKED, dtype=torch.int64,
                          device=device)
        tent[source] = (0 << 32) | (int(source) & packing.MASK32)
        return tent
    tent = torch.full((n,), _INF, dtype=torch.int32, device=device)
    tent[source] = 0
    return tent


def dist_of(tent: torch.Tensor, packed: bool) -> torch.Tensor:
    return packing.unpack_dist(tent) if packed else tent


def candidate_words(cand_d, src_ids, ok, packed: bool):
    if packed:
        return torch.where(ok, packing.pack(cand_d, src_ids),
                           packing.INF_PACKED)
    return torch.where(ok, cand_d, _INF)


def graph_is_canonical(graph: COOGraph) -> bool:
    """True when every edge weight is >= 1 — the canonical-ties class on
    which packed relaxations use the word-order C4 filter (reference
    ``graph_is_canonical``, DESIGN.md §11)."""
    return bool(graph.w.numel() == 0 or int(graph.w.min()) >= 1)


# ---------------------------------------------------------------------------
# shared primitive ops
# ---------------------------------------------------------------------------

def scan_bucket(dist, explored, bucket_i, *, delta: int):
    """Fused dense-bucket scan (paper C1): the frontier mask of bucket
    ``bucket_i``, its any-reduce, and the next bucket holding unexplored
    work (``dist < explored``) — the tensor twin of
    ``kernels/bucket_scan``. Over ``[B, n]`` lanes, ``bucket_i`` is a
    per-lane int32[B, 1] and the two reductions are per lane."""
    fin = dist < _INF
    b = torch.where(fin, dist // delta, _IMAX)
    unsettled = dist < explored
    frontier = fin & (b == bucket_i) & unsettled
    nxt = torch.where((b > bucket_i) & unsettled, b, _IMAX).amin(-1)
    return frontier, frontier.any(-1), nxt


def edge_candidates(d_src, f_src, w, *, delta: int, light: bool):
    """Candidate distances of one edge-array relaxation and the C4 early
    mask (frontier membership + phase)."""
    active = f_src & (d_src < _INF)
    cand = torch.where(active, d_src, 0) + torch.where(active, w, 0)
    phase = (w <= delta) if light else (w > delta)
    return cand, active & phase


def edge_relax_words(tent, frontier, src, dst, w, *, delta: int, light: bool,
                     packed: bool, canonical: bool = False):
    """Candidate words of one edge-array relaxation: frontier/phase mask,
    C4 early filter against the destination, word packing. ``src`` /
    ``dst`` are in-range vertex ids, shared by every lane of a ``[B, n]``
    ``tent``. With ``canonical`` (packed mode on a w >= 1 graph) a word
    passes when it beats the destination's current *word*; otherwise the
    strict distance comparison applies."""
    d = dist_of(tent, packed)
    cand, ok = edge_candidates(d[..., src], frontier[..., src], w,
                               delta=delta, light=light)
    if packed and canonical:
        word = packing.pack(cand, src)
        ok = ok & (word < tent[..., dst])     # C4 on (cost, pred) word order
        return torch.where(ok, word, packing.INF_PACKED)
    ok = ok & (cand < d[..., dst])            # C4: early filter before scatter
    return candidate_words(cand, src, ok, packed)


def edge_sweep(tent, frontier, src, dst, w, *, delta: int, light: bool,
               packed: bool, canonical: bool = False, dst64=None):
    """One relaxation sweep over an edge array (scatter-min into tent,
    per lane of a ``[B, n]`` tent). ``dst64`` is ``dst`` as int64, when
    the caller keeps one."""
    words = edge_relax_words(tent, frontier, src, dst, w, delta=delta,
                             light=light, packed=packed, canonical=canonical)
    idx = dst.to(torch.int64) if dst64 is None else dst64
    return tent.scatter_reduce(-1, idx.expand_as(words), words, "amin",
                               include_self=True)


def ell_relax_words(tent, fidx, rows_n, rows_w, *, n: int, packed: bool,
                    canonical: bool = False, src=None):
    """Candidate words of gathered ELL rows (``rows_n``/``rows_w`` (cap,
    D), global neighbor ids). ``fidx`` int32[cap] holds the global ids
    of the compacted rows, ``n`` for padding slots (which gather INF).
    ``src`` is the rows' vertex ids for the packed predecessor, where
    they differ from ``fidx`` (a flattened batch)."""
    d = dist_of(tent, packed)
    d_ext = torch.cat([d, d.new_full((1,), _INF)])
    d_f = d_ext[fidx][:, None]
    valid = (rows_n < n) & (rows_w < _INF) & (d_f < _INF)
    cand = torch.where(valid, d_f, 0) + torch.where(valid, rows_w, 0)
    src_ids = (fidx if src is None else src)[:, None].expand(rows_n.shape)
    if packed and canonical:
        word = packing.pack(cand, src_ids)
        ok = valid & (word < _take(tent, rows_n, packing.INF_PACKED))
        return torch.where(ok, word, packing.INF_PACKED)
    ok = valid & (cand < d_ext[rows_n])
    return candidate_words(cand, src_ids, ok, packed)


def ell_sweep(tent, fidx, nbr, w_ell, *, n: int, packed: bool,
              canonical: bool = False):
    """Expand compacted frontier rows of an ELL adjacency block.
    ``fidx`` int32[cap] with sentinel value n for padding slots.

    Over ``[B, n]`` lanes (``fidx`` [B, cap], each lane's own
    compaction) the batch is one flat tent of ``B * n`` words: lane b's
    ids are offset by ``b * n`` and its sentinel becomes the flat
    sentinel ``B * n``, so the single-lane ops run on it unchanged."""
    rows_n = nbr[fidx]                      # (cap, D); row n is all-sentinel
    rows_w = w_ell[fidx]
    if tent.dim() == 1:
        words = ell_relax_words(tent, fidx, rows_n, rows_w, n=n,
                                packed=packed, canonical=canonical)
        return _scatter_min(tent, rows_n, words, inf_word(packed))
    b, dd = tent.shape[0], rows_n.shape[-1]
    off = torch.arange(b, dtype=torch.int64, device=tent.device) * n

    def flat(ids):                          # lane ids → flat ids
        o = off.reshape((b,) + (1,) * (ids.dim() - 1))
        return torch.where(ids < n, ids + o, b * n)

    flat_rows = flat(rows_n).reshape(-1, dd)
    words = ell_relax_words(tent.reshape(-1), flat(fidx).reshape(-1),
                            flat_rows, rows_w.reshape(-1, dd), n=b * n,
                            packed=packed, canonical=canonical,
                            src=fidx.reshape(-1))
    return _scatter_min(tent.reshape(-1), flat_rows, words,
                        inf_word(packed)).reshape(b, n)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class RelaxBackend:
    """Strategy protocol consumed by the solve loop (methods only; concrete
    backends are frozen dataclasses of tensors). On a backend with
    ``supports_vmap``, ``sweep`` and ``scan`` also take ``[B, n]`` lanes
    (``bucket_i`` int32[B, 1] for ``scan``)."""

    supports_vmap = True
    delta: int

    def sweep(self, tent, mask, bucket_i, *, light: bool, packed: bool):
        raise NotImplementedError

    def scan(self, dist, explored, bucket_i):
        return scan_bucket(dist, explored, bucket_i, delta=self.delta)


class _FrontierCompactMixin:
    """Shared ELL-strategy frontier compaction: masked vertex set → a
    fixed-capacity index buffer (sentinel ``n``) plus the overflow flag.
    Consumers declare fields ``n`` and ``cap``. Per lane over ``[B, n]``
    masks."""

    def compact(self, mask):
        return compact_ref(mask, self.cap, self.n), mask.sum(-1) > self.cap


class _PallasScanMixin:
    """Bucket bookkeeping on the ``kernels/bucket_scan`` kernel.
    Consumers declare field ``delta``."""

    def scan(self, dist, explored, bucket_i):
        return bucket_scan(dist, explored, bucket_i, delta=self.delta)


def _ell_blocks(graph: COOGraph, delta: int, max_deg=None):
    """Host-side preprocessing shared by the ELL strategies: CSR convert,
    light/heavy split (paper Alg. 1 lines 3–5), ELL pad."""
    csr = coo_to_csr(graph)
    light, heavy = light_heavy_split(csr, delta)
    return csr_to_ell(light, max_deg), csr_to_ell(heavy, max_deg)


@dataclasses.dataclass(frozen=True)
class EdgeBackend(RelaxBackend):
    """Edge-centric strategy: every sweep touches all |E| edges, masked
    by frontier membership of their source."""

    src: torch.Tensor
    dst: torch.Tensor
    dst64: torch.Tensor
    w: torch.Tensor
    delta: int
    canonical: bool

    @classmethod
    def build(cls, graph: COOGraph, cfg) -> "EdgeBackend":
        return cls(graph.src, graph.dst, graph.dst.to(torch.int64), graph.w,
                   cfg.delta, graph_is_canonical(graph))

    def sweep(self, tent, mask, bucket_i, *, light: bool, packed: bool):
        tent = edge_sweep(tent, mask, self.src, self.dst, self.w,
                          delta=self.delta, light=light, packed=packed,
                          canonical=self.canonical, dst64=self.dst64)
        return tent, torch.zeros(tent.shape[:-1], dtype=torch.bool,
                                 device=tent.device)


@dataclasses.dataclass(frozen=True)
class EllBackend(_FrontierCompactMixin, RelaxBackend):
    """Frontier-centric strategy: compacts the masked set into a
    fixed-capacity index buffer and expands light/heavy ELL rows."""

    light: ELLGraph
    heavy: ELLGraph
    delta: int
    n: int
    cap: int
    canonical: bool

    @classmethod
    def build(cls, graph: COOGraph, cfg, max_deg=None) -> "EllBackend":
        light, heavy = _ell_blocks(graph, cfg.delta, max_deg)
        return cls(light, heavy, cfg.delta, graph.n_nodes,
                   cfg.frontier_cap or graph.n_nodes,
                   graph_is_canonical(graph))

    def sweep(self, tent, mask, bucket_i, *, light: bool, packed: bool):
        fidx, over = self.compact(mask)
        ell = self.light if light else self.heavy
        tent = ell_sweep(tent, fidx, ell.nbr, ell.w, n=self.n, packed=packed,
                         canonical=self.canonical)
        return tent, over


@dataclasses.dataclass(frozen=True)
class PallasEllBackend(_FrontierCompactMixin, _PallasScanMixin,
                       RelaxBackend):
    """ELL strategy with the hot loops on the hand-written kernels:
    candidates from ``kernels/ell_relax`` and every bucket scan on
    ``kernels/bucket_scan``. The C4 filter and the scatter-min stay in
    tensor code, so the kernels only ever see int32 distances and
    packed (dist, pred) words still work. A batch runs lane by lane."""

    supports_vmap = False

    light: ELLGraph
    heavy: ELLGraph
    delta: int
    n: int
    cap: int
    canonical: bool

    @classmethod
    def build(cls, graph: COOGraph, cfg, max_deg=None) -> "PallasEllBackend":
        light, heavy = _ell_blocks(graph, cfg.delta, max_deg)
        return cls(light, heavy, cfg.delta, graph.n_nodes,
                   cfg.frontier_cap or graph.n_nodes,
                   graph_is_canonical(graph))

    def sweep(self, tent, mask, bucket_i, *, light: bool, packed: bool):
        fidx, over = self.compact(mask)
        ell = self.light if light else self.heavy
        d = dist_of(tent, packed)
        cand = ell_relax(fidx, d, ell.w)                       # (cap, D)
        rows_n = ell.nbr[fidx]
        src_ids = fidx[:, None].expand(rows_n.shape)
        if packed and self.canonical:
            # C4 on word order (the kernel only sees distances, so INF
            # candidates from padded slots are masked explicitly)
            word = packing.pack(cand, src_ids)
            ok = (cand < _INF) & (word < _take(tent, rows_n,
                                               packing.INF_PACKED))
            words = torch.where(ok, word, packing.INF_PACKED)
        else:
            ok = cand < _take(d, rows_n, _INF)  # C4 filter on kernel candidates
            words = candidate_words(cand, src_ids, ok, packed)
        return _scatter_min(tent, rows_n, words, inf_word(packed)), over


@dataclasses.dataclass(frozen=True)
class FusedBackend(_FrontierCompactMixin, RelaxBackend):
    """Fused frontier strategy (DESIGN.md §12): the light phase runs the
    solve loop's fused protocol — one ``kernels/frontier_relax`` step per
    inner iteration yields the compacted frontier, its gathered light
    ELL rows, the any-reduce and the next-bucket min, and the candidate
    words flow through ``ell_relax_words`` into a scatter-min. The heavy
    pass and any generic ``sweep`` use the plain compact-and-expand of
    ``EllBackend``. A batch runs lane by lane."""

    supports_fused_light = True
    supports_vmap = False

    light: ELLGraph
    heavy: ELLGraph
    delta: int
    n: int
    cap: int
    canonical: bool

    @classmethod
    def build(cls, graph: COOGraph, cfg, max_deg=None) -> "FusedBackend":
        light, heavy = _ell_blocks(graph, cfg.delta, max_deg)
        return cls(light, heavy, cfg.delta, graph.n_nodes,
                   cfg.frontier_cap or graph.n_nodes,
                   graph_is_canonical(graph))

    def _fused_step(self, dist, explored, bucket_i):
        ell = self.light
        return frontier_relax(
            dist, explored, bucket_i, ell.nbr, ell.w, delta=self.delta,
            cap=self.cap, base=0, sent=self.n)

    def fused_iter(self, tent, explored, in_s, bucket_i, *, packed: bool):
        """One whole light inner iteration: kernel step (scan + compact +
        gather), settled-set bookkeeping on the pre-relaxation
        distances, shared-path relaxation — the classic loop's op
        sequence on the same states. An empty frontier makes every
        update a sentinel no-op."""
        d = dist_of(tent, packed)
        fidx, rows_n, rows_w, count, any_, _ = self._fused_step(
            d, explored, bucket_i)
        explored = _scatter_set(explored, fidx, _take(d, fidx, _INF))
        in_s = _scatter_set(in_s, fidx, True)
        words = ell_relax_words(tent, fidx, rows_n, rows_w, n=self.n,
                                packed=packed, canonical=self.canonical)
        tent = _scatter_min(tent, rows_n, words, inf_word(packed))
        return tent, explored, in_s, any_, count > self.cap

    def fused_next(self, dist, explored, bucket_i):
        """Next-bucket min for the loop's bucket advance, from the
        ``kernels/bucket_scan`` kernel: the same scalar as a whole
        ``frontier_relax`` step (bitwise), without its compaction and
        row gather."""
        return bucket_scan(dist, explored, bucket_i, delta=self.delta)[2]

    def sweep(self, tent, mask, bucket_i, *, light: bool, packed: bool):
        fidx, over = self.compact(mask)
        ell = self.light if light else self.heavy
        tent = ell_sweep(tent, fidx, ell.nbr, ell.w, n=self.n, packed=packed,
                         canonical=self.canonical)
        return tent, over


@dataclasses.dataclass(frozen=True)
class GridPallasBackend(_PallasScanMixin, RelaxBackend):
    """Game-map strategy (paper §4 'Game Maps'): the graph is an
    occupancy grid, so relaxation is the ``kernels/grid_relax`` masked
    min-plus stencil, with no adjacency at all. The stencil recomputes
    bucket membership from ``tent`` in-kernel, so the driver's mask
    argument is advisory; re-relaxing settled cells is idempotent (the
    paper's redundant-work trade). int32 distances only
    (``pred_mode='packed'`` is refused by ``make_backend``). A batch
    runs lane by lane."""

    supports_vmap = False

    free: torch.Tensor                    # bool[H, W] occupancy mask
    delta: int
    shape: Tuple[int, int]
    costs: Tuple[int, int]                # (straight, diagonal)

    @classmethod
    def build(cls, graph: COOGraph, cfg, free_mask) -> "GridPallasBackend":
        free = free_mask_tensor(free_mask, graph.device)
        if free.dim() != 2 or free.numel() != graph.n_nodes:
            raise ValueError(
                f"free_mask shape {tuple(free.shape)} does not cover the "
                f"{graph.n_nodes}-vertex graph")
        return cls(free, cfg.delta, tuple(free.shape), tuple(cfg.grid_costs))

    def sweep(self, tent, mask, bucket_i, *, light: bool, packed: bool):
        out = grid_relax(tent.reshape(self.shape), self.free, bucket_i,
                         delta=self.delta, cost_straight=self.costs[0],
                         cost_diag=self.costs[1], light=light)
        return out.reshape(-1), None      # no frontier buffer to overflow


_SHARDED = ("sharded_edge", "sharded_ell", "sharded_fused")


def make_backend(graph: COOGraph, cfg, free_mask=None) -> RelaxBackend:
    """Route a (graph, config) pair to its backend. ``free_mask`` marks
    the game-map graph class: under ``strategy='pallas'`` it selects the
    grid-stencil kernel instead of the ELL kernels (other strategies
    ignore it). The sharded strategies are not ported yet and raise."""
    if cfg.strategy in _SHARDED:
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 5, multi-GPU)")
    if cfg.strategy == "edge":
        return EdgeBackend.build(graph, cfg)
    if cfg.strategy == "ell":
        return EllBackend.build(graph, cfg)
    if cfg.strategy == "fused":
        return FusedBackend.build(graph, cfg)
    if cfg.strategy != "pallas":
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if free_mask is not None:
        if cfg.pred_mode == "packed":
            raise ValueError(
                "grid-stencil pallas backend carries int32 distances only; "
                "use pred_mode='argmin' (post-hoc tree recovery)")
        return GridPallasBackend.build(graph, cfg, free_mask)
    return PallasEllBackend.build(graph, cfg)


__all__ = [
    "EdgeBackend",
    "EllBackend",
    "FusedBackend",
    "GridPallasBackend",
    "PallasEllBackend",
    "RelaxBackend",
    "candidate_words",
    "dist_of",
    "edge_candidates",
    "edge_relax_words",
    "edge_sweep",
    "ell_relax_words",
    "ell_sweep",
    "graph_is_canonical",
    "init_tent",
    "make_backend",
    "scan_bucket",
]
