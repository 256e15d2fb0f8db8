"""Single-device Δ-stepping SSSP engine of the PyTorch port (counterpart
of ``repro.core.delta_stepping``, cold single-source path).

The paper's shared-memory mechanisms map onto tensor dataflow as in the
reference: the dense bucket array (C1) is a full scan of
``tent // Δ`` per inner iteration, the CAS minimum loop (C2) is a
scatter-min, the 64-bit (cost, pred) packing (C3) is
``pred_mode='packed'``, and relaxations are filtered early with
``cand < tent[dst]`` (C4).

``lax.while_loop`` becomes a host loop. Each loop condition is read
back from the device once: the light-phase flag once per inner
iteration plus once per bucket (the classic loop's priming scan, or the
fused loop's vacuous trailing step), the next bucket once per bucket,
and the overflow flag once per solve — ``2 * buckets + inner_iters + 1``
host synchronisations per solve, which ``_run_backend`` counts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pack as packing
from repro_torch.core.backends import RelaxBackend, dist_of, init_tent
from repro_torch.graphs.structures import COOGraph, INF32

_INF = int(INF32)
_IMAX = 2**31 - 1

P2P_MODES = ("early_exit", "alt", "bidirectional", "alt_bidirectional")
POLICIES = ("delta", "rho", "radius")
STRATEGIES = ("edge", "ell", "pallas", "fused", "sharded_edge",
              "sharded_ell", "sharded_fused")


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    """Configuration of the Δ-stepping engine — the reference's
    ``DeltaConfig`` field for field (names, defaults, validation), so
    one config drives both packages. See ``repro.core.DeltaConfig`` for
    every field's meaning. In the port, ``interpret`` has no effect
    (there is no interpreter: CPU tensors run the kernels' twins), and
    this slice solves ``strategy`` ∈ edge|ell|pallas|fused under
    ``policy='delta'``."""

    delta: int = 10
    strategy: str = "edge"
    pred_mode: str = "argmin"
    frontier_cap: Optional[int] = None
    interpret: bool = False
    grid_costs: Tuple[int, int] = (10, 14)
    n_shards: Optional[int] = None
    p2p_mode: str = "early_exit"
    policy: str = "delta"
    rho: Optional[int] = None
    radius_k: int = 4

    def __post_init__(self):
        if self.p2p_mode not in P2P_MODES:
            raise ValueError(f"unknown p2p_mode {self.p2p_mode!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.pred_mode not in ("none", "argmin", "packed"):
            raise ValueError(f"unknown pred_mode {self.pred_mode!r}")
        if self.delta < 1:
            raise ValueError("delta must be >= 1")
        if self.n_shards is not None and self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.rho is not None and self.rho < 1:
            raise ValueError("rho must be >= 1")
        if self.radius_k < 1:
            raise ValueError("radius_k must be >= 1")


class SSSPResult(NamedTuple):
    """Solve result."""

    dist: torch.Tensor       # int32[n], INF32 = unreachable
    pred: torch.Tensor       # int32[n], -1 = source/unreachable
    outer_iters: int         # number of buckets processed
    inner_iters: int         # total light-phase sweeps
    overflow: bool           # compacted frontier capacity exceeded


class RunOut(NamedTuple):
    """What one run of the solve loop returns: the converged tent words, the
    reference's three counters, and the host synchronisations made."""

    tent: torch.Tensor
    outer_iters: int
    inner_iters: int
    overflow: bool
    host_syncs: int


def _run_one(backend: RelaxBackend, source: int, *, n: int, packed: bool,
             device) -> RunOut:
    """Single-source solve loop."""
    return _run_backend(backend, source, n=n, packed=packed, device=device)


def _run_one_p2p(backend: RelaxBackend, source: int, target: int, *, n: int,
                 packed: bool, device) -> RunOut:
    """Point-to-point solve with early exit (Kainer & Träff 2019,
    DESIGN.md §10): when the outer loop advances past bucket i, every
    vertex whose tentative distance lies in a bucket <= i is settled,
    and the next-bucket scan is a global min over the unsettled tent
    values, so ``tent[target] // Δ < next_bucket`` proves the target's
    distance final. The landmark paths' mid-bucket exit
    (``all_light``/``inner_stop``) is not ported (ROADMAP Queue 1 item
    10)."""
    delta = backend.delta

    def stop(tent, explored, nxt):
        d_t = dist_of(tent, packed)[target]
        return (d_t < _INF) & ((d_t // delta) < nxt)

    return _run_backend(backend, source, n=n, packed=packed, device=device,
                        stop=stop)


def _run_one_bounded(backend: RelaxBackend, source: int, radius: int, *,
                     n: int, packed: bool, device) -> RunOut:
    """Bounded-radius solve: stop at the first bucket past
    ``radius // Δ``. Every vertex with true distance <= radius lives in
    a bucket <= radius // Δ and is settled by then; tent values beyond
    are upper bounds, not answers (the caller filters them)."""
    last = radius // backend.delta

    def stop(tent, explored, nxt):
        return nxt > last

    return _run_backend(backend, source, n=n, packed=packed, device=device,
                        stop=stop)


def _read(flag, extra):
    """One device→host transfer: ``flag`` as an int, and the device
    bool ``extra`` (a stop predicate) with it when there is one."""
    if extra is None:
        return int(flag), False
    flag, extra = torch.stack([flag.to(torch.int64),
                               extra.to(torch.int64)]).tolist()
    return flag, bool(extra)


def _or(over, o):
    """Accumulate a sweep's overflow flag; ``None`` (a backend with no
    frontier buffer) adds no device op."""
    return over if o is None else over | o


def _run_backend(backend: RelaxBackend, source: int, *, n: int, packed: bool,
                 device, stop=None) -> RunOut:
    """Outer/inner Δ-stepping loop (paper Alg. 1) over one backend, cold
    start. Same op sequence on the same states as the reference's
    ``_run_backend`` with no ``init``/``inner_stop`` hook, so tent words
    and counters are bitwise the reference's.

    ``stop`` is the optional early-exit predicate ``(tent, explored,
    next_bucket) -> device bool`` checked between buckets, as the
    reference's ``outer_cond`` checks it: before bucket 0 (with
    ``next_bucket = 0``) and after every bucket. Each check is read in
    the same transfer as the flag the loop reads there anyway (the
    priming scan's, or the fused loop's first step's, before bucket 0;
    the next bucket after each bucket), so it adds no host
    synchronisation. ``None`` keeps the full-solve loop unchanged."""
    tent0 = tent = init_tent(n, source, packed, device)
    explored = torch.full((n,), _INF, dtype=torch.int32, device=device)
    over = torch.zeros((), dtype=torch.bool, device=device)
    fused = getattr(backend, "supports_fused_light", False)
    i, outer, inner, syncs = 0, 0, 0, 0
    # outer_cond's check before bucket 0 (i < IMAX holds for i = 0); a
    # stop there returns the cold state with zero counters
    first = (None if stop is None else
             stop(tent, explored, torch.zeros((), dtype=torch.int32,
                                              device=device)))

    while True:
        in_s = torch.zeros((n,), dtype=torch.bool, device=device)
        if fused:
            # fused light phase (DESIGN.md §12): scan-then-relax is one
            # step, so the loop ends on one vacuous trailing step whose
            # updates are sentinel no-ops; counting ``inner += any``
            # keeps the counters those of the classic loop
            go = True
            while go:
                tent, explored, in_s, any_, o = backend.fused_iter(
                    tent, explored, in_s, i, packed=packed)
                go, halt = _read(any_, first)
                syncs += 1
                if halt:
                    return RunOut(tent0, 0, 0, False, syncs + 1)
                first = None
                over = over | o
                inner += go
        else:
            f, go, _ = backend.scan(dist_of(tent, packed), explored, i)
            go, halt = _read(go, first)
            syncs += 1
            if halt:
                return RunOut(tent0, 0, 0, False, syncs + 1)
            first = None
            while go:
                explored = torch.where(f, dist_of(tent, packed), explored)
                in_s = in_s | f                      # paper: move into S
                tent, o = backend.sweep(tent, f, i, light=True, packed=packed)
                over = _or(over, o)
                f, go, _ = backend.scan(dist_of(tent, packed), explored, i)
                go = bool(go)
                syncs += 1
                inner += 1
        # heavy pass from S (paper Alg. 1 lines 19-20)
        tent, o = backend.sweep(tent, in_s, i, light=False, packed=packed)
        over = _or(over, o)
        if fused:
            nxt = backend.fused_next(dist_of(tent, packed), explored, i)
        else:
            _, _, nxt = backend.scan(dist_of(tent, packed), explored, i)
        outer += 1
        i, halt = _read(nxt, None if stop is None else
                        stop(tent, explored, nxt))
        syncs += 1
        if i >= _IMAX or halt:
            break
    return RunOut(tent, outer, inner, bool(over), syncs + 1)


# ---------------------------------------------------------------------------
# predecessor recovery (two-pass argmin mode)
# ---------------------------------------------------------------------------

def pred_argmin(dist, src, dst, w, source: int, *, n: int):
    """Recover a shortest-path tree from converged distances: for every
    edge achieving dist[src] + w == dist[dst], scatter-min the source id
    (smallest-id parent wins, matching packed-mode ties)."""
    d_src = dist[src]
    d_dst = dist[dst]
    fin = d_src < _INF
    cand = torch.where(fin, d_src, 0) + torch.where(fin, w, 0)
    ok = fin & (d_dst < _INF) & (cand == d_dst)
    p = torch.full((n,), _IMAX, dtype=torch.int32, device=dist.device)
    p = p.scatter_reduce(0, dst.to(torch.int64), torch.where(ok, src, _IMAX),
                         "amin", include_self=True)
    pred = torch.where((p < _IMAX) & (dist < _INF), p, -1).to(torch.int32)
    pred[source] = -1
    return pred


def _finish_pred(tent, coo: COOGraph, source: int, cfg: DeltaConfig):
    packed = cfg.pred_mode == "packed"
    dist = dist_of(tent, packed)
    if cfg.pred_mode == "none":
        pred = torch.full((coo.n_nodes,), -1, dtype=torch.int32,
                          device=dist.device)
    elif packed:
        pred = torch.where(dist < _INF, packing.unpack_pred(tent), -1)
        pred = pred.to(torch.int32)
        pred[source] = -1
    else:
        pred = pred_argmin(dist, coo.src, coo.dst, coo.w, source,
                           n=coo.n_nodes)
    return dist, pred


__all__ = [
    "DeltaConfig",
    "P2P_MODES",
    "POLICIES",
    "RunOut",
    "SSSPResult",
    "pred_argmin",
]
