"""Single-device Δ-stepping SSSP engine of the PyTorch port (counterpart
of ``repro.core.delta_stepping``: the cold single-source, batched,
point-to-point and bounded drivers and the warm-start driver of the
dynamic repair path, for the bucket loop and for the frontier-policy
loop).

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

Batched sources: on backends with ``supports_vmap`` (``edge``, ``ell``)
``_run_many_vmapped`` carries ``[B, n]`` state with a per-lane bucket
index and counters, and masks each lane's frontier with its active flag
— a lane whose outer loop has ended, or whose light phase has drained
while others still sweep, is frozen exactly where ``lax.while_loop``'s
batching rule freezes it by select (DESIGN.md §3). Every lane is
bitwise its single solve; all lanes' loop conditions come back in one
transfer per loop step. The kernel strategies run a batch lane by lane
(``_run_lanes``), as the reference runs them under ``lax.map``.

The frontier-policy loop (``_run_policy``, ρ- and radius-stepping,
DESIGN.md §15) reads its round condition once per round, and radius's
closure condition once per closure step; a stop predicate comes back in
the same transfer as the round condition.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pack as packing
from repro_torch.core.backends import RelaxBackend, dist_of, init_tent
from repro_torch.core.policies import POLICIES
from repro_torch.graphs.structures import COOGraph, INF32

_INF = int(INF32)
_IMAX = 2**31 - 1

P2P_MODES = ("early_exit", "alt", "bidirectional", "alt_bidirectional")
STRATEGIES = ("edge", "ell", "pallas", "fused", "sharded_edge",
              "sharded_ell", "sharded_fused")


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    """Configuration of the Δ-stepping engine — the reference's
    ``DeltaConfig`` field for field (names, defaults, validation), so
    one config drives both packages. See ``repro.core.DeltaConfig`` for
    every field's meaning. In the port, ``interpret`` has no effect
    (there is no interpreter: CPU tensors run the kernels' twins), and
    the port solves ``strategy`` ∈ edge|ell|pallas|fused under every
    ``policy``."""

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


class ManyOut(NamedTuple):
    """What a batched run returns: tent words [B, n], the per-lane
    counters as CPU tensors (int32[B], int32[B], bool[B]) and the host
    synchronisations of the whole batch."""

    tent: torch.Tensor
    outer_iters: torch.Tensor
    inner_iters: torch.Tensor
    overflow: torch.Tensor
    host_syncs: int


def _lanes(outs, *, n: int, packed: bool, device) -> ManyOut:
    """Stack per-lane ``RunOut``s into one ``ManyOut`` (an empty batch
    gives ``[0, n]`` words, as the reference's ``lax.map`` does)."""
    return ManyOut(
        torch.stack([o.tent for o in outs]) if outs else
        _init_tent_many(n, [], packed, device),
        torch.tensor([o.outer_iters for o in outs], dtype=torch.int32),
        torch.tensor([o.inner_iters for o in outs], dtype=torch.int32),
        torch.tensor([o.overflow for o in outs], dtype=torch.bool),
        sum(o.host_syncs for o in outs))


def _run_one(backend: RelaxBackend, source: int, *, n: int, packed: bool,
             device) -> RunOut:
    """Single-source solve loop."""
    return _run_backend(backend, source, n=n, packed=packed, device=device)


def _run_lanes(run, backend: RelaxBackend, sources, *, n: int, packed: bool,
               device, **kw) -> ManyOut:
    """Batched solve lane by lane (the reference's ``lax.map``): each
    lane is one call of the single-source driver ``run`` (``_run_one`` on
    the kernel strategies, ``_run_policy_one`` for every policy batch),
    which gets ``kw`` too."""
    return _lanes([run(backend, int(s), n=n, packed=packed, device=device,
                       **kw) for s in sources],
                  n=n, packed=packed, device=device)


def _init_tent_many(n: int, sources, packed: bool, device) -> torch.Tensor:
    b = len(sources)
    lanes = torch.arange(b, device=device)
    src = torch.as_tensor([int(s) for s in sources], dtype=torch.int64,
                          device=device)
    if packed:
        tent = torch.full((b, n), packing.INF_PACKED, dtype=torch.int64,
                          device=device)
        tent[lanes, src] = src & packing.MASK32       # (0 << 32) | source
        return tent
    tent = torch.full((b, n), _INF, dtype=torch.int32, device=device)
    tent[lanes, src] = 0
    return tent


def _run_many_vmapped(backend: RelaxBackend, sources, *, n: int,
                      packed: bool, device) -> ManyOut:
    """Batched outer/inner loop over ``[B, n]`` lanes (the reference's
    ``vmap`` of ``_run_backend``) on a backend whose ``sweep`` and
    ``scan`` take lanes (``supports_vmap``; the bucket index goes in as
    ``i[:, None]``). ``act`` marks the lanes whose outer loop still
    runs, ``go`` the lanes whose light phase still sweeps; every
    frontier is masked by them, so a frozen lane's sweeps are sentinel
    no-ops and its state, bucket index and counters stay as they are —
    the select of ``lax.while_loop``'s batching rule. Host syncs: one
    per light flag read and one per next-bucket read, for all lanes
    together, plus one for the overflow flags."""
    b = len(sources)
    tent = _init_tent_many(n, sources, packed, device)
    explored = torch.full((b, n), _INF, dtype=torch.int32, device=device)
    over = torch.zeros(b, dtype=torch.bool, device=device)
    i = torch.zeros(b, dtype=torch.int32, device=device)
    outer = torch.zeros(b, dtype=torch.int32)
    inner = torch.zeros(b, dtype=torch.int32)
    act = torch.ones(b, dtype=torch.bool)
    syncs = 0
    while bool(act.any()):
        act_d = act.to(device)
        in_s = torch.zeros((b, n), dtype=torch.bool, device=device)
        f, go_d, _ = backend.scan(dist_of(tent, packed), explored,
                                  i[:, None])
        go_d = go_d & act_d
        go = go_d.cpu()
        syncs += 1
        while bool(go.any()):
            f = f & go_d[:, None]
            explored = torch.where(f, dist_of(tent, packed), explored)
            in_s = in_s | f                          # paper: move into S
            tent, o = backend.sweep(tent, f, i, light=True, packed=packed)
            over = over | o
            inner += go.to(torch.int32)
            f, go_new, _ = backend.scan(dist_of(tent, packed), explored,
                                        i[:, None])
            go_d = go_new & go_d                     # a drained lane stays so
            go = go_d.cpu()
            syncs += 1
        # heavy pass from S; a frozen lane's S is empty
        tent, o = backend.sweep(tent, in_s, i, light=False, packed=packed)
        over = over | o
        _, _, nxt = backend.scan(dist_of(tent, packed), explored,
                                 i[:, None])
        i = torch.where(act_d, nxt, i)
        outer += act.to(torch.int32)
        act = act & (i.cpu() < _IMAX)
        syncs += 1
    return ManyOut(tent, outer, inner, over.cpu(), syncs + 1)


def _run_one_warm(backend: RelaxBackend, tent0, explored0, *, n: int,
                  packed: bool, device) -> RunOut:
    """Warm-start solve loop (the dynamic repair path, DESIGN.md §11):
    the bucket loop entered with a *repaired* state instead of the
    all-INF cold one. ``tent0`` are upper-bound tent words (dist, or
    packed (dist, pred)); ``explored0`` holds the tent value each vertex
    last relaxed its edges at (its old settled distance), so exactly the
    vertices whose tent the repair improved or reset satisfy ``tent <
    explored`` and re-enter their buckets, and the unsettled-only
    next-bucket scan skips every bucket the repair never touched."""
    return _run_backend(backend, None, n=n, packed=packed, device=device,
                        init=(tent0, explored0))


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


def _run_backend(backend: RelaxBackend, source: Optional[int], *, n: int,
                 packed: bool, device, stop=None, init=None) -> RunOut:
    """Outer/inner Δ-stepping loop (paper Alg. 1) over one backend. Same
    op sequence on the same states as the reference's ``_run_backend``
    with no ``inner_stop`` hook, so tent words and counters are bitwise
    the reference's.

    ``stop`` is the optional early-exit predicate ``(tent, explored,
    next_bucket) -> device bool`` checked between buckets, as the
    reference's ``outer_cond`` checks it: before bucket 0 (with
    ``next_bucket = 0``) and after every bucket. Each check is read in
    the same transfer as the flag the loop reads there anyway (the
    priming scan's, or the fused loop's first step's, before bucket 0;
    the next bucket after each bucket), so it adds no host
    synchronisation. ``None`` keeps the full-solve loop unchanged.

    ``init`` is an optional warm ``(tent0, explored0)`` state (the
    dynamic repair path, DESIGN.md §11; ``source`` is then unused);
    ``None`` is the cold all-INF start. Either way the loop starts at
    bucket 0, and the host syncs stay ``2 * buckets + inner_iters +
    1``."""
    if init is None:
        tent = init_tent(n, source, packed, device)
        explored = torch.full((n,), _INF, dtype=torch.int32, device=device)
    else:
        tent, explored = init
    tent0 = tent
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
# the frontier-policy loop (DESIGN.md §15) — rho / radius stepping over
# the same relaxation backends
# ---------------------------------------------------------------------------

def _pending_min(d, explored):
    """Minimum tentative distance over *pending* vertices (``tent <
    explored``): every future tent value of a policy loop is >= it."""
    return torch.where(d < explored, d, _INF).min()


def _run_policy(backend: RelaxBackend, policy, source: Optional[int], *,
                n: int, packed: bool, device, stop=None,
                init=None) -> RunOut:
    """Round loop generic over a ``core.policies`` policy — the
    reference's ``_run_policy``. Each round: the
    policy threshold θ from the pending state, then a step of the
    value-closed frontier ``pending & (tent <= θ)``: mark it explored and
    sweep its full edge set (light phase, then heavy). A closure policy
    (radius) re-steps under the same θ until nothing pending is left at
    or below it. ``outer`` counts rounds, ``inner`` steps.

    ``stop`` is an optional ``(tent, explored) -> device bool`` checked
    before each round, read in the same transfer as the round condition.
    ``init`` is the warm ``(tent0, explored0)`` state of the dynamic
    repair path (``None``: the cold start from ``source``). Host syncs:
    one per round condition, one per closure condition, one for the
    overflow flag."""
    if init is None:
        tent = init_tent(n, source, packed, device)
        explored = torch.full((n,), _INF, dtype=torch.int32, device=device)
    else:
        tent, explored = init
    over = torch.zeros((), dtype=torch.bool, device=device)
    zero_i = 0  # dummy bucket id: only the grid stencil reads it, and
    # grid plans refuse non-delta policies
    outer, inner, syncs = 0, 0, 0

    def step(tent, explored, theta, over):
        d = dist_of(tent, packed)
        f = (d < explored) & (d <= theta)
        explored = torch.where(f, d, explored)
        tent, o1 = backend.sweep(tent, f, zero_i, light=True, packed=packed)
        tent, o2 = backend.sweep(tent, f, zero_i, light=False, packed=packed)
        return tent, explored, _or(_or(over, o1), o2)

    while True:
        d = dist_of(tent, packed)
        go, halt = _read((d < explored).any(),
                         None if stop is None else stop(tent, explored))
        syncs += 1
        if not go or halt:
            break
        theta = policy.threshold(d, explored)
        if policy.closure:
            while True:
                d = dist_of(tent, packed)
                go = bool(((d < explored) & (d <= theta)).any())
                syncs += 1
                if not go:
                    break
                tent, explored, over = step(tent, explored, theta, over)
                inner += 1
        else:
            tent, explored, over = step(tent, explored, theta, over)
            inner += 1
        outer += 1
    return RunOut(tent, outer, inner, bool(over), syncs + 1)


def _run_policy_one(backend: RelaxBackend, source: int, *, policy, n: int,
                    packed: bool, device) -> RunOut:
    """Single-source policy solve."""
    return _run_policy(backend, policy, source, n=n, packed=packed,
                       device=device)


def _run_policy_p2p(backend: RelaxBackend, source: int, target: int, *,
                    policy, n: int, packed: bool, device) -> RunOut:
    """Point-to-point early exit under a policy loop: stop once
    ``tent[target] <= min pending tent`` — sound for every policy, since
    each round sweeps the full edge set of what it relaxes."""
    def stop(tent, explored):
        d = dist_of(tent, packed)
        return (d[target] < _INF) & (d[target] <= _pending_min(d, explored))

    return _run_policy(backend, policy, source, n=n, packed=packed,
                       device=device, stop=stop)


def _run_policy_bounded(backend: RelaxBackend, source: int, radius: int, *,
                        policy, n: int, packed: bool, device) -> RunOut:
    """Bounded-radius policy solve: stop once the pending minimum
    exceeds ``radius``; tent values beyond are bounds the caller
    filters."""
    def stop(tent, explored):
        return _pending_min(dist_of(tent, packed), explored) > radius

    return _run_policy(backend, policy, source, n=n, packed=packed,
                       device=device, stop=stop)


def _run_policy_warm(backend: RelaxBackend, tent0, explored0, *, policy,
                     n: int, packed: bool, device) -> RunOut:
    """Warm-start policy solve (DESIGN.md §11/§15): the policy round
    loop entered with the repaired state. The repair only manufactures
    ``tent < explored`` on the repair cone, and the pending rule is what
    every policy selects from, so warm == cold holds per policy."""
    return _run_policy(backend, policy, None, n=n, packed=packed,
                       device=device, init=(tent0, explored0))


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


def _finish_pred_many(tent, coo: COOGraph, sources, cfg: DeltaConfig):
    """Batched ``_finish_pred`` (leading lane axis on ``tent``): argmin
    recovery lane by lane, or the packed words unpacked with each lane's
    source set to -1."""
    packed = cfg.pred_mode == "packed"
    dist = dist_of(tent, packed)
    if cfg.pred_mode == "none":
        pred = torch.full(dist.shape, -1, dtype=torch.int32,
                          device=dist.device)
    elif packed:
        pred = torch.where(dist < _INF, packing.unpack_pred(tent), -1)
        pred = pred.to(torch.int32)
        lanes = torch.arange(len(sources), device=dist.device)
        pred[lanes, torch.as_tensor([int(s) for s in sources],
                                    dtype=torch.int64,
                                    device=dist.device)] = -1
    else:
        pred = torch.empty_like(dist)
        for b, s in enumerate(sources):
            pred[b] = pred_argmin(dist[b], coo.src, coo.dst, coo.w, int(s),
                                  n=coo.n_nodes)
    return dist, pred


# ---------------------------------------------------------------------------
# the reference's deprecated entry points
# ---------------------------------------------------------------------------

def _deprecated_shim(name: str):
    raise NotImplementedError(
        f"{name} is a deprecated shim in the reference and is not ported "
        "(ROADMAP Queue 1 item 13); use repro_torch.api.Engine(graph, "
        "config).plan().solve(query)")


class DeltaSteppingSolver:
    """The reference's deprecated solver shim: not ported; raises."""

    def __init__(self, *args, **kwargs):
        _deprecated_shim("DeltaSteppingSolver")


def delta_stepping(*args, **kwargs):
    """The reference's deprecated one-shot solve: not ported; raises."""
    _deprecated_shim("delta_stepping")


__all__ = [
    "DeltaConfig",
    "DeltaSteppingSolver",
    "ManyOut",
    "P2P_MODES",
    "POLICIES",
    "RunOut",
    "SSSPResult",
    "delta_stepping",
    "pred_argmin",
]
