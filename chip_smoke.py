#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Set-up: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the hand-written kernels from
   ``src/repro_torch/csrc`` (timed).
2. Each kernel against its plain PyTorch twin on the card, with
   ``torch.equal`` on every output (integers: zero tolerance), at the
   main path's shapes — mid-solve ``tent``/``explored`` states recorded
   from a solve of the full-width graph below — and on edge cases: a
   length that is not a multiple of the block size, ``cap`` below the
   frontier population, all-INF input, sentinel ``fidx``, a
   zero-width ELL block, ``bucket_scan`` on int32 input over the whole
   range with negative buckets and buckets past int32, views 4 bytes
   past 16-byte alignment (the scalar paths of ``bucket_scan`` and
   ``ell_relax``) and n = 0; ``frontier_relax`` over the same int32
   range and buckets, on an unaligned view (its scalar scan), with a
   shard's ``base``/``sent``, and in calls of different S and ``cap``
   queued back to back on one stream.
3. The main path at full width: ``watts_strogatz(1_000_000, 20, 1e-2)``
   (20 M directed edges, weights 1..20), Δ = 10, source 0, solved
   through ``Engine(...).plan().solve(SingleSource(0))`` on CUDA with
   ``fused``, ``pallas``, ``ell`` and ``edge`` (pred_mode ``argmin``) and
   ``fused`` with ``packed``. The launch counters are set to 0 just
   before and read just after. All runs must agree bitwise (dist, pred,
   buckets, inner_iters, overflow); ``dist`` must equal scipy's Dijkstra
   on the edge list with duplicate (u, v) pairs reduced to their minimum
   weight, and ``pred`` must be a shortest-path tree.
4. The scale-free family: ``rmat(2**20, 16 * 2**20)`` under ``edge`` with
   the same oracle check (the ELL strategies pad every row to the
   maximum degree, which R-MAT makes huge).
5. The game-map path at full width, the repo's ``sssp-gamemap``
   configuration: ``grid_map(3000, 3000, 0.1, seed=0)`` (9 M cells,
   ~58 M directed edges, costs 10 / 14), Δ = 13, the first free cell as
   source, through ``Engine(..., free_mask=free)`` on CUDA
   (``GridPallasBackend``: the ``grid_relax`` stencil and
   ``bucket_scan``). ``grid_relax`` against its twin on sweep inputs
   recorded from the warm-up solve and on edge cases on both of its
   paths (1 x 1, 1 x W, H x 1, widths a multiple of 4 and not, heights
   no multiple of its row band, a ``tent`` 4 bytes past 16-byte
   alignment, all-blocked, all-INF, values within 14 of INF, a bucket
   past int32, Δ = 5 / 13 / 20); ``bucket_scan`` against its twin on
   scan inputs recorded from the same solve (after light sweeps, after
   heavy passes and before the first sweep). Then the path's main run,
   with the counters set to 0 just before and read just after:
   ``SingleSource`` with ``dist`` equal to scipy's Dijkstra and ``pred``
   a shortest-path tree, and launches equal to ``buckets +
   inner_iters`` (``grid_relax``) and ``2 * buckets + inner_iters``
   (``bucket_scan``). Then ``GridDeltaSolver`` with its default config
   (dist equal, and ``outer_iters + inner_iters`` launches of the
   kernel); ``PointToPoint`` to the last free cell and to a cell near
   the source (distance equal to the single-source ``dist``, a valid
   path of that weight, fewer buckets for the near target);
   ``BoundedRadius(1000)`` (the single-source
   answer filtered at 1000); on a 512 x 512 map the grid plan bitwise
   equal to ``edge`` (dist, pred, buckets, inner_iters); median times
   of three of each query after warm-up; one profiled solve.
6. Times: per strategy the median solve wall time of three solves after
   the warm-up, with host synchronisations and counters.
7. One profiled solve per strategy (``torch.profiler``): device busy
   time, idle share, the kernels that take the most device time, and
   the profiler's records of each port kernel against its wrapper's
   launches. Per kernel at the main path's shapes: device time per
   wrapper call and its twin's, from CUDA events around back-to-back
   calls that the host queues during a device-side spin (so no host
   time enters the window); ``wrapper_ms``, the same calls back to back
   with the host's launch time in them; ``cold_ms``, CUDA events around
   each call after a 128 MiB write that empties the L2 and a
   device-side spin in which the host queues the call (both outside the
   timed window); the
   profiler's breakdown by kernel where it kept a record of every
   launch (it loses records of windows a few ms long), where a call
   must show only its wrapper's own kernels, one each (one for
   ``bucket_scan`` and ``ell_relax``, two for ``frontier_relax``), or
   the run fails; a yardstick per path (a PyTorch call moving part of
   the kernel's bytes: ``fill_`` of the outputs for ``ell_relax`` and
   ``frontier_relax``); on the game-map path
   ``in_solve_ms``, the profiled solve's device time of the kernel over
   its launches (null where the profiler dropped a record); and its
   bound (the bytes this input needs ÷ 3.35 TB/s, or its integer
   operations ÷ 16.7 T/s, the int32 rate, if larger; the run fails
   where ``ms`` or ``cold_ms`` falls below it),
   at each path's shapes (``bucket_scan`` runs on the small-world and
   the game-map paths: n = 1 M and n = 9 M). ``launches`` in the
   kernels line sums every path's counted runs (phases 3, 5, 8, 9);
   ``by_path`` gives each path's launches and numbers, and the entry's
   ``ms``, ``cold_ms``, ``plain_ms`` and ``bound_ms`` are their means
   weighted by those launches, so they move when a path is added.

8. Batched queries and frontier policies, on the graphs above (run
   after phase 4; the game-map part at the end of phase 5). On the
   1 M-vertex small-world graph: ``MultiSource`` of 8 fixed sources (0
   and seven spread ids) on ``edge`` and ``ell`` (one ``[B, n]`` loop,
   fewer host syncs than the lanes' single solves together), of 2
   sources on ``pallas`` and ``fused`` (lane by lane through the
   kernels, launches equal to the lanes' per-solve equations); every
   lane bitwise equal to ``edge``'s ``SingleSource`` of its source
   (phase 3 holds every strategy's single solve bitwise equal to
   ``edge``'s), and lane 3 equal to scipy's Dijkstra. ``ManyToMany`` (16
   sources, 1000 targets, tile 8, ``edge``) equal to the ``MultiSource``
   rows. ``frontier_cap=4096`` on ``ell``, ``pallas`` and ``fused``:
   without fallback the solve reports overflow, launches its kernels by
   its own counters' equations and answers bitwise as the same plan on
   the CPU; with ``fallback=True`` it answers as the uncapped plan of
   phase 3, with ``telemetry.fallback`` and
   ``explain()["fallback_taken"]`` set, and launches what the capped
   solve and the full-width twin's solve launch together. ``rho``
   (default ρ) and ``radius`` (k = 4) on ``edge`` and ``pallas``:
   ``dist`` and argmin ``pred`` equal to the delta answer, two
   ``ell_relax`` launches per policy step on ``pallas`` and no bucket
   scan; ``PointToPoint`` and ``BoundedRadius`` under ``rho``. On the
   game map: ``MultiSource`` of 2 sources on the grid plan, each lane
   equal to its single solve, launches equal to the lanes' equations.
   Wall times (median of 3; one timed run, apart from the counted one,
   for the lane-by-lane batches, ``ell``'s batch, ``ManyToMany`` and
   the fallback), host syncs and launches per path. The counters are
   set to 0 just before each counted run and read just after; each
   path's launches join ``by_path`` in the kernels line
   (``smallworld_multisource``, ``smallworld_policy``,
   ``smallworld_fallback`` for the capped solves,
   ``smallworld_fallback_twin`` for the full-width re-solves,
   ``gamemap_multisource``), and each kernel is timed and held against
   its twin on every path at that path's own recorded input with the
   largest frontier (lane 1 of a batch; the policy solves; the capped
   solves, ``fidx`` of 4096 rows; a re-solve is phase 3's solve, so
   its inputs are phase 2's).

9. Dynamic graphs (run after phase 7; it updates phase 3's plans), on
   the 1 M-vertex small-world graph with the update protocol of
   ``benchmarks/bench_dynamic.py:_batches`` (seeded id sets of k =
   20 000 and 200 000 edges, 0.1 % and 1 % of |E|, each with two
   distinct weight assignments ``clip(w0 + U[-5, 5], 1, 20)``, cycled so
   no batch is a no-op). ``edge``, ``ell``, ``pallas`` and ``fused``
   (argmin) and ``fused`` (packed): ``SingleSource(0)``, two warm-up
   batches, then per k the counted ``plan.solve(UpdateBatch(...))``:
   warm with ``repaired > 0``, ``dist``/``pred`` bitwise equal to every
   other strategy's warm answer, to a fresh ``Engine``'s cold solve of
   the updated graph on ``edge`` and to the plan's own
   ``resolve(warm=False)`` on the others, ``dist`` equal to scipy's Dijkstra
   once per k and ``pred`` a shortest-path tree, and launches equal to
   the warm runs' own equations (``pallas`` on its rebuilt backend;
   the ``fused`` twin by ``fused``'s; a twin overflow's full-width
   re-run adds its own). Then, timed: three more batches (update +
   warm resolve, split into update, host repair planning, warm backend,
   device loop and the rest, each part checked to be timed, with host
   syncs) and three ``resolve(warm=False)``,
   the first held equal to the warm answer (at 1 % on the strategies
   ``DYN_TIMED_1PCT`` only). ``rho`` and ``radius`` (k = 4) on ``edge``
   and ``pallas``: one counted warm batch equal to the cold solve of
   the updated graph. ``square_lattice(1000, weighted=True)`` under
   ``edge``, ``pallas`` and ``fused``: the tree edge into the vertex
   farthest from the source raised by 7 and restored, each warm answer
   equal to the cold one with far fewer buckets; three more flips
   timed. One profiled warm ``pallas`` batch. The counted runs join
   ``by_path`` as ``smallworld_warm`` and ``lattice_warm``.

10. Landmark point-to-point queries (run after phase 7 and before phase
   9, on plans of their own, so phase 3's scipy distances are the
   oracle). On the 1 M-vertex small-world graph, a fresh ``edge`` plan
   (Δ = 10): ``prepare_landmarks(k=4)`` (farthest, seed 0, tables in a
   temporary store directory), timed and split into ``graph_stats``,
   fingerprint, whash and selection + rows; one landmark's ``d_out`` and
   ``d_in`` rows equal to scipy on the forward and the reversed edge
   list; the all-light ELL blocks' host build, timed. ``early_exit``,
   ``alt``, ``bidirectional`` and ``alt_bidirectional`` from source 0 to
   the farthest vertex (largest finite distance, lowest id) and to the
   vertex at the median finite distance (lowest id): distance equal to
   scipy's, a valid path of that weight, ``host_syncs == 2 * buckets +
   inner_iters + 1``, no overflow; wall times (median of 3 after one
   warm-up to the far target, one run to the near one). One profiled
   ``alt`` query: device busy time, idle share and the scatter's share,
   with its records held against ``2 * (buckets + inner_iters) + 1``
   (a compaction and a scatter-min per sweep, one scatter-min in pred
   recovery). A second plan's ``prepare_landmarks`` hits the store
   (timed; tables bitwise equal). Phase 9's update protocol at k =
   20 000: an increase-only batch keeps the tables (``alt`` equal to
   scipy on the updated weights), the raw batch (with decreases) drops
   them under ``recompute`` and the next ``alt`` rebuilds them and
   equals ``early_exit``; under ``on_update="refuse"`` a decreasing
   batch raises ``LandmarkRefused(reason="landmarks_stale")`` with the
   weights bitwise unchanged. On the 512 x 512 game map (Δ = 13) as a
   grid plan, each landmark mode from the first to the last free cell:
   distance equal to the grid plan's ``SingleSource``, a valid path. The
   launch counters are set to 0 after the game map's reference solve
   and read at the end of the phase: all four must read 0 (the landmark
   solves run an all-light ``EllBackend``; no kernel is on their path).

Any failure raises and exits non-zero. The last three lines are the
card's nvidia-smi line, one ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the repository around it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM int32 rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the
# data sheet's 67 T/s is float32 with an FMA counted as two operations)
ALU_OPS_PER_S = 16.7e12
# a write of this many bytes between launches leaves the 50 MB L2 cold
FLUSH_BYTES = 128 * 2**20
# device clock cycles (~0.5 ms) of a spin after the flush, in which the
# host queues the timed call, so host time never enters the window
QUEUE_CYCLES = 1_000_000
# H100 SXM boost clock, to size a spin in which the host queues calls
CLOCK_HZ = 1.98e9
# the CUDA kernel each counted wrapper launches first, once per call
KERNEL_SYMBOL = {"bucket_scan": "bucket_scan_kernel",
                 "ell_relax": "ell_relax_kernel",
                 "frontier_relax": "frontier_scan_kernel",
                 "grid_relax": "grid_relax_kernel"}
# a call's whole device work, per checked wrapper: its own kernels, one
# launch each. A profile that kept every launch's record and shows more
# device operations per call, or another one, fails the run.
OWN_KERNELS = {"bucket_scan": ("bucket_scan_kernel",),
               "ell_relax": ("ell_relax_kernel",),
               "frontier_relax": ("frontier_scan_kernel",
                                  "frontier_gather_kernel")}
INF = 2**31 - 1
N_NODES, DEGREE, P_REWIRE, DELTA = 1_000_000, 20, 1e-2, 10
# the repo's game-map configuration (src/repro/configs/sssp_archs.py:27)
GRID_SIDE, OBSTACLES, GRID_DELTA, SMALL_SIDE = 3000, 0.1, 13, 512
# sweeps of the warm-up solve whose inputs are kept (light and heavy)
GRID_PICKS = frozenset({0, 1, 2, 3, 100, 101, 102, 1000, 1001, 1002,
                        3000, 3001, 3002, 6000, 6001, 6002})
# bucket_scan calls of the warm-up solve whose inputs are kept
SCAN_PICKS = frozenset(range(0, 13000, 500)) | {1, 2, 3, 4, 5, 6}
# phase 8: 0 and seven spread sources; 16 sources and 1000 targets for
# ManyToMany (its first tile is BATCH_SOURCES); the capped plans' cap
BATCH_SOURCES = (0, 131_071, 262_147, 393_209, 524_287, 655_357, 786_431,
                 917_503)
M2M_SOURCES = BATCH_SOURCES + (65_537, 196_613, 327_673, 458_747, 589_811,
                               720_887, 851_957, 999_999)
M2M_TARGETS, M2M_TILE, CAP, RADIUS_K = 1000, 8, 4096, 4
SW_KERNELS = ("bucket_scan", "ell_relax", "frontier_relax")
# phase 9: 0.1 % and 1 % of |E| per batch, two id sets per k (bench
# protocol), the strategies timed at 1 %, and the lattice
DYN_KS, DYN_SETS, DYN_SEED = (20_000, 200_000), 2, 5
DYN_TIMED_1PCT = ("edge", "pallas")
LATTICE_SIDE, LATTICE_STRATEGIES = 1000, ("edge", "pallas", "fused")
# phase 10: landmarks per plan, the update batch size (phase 9's
# protocol), the point-to-point modes
LANDMARK_K, LM_DYN_K = 4, 20_000
LM_MODES = ("early_exit", "alt", "bidirectional", "alt_bidirectional")


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, iters: int) -> float:
    """Mean device time per call of ``fn`` from CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def synced(torch, ms: dict, part: str, fn):
    """``fn`` wrapped to add its wall time, ended by a synchronize, to
    ``ms[part]``."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ms[part] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapped


def cold_ms(torch, fn, iters: int, scratch) -> float:
    """Mean device time per call of ``fn`` with the L2 cold: CUDA events
    around each call, after a write of ``scratch`` (larger than the L2)
    and a device-side spin in which the host queues the call, both
    outside the timed window; one warm-up call first."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for k, (start, end) in enumerate(events):
        scratch.fill_(k)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def queued_ms(torch, fn, iters: int, per_call_ms: float):
    """Mean device time per call of ``iters`` back-to-back calls of
    ``fn`` from CUDA events, the L2 as the calls leave it. A device-side
    spin, sized from ``per_call_ms`` (the host time of one call at most),
    precedes the start event, and the host queues every call during it,
    so no host time enters the window. Returns ``(ms, ahead)``: ``ahead``
    is false when the spin still ended before the host had queued the
    calls, after two longer tries (``fn`` synchronises, and its host
    gaps are in ``ms``). One warm-up call first."""
    fn()
    torch.cuda.synchronize()
    cycles = QUEUE_CYCLES + int(4 * iters * per_call_ms * 1e-3 * CLOCK_HZ)
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if ahead:
            break
        cycles *= 4
    return start.elapsed_time(end) / iters, ahead


def profiled(torch, fn, iters: int = 1, counters=None):
    """Device time per call of ``fn`` by CUDA kernel name, in ms, from
    ``torch.profiler``, the wall time per call of the profiled calls,
    per counted wrapper ``(records, launches)``: the profiler's records
    of the wrapper's kernel (``KERNEL_SYMBOL``) against the launches its
    counter saw in the window, and the records of every kernel name.
    The profiler loses records of windows a few ms long, so its times
    stand only where the records agree with the launches."""
    from torch.profiler import ProfilerActivity, profile
    counters = counters or {}
    fn()
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kern, counts, records = {}, {}, dict.fromkeys(counters, 0)
    for e in prof.key_averages():
        dt = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            kern[e.key] = kern.get(e.key, 0.0) + dt / 1e3 / iters
            counts[e.key] = counts.get(e.key, 0) + e.count
            for k in counters:
                if KERNEL_SYMBOL[k] in e.key:
                    records[k] += e.count
    seen = {k: (records[k], f.launches - before[k])
            for k, f in counters.items()}
    return kern, wall, seen, counts


def seen_line(seen) -> str:
    """The profiler's kernel records against the counted launches."""
    return ", ".join(f"{k} {r} of {n}" for k, (r, n) in seen.items() if n)


def same(torch, a, b) -> int:
    """Max |a - b| over two output tuples (integers and flags); fails
    unless they are bitwise equal."""
    check(len(a) == len(b), "output arity")
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype {tuple(x.shape)} {x.dtype} vs "
              f"{tuple(y.shape)} {y.dtype}")
        if x.numel():
            diff = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, int(diff))
        check(torch.equal(x, y), "kernel differs from its twin")
    return err


def dedup_min(src, dst, w, n):
    """Edge list with duplicate (u, v) pairs reduced to their minimum
    weight, sorted by key u * n + v."""
    import numpy as np
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    return key[first], w[first].astype(np.int64)


def oracle_dist(g, source: int = 0):
    """scipy Dijkstra on the deduplicated graph, INF32 for unreachable."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = g.n_nodes
    key, w = dedup_min(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                       g.w.cpu().numpy(), n)
    mat = sp.csr_matrix((w.astype(np.float64), (key // n, key % n)),
                        shape=(n, n))
    d = dijkstra(mat, directed=True, indices=source)
    out = np.full(n, INF, np.int64)
    fin = np.isfinite(d)
    out[fin] = d[fin].astype(np.int64)
    return out, (key, w)


def check_tree(dist, pred, source, keyed):
    """Each reachable non-source v has an edge (pred[v], v) with
    dist[pred] + w == dist[v] (vectorised over the deduplicated edges)."""
    import numpy as np
    key, w = keyed
    n = dist.shape[0]
    v = np.flatnonzero(dist < INF)
    v = v[v != source]
    p = pred[v].astype(np.int64)
    check((p >= 0).all(), "reachable vertex without predecessor")
    k = p * n + v
    idx = np.searchsorted(key, k)
    idx = np.minimum(idx, key.shape[0] - 1)
    check((key[idx] == k).all(), "predecessor edge missing from graph")
    check((dist[p] + w[idx] == dist[v]).all(), "predecessor edge not tight")
    check(pred[source] == -1 and (pred[dist >= INF] == -1).all(),
          "pred sentinels")


def check_path(path, source, target, distance, keyed, n):
    """``path`` runs source -> target over edges of the graph whose
    weights sum to ``distance``."""
    import numpy as np
    key, w = keyed
    check(path is not None and path[0] == source and path[-1] == target,
          "path endpoints")
    p = np.asarray(path, np.int64)
    k = p[:-1] * n + p[1:]
    idx = np.minimum(np.searchsorted(key, k), key.shape[0] - 1)
    check((key[idx] == k).all(), "path step is not an edge")
    check(int(w[idx].sum()) == distance, "path weights do not sum to the "
          "distance")


def game_map_path(torch, np, cuda, counters):
    """Phase 5: the game-map path at full width (``grid_map(3000, 3000,
    0.1)``, Δ = 13, the first free cell as source) through
    ``Engine(..., free_mask=free)`` on CUDA, and phase 8's ``MultiSource``
    on it. Returns the path's launch counts, its per-solve counts, the
    recorded ``grid_relax`` and ``bucket_scan`` inputs with the largest
    frontier (of the single solve, and of the batch's lane 1) to time
    the kernels on, each kernel's device time in the solve, and the
    batch's launch counts."""
    import repro_torch.core.backends as backends
    from repro_torch.api import (BoundedRadius, Engine, MultiSource,
                                 PointToPoint, SingleSource)
    from repro_torch.core import DeltaConfig, GridDeltaConfig, GridDeltaSolver
    from repro_torch.graphs import grid_map
    from repro_torch.kernels.bucket_scan import bucket_scan_cuda, \
        bucket_scan_ref
    from repro_torch.kernels.grid_relax import (grid_relax_cuda,
                                                grid_relax_ref, vector_path)

    t0 = time.perf_counter()
    g, free = grid_map(GRID_SIDE, GRID_SIDE, OBSTACLES, seed=0)
    n = g.n_nodes
    src = int(np.flatnonzero(free.ravel())[0])
    log(f"[grid] grid_map {GRID_SIDE}x{GRID_SIDE}, obstacles {OBSTACLES}: "
        f"n={n} |E|={g.n_edges} free={int(free.sum())} source {src}, "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_dist, keyed = oracle_dist(g, src)
    log(f"[grid] scipy dijkstra in {time.perf_counter() - t0:.1f} s; "
        f"reachable {int((ref_dist < INF).sum())}, max dist "
        f"{int(ref_dist[ref_dist < INF].max())}")
    cfg = DeltaConfig(delta=GRID_DELTA, strategy="pallas", pred_mode="argmin")
    plan = Engine(g, cfg, free_mask=free, device=cuda).plan()
    check(isinstance(plan.backend, backends.GridPallasBackend),
          "the grid plan does not route to the stencil")

    # -- 5a. record mid-solve sweep and scan inputs (the warm-up solve) -----
    rec, calls = [], [0]
    scans, scan_calls, last = [], [0], ["start"]
    real, real_scan = backends.grid_relax, backends.bucket_scan

    def recorder(tent, free_, i, **kw):
        if calls[0] in GRID_PICKS:
            rec.append((tent.clone(), free_, i, kw))
        calls[0] += 1
        last[0] = "light" if kw["light"] else "heavy"
        return real(tent, free_, i, **kw)

    def scan_recorder(dist, explored, i, **kw):
        out = real_scan(dist, explored, i, **kw)
        if scan_calls[0] in SCAN_PICKS:
            scans.append(((dist.clone(), explored.clone(), i), kw, last[0],
                          int(out[0].sum())))
        scan_calls[0] += 1
        return out

    backends.grid_relax, backends.bucket_scan = recorder, scan_recorder
    try:
        plan.solve(SingleSource(src))
    finally:
        backends.grid_relax, backends.bucket_scan = real, real_scan
    torch.cuda.synchronize()
    check({kw["light"] for _, _, _, kw in rec} == {True, False},
          "no light and heavy sweep recorded")
    check({after for _, _, after, _ in scans} == {"start", "light", "heavy"},
          "no scan recorded after a light sweep, a heavy pass and the start")

    # -- 5b. grid_relax against its twin on the card -----------------------
    def frontier_size(t, i):
        return int(((t < INF) & (t // GRID_DELTA == i)).sum())

    for t, f, i, kw in rec:
        same(torch, (grid_relax_cuda(t, f, i, **kw),),
             (grid_relax_ref(t, f, i, **kw),))
        torch.cuda.synchronize()
    lights = [r for r in rec if r[3]["light"]]
    main_case = max(lights, key=lambda r: frontier_size(r[0], r[2]))
    check(vector_path(main_case[0], main_case[1],
                      torch.empty_like(main_case[0])),
          "the full-width sweep does not take the vector path")
    log(f"[kernel] grid_relax: {len(rec)} mid-solve states of {calls[0]} "
        f"sweeps equal to the twin (largest light frontier "
        f"{frontier_size(main_case[0], main_case[2])} cells)")
    rng = np.random.default_rng(1)
    edge_cases, paths = 0, {True: 0, False: 0}
    for shape in ((1, 1), (1, 5000), (5000, 1), (37, 129), (1000, 1000),
                  (37, 4), (45, 128), (33, 132), (70, 3000), (300, 517),
                  (41, 3)):
        t = rng.integers(0, 60, size=shape).astype(np.int64)
        t[rng.random(shape) < 0.3] = INF
        near = rng.random(shape) < 0.15
        t[near] = INF - rng.integers(1, 15, size=int(near.sum()))
        t = torch.from_numpy(t.astype(np.int32)).to(cuda)
        f = torch.from_numpy(rng.random(shape) >= 0.2).to(cuda)
        # a contiguous view 4 bytes past 16-byte alignment: scalar path
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        shifted = flat[1:].view(shape)
        shifted.copy_(t)
        check(not vector_path(shifted, f, torch.empty_like(t)),
              "an unaligned tent took the vector path")
        check(vector_path(t, f, torch.empty_like(t)) == (shape[1] % 4 == 0),
              "the path does not follow the width")
        for tt, ff in ((t, f), (t, torch.zeros_like(f)),
                       (torch.full_like(t, INF), f), (shifted, f)):
            paths[vector_path(tt, ff, torch.empty_like(t))] += 1
            for delta in (5, 13, 20):
                for light in (True, False):
                    for i in (2, (INF - 8) // delta, INF // delta + 1):
                        kw = dict(delta=delta, cost_straight=10,
                                  cost_diag=14, light=light)
                        same(torch, (grid_relax_cuda(tt, ff, i, **kw),),
                             (grid_relax_ref(tt, ff, i, **kw),))
                        edge_cases += 1
    torch.cuda.synchronize()
    log(f"[kernel] grid_relax: {edge_cases} edge cases equal to the twin "
        f"({paths[True]} inputs on the vector path, {paths[False]} on the "
        "scalar path): 1x1, 1xW, Hx1, widths 1 / 3 / 4 / 128 / 129 / 132 / "
        "517 / 1000 / 3000 / 5000 at heights no multiple of 32, a tent 4 "
        "bytes past 16-byte alignment; as drawn, all-blocked and all-INF; "
        "values within 14 of INF in the swept bucket, a bucket past int32 "
        "(i * Δ > INT32_MAX); Δ = 5 / 13 / 20, both phases")

    # -- 5b'. bucket_scan against its twin at n = 9 M -----------------------
    for (t, e, i), kw, _, _ in scans:
        same(torch, bucket_scan_cuda(t, e, i, delta=kw["delta"]),
             bucket_scan_ref(t, e, i, delta=kw["delta"]))
        torch.cuda.synchronize()
    scan_case = max(scans, key=lambda r: r[3])
    log(f"[kernel] bucket_scan at n={n}: {len(scans)} mid-solve states of "
        f"{scan_calls[0]} scans equal to the twin ("
        + ", ".join(f"{sum(r[2] == k for r in scans)} after {k}"
                    for k in ("start", "light", "heavy"))
        + f"; largest frontier {scan_case[3]} cells)")

    # -- 5c. the game-map main path -----------------------------------------
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    r = plan.solve(SingleSource(src))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tel = r.telemetry
    log(f"[grid] launches over the game-map main path: "
        f"{json.dumps(launches)}")
    check(launches["grid_relax"] == tel.buckets + tel.inner_iters,
          "grid_relax launches != buckets + inner_iters")
    check(launches["bucket_scan"] == 2 * tel.buckets + tel.inner_iters,
          "bucket_scan launches != 2 * buckets + inner_iters")
    dist = r.dist.cpu().numpy()
    pred = r.pred.cpu().numpy()
    check(dist.dtype == np.int32 and pred.dtype == np.int32, "dtypes")
    check(np.array_equal(dist.astype(np.int64), ref_dist),
          "gamemap: dist differs from the scipy oracle")
    check_tree(dist, pred, src, keyed)
    log(f"[grid] SingleSource: dist == oracle, pred tree ok, "
        f"buckets={tel.buckets} inner_iters={tel.inner_iters} "
        f"overflow={tel.overflow} host_syncs={plan.host_syncs} first solve "
        f"{wall * 1e3:.1f} ms")
    per_solve = {("gamemap", "argmin"): launches}

    # -- 5d. the standalone grid driver, default config ---------------------
    solver = GridDeltaSolver(free, GridDeltaConfig(), device=cuda)
    before = grid_relax_cuda.launches
    t0 = time.perf_counter()
    gr = solver.solve((src // GRID_SIDE, src % GRID_SIDE))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    solver_launches = grid_relax_cuda.launches - before
    check(np.array_equal(gr.dist.cpu().numpy().ravel(), dist),
          "GridDeltaSolver dist differs")
    check(solver_launches == gr.outer_iters + gr.inner_iters,
          "GridDeltaSolver did not sweep through the kernel")
    log(f"[grid] GridDeltaSolver (backend {solver.cfg.backend!r}): dist "
        f"equal, outer_iters={gr.outer_iters} inner_iters={gr.inner_iters} "
        f"grid_relax launches {solver_launches}, {wall * 1e3:.1f} ms")

    # -- 5e. point-to-point and bounded-radius queries ----------------------
    reach = np.flatnonzero((dist < INF) & (dist <= 100))
    near_t = int(reach[np.argmax(dist[reach])])
    far_t = int(np.flatnonzero(free.ravel())[-1])
    queries = {"p2p_far": PointToPoint(src, far_t),
               "p2p_near": PointToPoint(src, near_t),
               "bounded_1000": BoundedRadius(src, 1000)}
    answers = {}
    for name, q in queries.items():
        before = {k: fn.launches for k, fn in counters.items()}
        a = plan.solve(q)
        torch.cuda.synchronize()
        answers[name] = a
        per_solve[("gamemap", name)] = {
            k: fn.launches - before[k] for k, fn in counters.items()}
        check(a.telemetry.buckets <= tel.buckets, f"{name}: more buckets")
    for name in ("p2p_far", "p2p_near"):
        a, tgt = answers[name], queries[name].target
        check(a.distance == int(dist[tgt]), f"{name}: distance differs")
        check_path(a.path, src, tgt, a.distance, keyed, n)
        log(f"[grid] {name} {src}->{tgt}: distance {a.distance} == "
            f"SingleSource, path of {len(a.path) - 1} valid steps, "
            f"buckets={a.telemetry.buckets} "
            f"inner_iters={a.telemetry.inner_iters}")
    check(answers["p2p_near"].telemetry.buckets
          < answers["p2p_far"].telemetry.buckets,
          "the near target took no fewer buckets")
    b = answers["bounded_1000"]
    within = dist <= 1000
    check(np.array_equal(b.dist.cpu().numpy(), np.where(within, dist, INF)),
          "bounded dist differs from the filtered SingleSource dist")
    check(np.array_equal(b.pred.cpu().numpy(), np.where(within, pred, -1)),
          "bounded pred differs from the filtered SingleSource pred")
    log(f"[grid] bounded_1000: dist/pred == SingleSource filtered at 1000 "
        f"({int(within.sum())} cells), buckets={b.telemetry.buckets} "
        f"inner_iters={b.telemetry.inner_iters}")

    # -- 5f. the grid plan bitwise equal to edge on a smaller map -----------
    gs, fs = grid_map(SMALL_SIDE, SMALL_SIDE, OBSTACLES, seed=0)
    s_src = int(np.flatnonzero(fs.ravel())[0])
    out = {}
    for strategy, mask in (("pallas", fs), ("edge", None)):
        p = Engine(gs, DeltaConfig(delta=GRID_DELTA, strategy=strategy,
                                   pred_mode="argmin"), free_mask=mask,
                   device=cuda).plan()
        x = p.solve(SingleSource(s_src))
        out[strategy] = (x.dist.cpu().numpy(), x.pred.cpu().numpy(),
                         x.telemetry.buckets, x.telemetry.inner_iters)
    for k, name in enumerate(("dist", "pred", "buckets", "inner_iters")):
        check(np.array_equal(out["pallas"][k], out["edge"][k]),
              f"{SMALL_SIDE}x{SMALL_SIDE}: grid plan {name} differs from edge")
    log(f"[grid] {SMALL_SIDE}x{SMALL_SIDE}: grid plan bitwise equal to edge "
        f"(dist, pred, buckets={out['edge'][2]}, "
        f"inner_iters={out['edge'][3]})")

    # -- 5g. times -----------------------------------------------------------
    for name, q in [("SingleSource", SingleSource(src))] + list(
            queries.items()):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            a = plan.solve(q)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        log(f"[time] gamemap/{name}: median "
            f"{statistics.median(walls) * 1e3:.1f} ms over 3 after warm-up "
            f"({', '.join(f'{x * 1e3:.1f}' for x in walls)}), host_syncs="
            f"{plan.host_syncs}, buckets={a.telemetry.buckets}, "
            f"inner_iters={a.telemetry.inner_iters}")

    # -- 8 (game map). MultiSource on the grid plan, lane by lane -----------
    free_ids = np.flatnonzero(free.ravel())
    pair = [src, int(free_ids[free_ids.shape[0] // 2])]
    second = plan.solve(SingleSource(pair[1]))
    second_syncs = plan.host_syncs
    # the counted run also keeps each kernel's largest input of lane 1
    lane1 = Largest(backends, frontier_sizes(n, ("bucket_scan",
                                                 "grid_relax")),
                    lane=pair[1])
    for fn in counters.values():
        fn.launches = 0
    with lane1:
        m = plan.solve(MultiSource(pair))
        torch.cuda.synchronize()
    launches_multi = {k: fn.launches for k, fn in counters.items()}
    same_lanes(torch, m, [r, second], "gamemap MultiSource")
    mt = m.telemetry
    b, inner = int(mt.buckets.sum()), int(mt.inner_iters.sum())
    check(launches_multi["grid_relax"] == b + inner,
          "gamemap MultiSource: grid_relax launches != buckets + inner_iters")
    check(launches_multi["bucket_scan"] == 2 * b + inner,
          "gamemap MultiSource: bucket_scan launches != 2 * buckets + "
          "inner_iters")
    check(plan.host_syncs == tel.buckets * 2 + tel.inner_iters + 1
          + second_syncs, "gamemap MultiSource: host syncs != the lanes'")
    check(set(lane1.best) == {"bucket_scan", "grid_relax"},
          "gamemap MultiSource: no lane-1 input recorded")
    _, walls = walls_ms(torch, lambda: plan.solve(MultiSource(pair)), 1)
    log(f"[batch] gamemap MultiSource {pair}: lanes == SingleSource, "
        f"buckets={mt.buckets.tolist()} inner_iters={mt.inner_iters.tolist()}"
        f" host_syncs={plan.host_syncs} launches {json.dumps(launches_multi)}"
        f"; one timed run {walls[0]:.1f} ms = {walls[0] / 2:.1f} ms/source; "
        f"lane 1's largest frontiers: bucket_scan "
        f"{lane1.best['bucket_scan'][2]}, grid_relax "
        f"{lane1.best['grid_relax'][2]} cells")

    # -- 5h. where a grid solve's device time goes --------------------------
    kern, wall, seen, _ = profiled(
        torch, lambda: plan.solve(SingleSource(src)), counters=counters)
    busy = sum(kern.values())
    log(f"[profile] gamemap/argmin: profiled solve {wall:.1f} ms, device "
        f"busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}), "
        f"{len(kern)} kernel names; kernel records {seen_line(seen)}")
    for kname, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:9.3f} ms  {kname[:110]}")
    # each kernel's device time in the solve over its launches in the
    # profiled solve, where the profiler kept a record of every launch
    in_solve = {}
    for name in ("grid_relax", "bucket_scan"):
        total = sum(ms for k, ms in kern.items() if KERNEL_SYMBOL[name] in k)
        got, n_launch = seen[name]
        in_solve[name] = total / n_launch if got == n_launch else None
        log(f"[profile] gamemap/argmin: {name} {total:.1f} ms over "
            f"{n_launch} launches in the solve = "
            + (f"{in_solve[name]:.5f} ms/launch" if got == n_launch else
               f"not measured (the profiler kept {got} records)"))
    t, f, i, kw = main_case
    records = {"gamemap": {"grid_relax": ((t, f, i), kw,
                                          frontier_size(t, i)),
                           "bucket_scan": scan_case[:2] + scan_case[3:]},
               "gamemap_multisource": lane1.best}
    return launches, per_solve, records, in_solve, launches_multi


def same_lanes(torch, multi, singles, tag: str) -> None:
    """Each lane of a ``MultiSource`` answer is bitwise its single solve:
    dist, pred, buckets, inner_iters and overflow."""
    t = multi.telemetry
    check(multi.dist.shape[0] == len(singles), f"{tag}: lane count")
    for b, one in enumerate(singles):
        check(torch.equal(multi.dist[b], one.dist)
              and torch.equal(multi.pred[b], one.pred),
              f"{tag} lane {b}: dist/pred differ from SingleSource")
        check((int(t.buckets[b]), int(t.inner_iters[b]), bool(t.overflow[b]))
              == (one.telemetry.buckets, one.telemetry.inner_iters,
                  one.telemetry.overflow), f"{tag} lane {b}: counters differ")


class Largest:
    """While active, wraps the kernel dispatchers of ``core.backends``
    named in ``sizes`` and keeps, for each, the inputs of the call with
    the largest ``sizes[name](args, kw, out)``: among the calls whose
    distances (``args[DIST[name]]``) are 0 at vertex ``lane`` — the calls
    of the lane that solves from ``lane`` — or among all calls when
    ``lane`` is None. The state arguments are cloned. Sizing and cloning
    are tensor ops, not kernels, so the launch counts of the run it
    watches stay the kernels' own."""

    DIST = {"bucket_scan": 0, "ell_relax": 1, "frontier_relax": 0,
            "grid_relax": 0}
    STATE = {"bucket_scan": (0, 1), "ell_relax": (0, 1),
             "frontier_relax": (0, 1), "grid_relax": (0,)}

    def __init__(self, backends, sizes, lane=None):
        self.backends, self.sizes, self.lane = backends, sizes, lane
        self.best = {}

    def __enter__(self):
        self.real = {name: getattr(self.backends, name) for name in self.sizes}
        for name in self.sizes:
            setattr(self.backends, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.backends, name, fn)

    def _wrap(self, name):
        real, dist, state = self.real[name], self.DIST[name], self.STATE[name]

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            if (self.lane is None
                    or int(args[dist].reshape(-1)[self.lane]) == 0):
                size = self.sizes[name](args, kw, out)
                if name not in self.best or size > self.best[name][2]:
                    kept = tuple(a.clone() if k in state else a
                                 for k, a in enumerate(args))
                    self.best[name] = (kept, kw, size)
            return out
        return wrapped


def frontier_sizes(n: int, names):
    """For the kernels ``names``, the frontier size of a call on an
    ``n``-vertex graph: the rows it relaxes or the vertices of its bucket
    (``grid_relax``: light sweeps only, the phase its timing has always
    used)."""
    def grid(args, kw, out):
        t, _, i = args[:3]
        return (int(((t < INF) & (t // kw["delta"] == i)).sum())
                if kw["light"] else -1)
    sizes = {"bucket_scan": lambda a, kw, o: int(o[0].sum()),
             "ell_relax": lambda a, kw, o: int((a[0] < n).sum()),
             "frontier_relax": lambda a, kw, o: int(o[3]),
             "grid_relax": grid}
    return {name: sizes[name] for name in names}


def delta_launches(strategy: str, buckets: int, inner: int) -> dict:
    """The kernel launches of one bucket-loop run of ``buckets`` buckets
    and ``inner`` light iterations on a backend of ``strategy`` (``ell``
    and ``edge`` launch none)."""
    b = buckets
    return {"bucket_scan": {"pallas": 2 * b + inner,
                            "fused": b}.get(strategy, 0),
            "ell_relax": b + inner if strategy == "pallas" else 0,
            "frontier_relax": b + inner if strategy == "fused" else 0,
            "grid_relax": 0}


def walls_ms(torch, fn, reps: int):
    """``reps`` runs of ``fn``, each ended by a synchronize: the last
    result and the wall times in ms."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls


def fmt(walls) -> str:
    return (f"median {statistics.median(walls):.1f} ms of {len(walls)} ("
            + ", ".join(f"{x:.1f}" for x in walls) + ")")


def batch_and_policy_path(torch, np, cuda, g, keyed, plans, results,
                          counters):
    """Phase 8 on the 1 M-vertex small-world graph: batched queries, the
    overflow fallback and the frontier policies (see the module note).
    Returns the launches of the ``pallas``/``fused`` ``MultiSource``
    path, of the ``pallas`` policy path, of the capped solves (with and
    without the fallback) and of the full-width twins' re-solves, and per
    path each kernel's recorded input with the largest frontier (lane 1
    of the batch; the policy solves; the capped solves)."""
    import repro_torch.core.backends as backends
    from repro_torch.api import (BoundedRadius, Engine, ManyToMany,
                                 MultiSource, PointToPoint, SingleSource)
    from repro_torch.core import DeltaConfig

    t_phase = time.perf_counter()

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    # -- 8a. single solves on edge: the lanes' reference ------------------
    edge = plans[("edge", "argmin")]
    single, single_syncs, single_walls = {}, {}, []
    for s in BATCH_SOURCES:
        one, w = walls_ms(torch, lambda: edge.solve(SingleSource(s)), 1)
        single[s], single_syncs[s] = one, edge.host_syncs
        single_walls += w
    check(torch.equal(single[0].dist, results[("edge", "argmin")][0].dist),
          "edge SingleSource(0) changed since phase 3")
    log(f"[batch] edge SingleSource of the 8 sources: {fmt(single_walls)}, "
        f"host_syncs {sum(single_syncs.values())} together, buckets "
        f"{[single[s].telemetry.buckets for s in BATCH_SOURCES]}")

    # -- 8b. MultiSource on edge and ell: one [B, n] loop -----------------
    batch = {}
    # ell's batch takes ~11 s on the H100 (8 lanes of the sentinel-slot
    # scatter, PERF.md §6) and its runs spread by 0.1 %: one timed run
    for st, reps in (("edge", 3), ("ell", 1)):
        plan = plans[(st, "argmin")]
        zero()
        res, walls = walls_ms(
            torch, lambda: plan.solve(MultiSource(list(BATCH_SOURCES))), reps)
        check(all(v == 0 for v in read().values()),
              f"{st} MultiSource launched a kernel")
        same_lanes(torch, res, [single[s] for s in BATCH_SOURCES],
                   f"{st} MultiSource")
        check(plan.host_syncs < sum(single_syncs.values()),
              f"{st} MultiSource: no fewer host syncs than its lanes")
        batch[st] = res
        log(f"[batch] {st} MultiSource x{len(BATCH_SOURCES)} (one [B, n] "
            f"loop): lanes == SingleSource, host_syncs={plan.host_syncs} "
            f"(lanes alone: {sum(single_syncs.values())}); {fmt(walls)} = "
            f"{statistics.median(walls) / len(BATCH_SOURCES):.1f} ms/source "
            f"(edge SingleSource median "
            f"{statistics.median(single_walls):.1f} ms)")
    lane = 3
    dref, _ = oracle_dist(g, BATCH_SOURCES[lane])
    check(np.array_equal(batch["edge"].dist[lane].cpu().numpy()
                         .astype(np.int64), dref),
          "edge MultiSource lane 3 differs from the scipy oracle")
    log(f"[batch] lane {lane} (source {BATCH_SOURCES[lane]}) == scipy "
        "dijkstra")

    # -- 8c. MultiSource on pallas and fused: lane by lane ----------------
    # the counted run also keeps each kernel's largest input of lane 1
    pair = [0, BATCH_SOURCES[4]]
    lane1 = Largest(backends, frontier_sizes(g.n_nodes, SW_KERNELS),
                    lane=pair[1])
    launches_multi = dict.fromkeys(counters, 0)
    for st in ("pallas", "fused"):
        plan = plans[(st, "argmin")]
        zero()
        with lane1:
            res = plan.solve(MultiSource(pair))
            torch.cuda.synchronize()
        got = read()
        for k, v in got.items():
            launches_multi[k] += v
        same_lanes(torch, res, [single[s] for s in pair], f"{st} MultiSource")
        t = res.telemetry
        b, inner = int(t.buckets.sum()), int(t.inner_iters.sum())
        if st == "pallas":
            check(got["bucket_scan"] == 2 * b + inner
                  and got["ell_relax"] == b + inner,
                  "pallas MultiSource: launches off the lanes' equations")
        else:
            check(got["frontier_relax"] == b + inner
                  and got["bucket_scan"] == b,
                  "fused MultiSource: launches off the lanes' equations")
        check(plan.host_syncs == sum(single_syncs[s] for s in pair),
              f"{st} MultiSource: host syncs != the lanes'")
        _, walls = walls_ms(torch, lambda: plan.solve(MultiSource(pair)), 1)
        log(f"[batch] {st} MultiSource {pair} (lane by lane): lanes == "
            f"SingleSource, host_syncs={plan.host_syncs}, launches "
            f"{json.dumps(got)}; one timed run {walls[0]:.1f} ms = "
            f"{walls[0] / len(pair):.1f} ms/source")
    check(set(lane1.best) == set(SW_KERNELS),
          "MultiSource: no lane-1 input recorded for a kernel")
    log("[batch] lane 1's largest frontiers: " + ", ".join(
        f"{k} {v[2]}" for k, v in lane1.best.items()))

    # -- 8d. ManyToMany against the MultiSource rows ----------------------
    targets = np.random.default_rng(2).choice(g.n_nodes, size=M2M_TARGETS,
                                              replace=False).tolist()
    m2m, walls = walls_ms(torch, lambda: edge.solve(
        ManyToMany(list(M2M_SOURCES), targets, tile=M2M_TILE)), 1)
    rest = edge.solve(MultiSource(list(M2M_SOURCES[M2M_TILE:])))
    rows = torch.cat([batch["edge"].dist, rest.dist])[:, targets]
    check(m2m.matrix.dtype == torch.int64
          and torch.equal(m2m.matrix, rows.cpu().to(torch.int64)),
          "ManyToMany differs from the MultiSource rows")
    tiles = (batch["edge"].telemetry, rest.telemetry)
    check(m2m.telemetry.buckets == max(int(t.buckets.max()) for t in tiles)
          and m2m.telemetry.inner_iters == sum(int(t.inner_iters.sum())
                                              for t in tiles),
          "ManyToMany telemetry")
    log(f"[batch] ManyToMany {len(M2M_SOURCES)} x {M2M_TARGETS} (tile "
        f"{M2M_TILE}, edge) == MultiSource rows; one timed run "
        f"{walls[0]:.1f} ms, buckets={m2m.telemetry.buckets} "
        f"inner_iters={m2m.telemetry.inner_iters}")

    # -- 8e. a capped frontier, with and without the fallback -------------
    # every capped and every fallback solve is counted on its own and held
    # to its launch equations (the fallback's: the capped solve's plus the
    # full-width twin's); the capped solves keep each kernel's largest
    # input (fidx of CAP rows), and each capped answer on the card must
    # equal the same plan's on the CPU
    capped = Largest(backends, frontier_sizes(g.n_nodes, SW_KERNELS))
    launches_fb = dict.fromkeys(counters, 0)      # the capped solves
    launches_twin = dict.fromkeys(counters, 0)    # the twins' re-solves
    for st in ("ell", "pallas", "fused"):
        cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin",
                          frontier_cap=CAP)
        plan = Engine(g, cfg, device=cuda).plan()
        zero()
        with capped:
            raw = plan.solve(SingleSource(0))
            torch.cuda.synchronize()
        got_raw = read()
        rt = raw.telemetry
        check(rt.overflow and not rt.fallback,
              f"{st} cap {CAP}: no overflow reported")
        check(got_raw == delta_launches(st, rt.buckets, rt.inner_iters),
              f"{st} cap {CAP}: launches {got_raw} off the capped solve's "
              "equations")
        t0 = time.perf_counter()
        host = Engine(g, cfg, device="cpu").plan().solve(SingleSource(0))
        cpu_s = time.perf_counter() - t0
        ht = host.telemetry
        check(torch.equal(raw.dist.cpu(), host.dist)
              and torch.equal(raw.pred.cpu(), host.pred)
              and (rt.buckets, rt.inner_iters, rt.overflow)
              == (ht.buckets, ht.inner_iters, ht.overflow),
              f"{st} cap {CAP}: the capped answer on the card differs from "
              "the CPU's")
        plan = Engine(g, cfg, device=cuda).plan(fallback=True)
        full = results[(st, "argmin")][0]
        zero()
        res, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 1)
        got = read()
        want = delta_launches(st, full.telemetry.buckets,
                              full.telemetry.inner_iters)
        check(got == {k: v + want[k] for k, v in got_raw.items()},
              f"{st} cap {CAP}: fallback launches {got} != the capped "
              "solve's + the full-width twin's")
        for k in counters:
            launches_fb[k] += 2 * got_raw[k]
            launches_twin[k] += got[k] - got_raw[k]
        check(res.telemetry.fallback and plan.explain()["fallback_taken"],
              f"{st} cap {CAP}: the fallback did not answer")
        check(torch.equal(res.dist, full.dist)
              and torch.equal(res.pred, full.pred)
              and (res.telemetry.buckets, res.telemetry.inner_iters,
                   res.telemetry.overflow) == (full.telemetry.buckets,
                                               full.telemetry.inner_iters,
                                               False),
              f"{st} cap {CAP}: the fallback answer differs from phase 3's")
        log(f"[batch] {st} frontier_cap={CAP}: overflow reported without "
            f"fallback (buckets={rt.buckets} inner_iters={rt.inner_iters}, "
            f"launches {json.dumps(got_raw)}; == the CPU's capped answer, "
            f"{cpu_s:.1f} s there); with fallback == the uncapped plan, "
            f"telemetry.fallback set, host_syncs={plan.host_syncs} (capped "
            f"+ full), launches {json.dumps(got)}, {walls[0]:.1f} ms")
    check(set(capped.best) == set(SW_KERNELS),
          "capped solves: no input recorded for a kernel")
    log("[batch] capped solves' largest frontiers: " + ", ".join(
        f"{k} {v[2]}" for k, v in capped.best.items()))

    # -- 8f. frontier policies on edge and pallas -------------------------
    base = results[("edge", "argmin")][0]
    policy_rec = Largest(backends, frontier_sizes(g.n_nodes, ("ell_relax",)))
    launches_policy = dict.fromkeys(counters, 0)
    rho_edge = None
    for policy, extra in (("rho", {}), ("radius", dict(radius_k=RADIUS_K))):
        for st in ("edge", "pallas"):
            cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin",
                              policy=policy, **extra)
            plan = Engine(g, cfg, device=cuda).plan()
            zero()
            with policy_rec:
                res = plan.solve(SingleSource(0))
                torch.cuda.synchronize()
            got = read()
            t = res.telemetry
            check(torch.equal(res.dist, base.dist)
                  and torch.equal(res.pred, base.pred),
                  f"{st}/{policy}: dist/pred differ from the delta answer")
            check(got["bucket_scan"] == 0 and got["ell_relax"] == (
                2 * t.inner_iters if st == "pallas" else 0),
                f"{st}/{policy}: ell_relax launches != 2 * steps")
            if st == "pallas":
                for k, v in got.items():
                    launches_policy[k] += v
            syncs = plan.host_syncs
            _, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 3)
            log(f"[policy] {st}/{policy}"
                f"{'' if policy == 'rho' else f' k={RADIUS_K}'}: dist/pred "
                f"== delta, rounds={t.buckets} steps={t.inner_iters} "
                f"overflow={t.overflow} host_syncs={syncs} launches "
                f"{json.dumps(got)}; {fmt(walls)} after the checked run")
            if (policy, st) == ("rho", "edge"):
                rho_edge = plan
    check("ell_relax" in policy_rec.best, "no ell_relax input recorded on "
          "the policy path")
    dist = base.dist.cpu().numpy()
    far = int(np.argmax(dist))
    p2p = rho_edge.solve(PointToPoint(0, far))
    check(p2p.distance == int(dist[far]), "rho PointToPoint distance")
    check_path(p2p.path, 0, far, p2p.distance, keyed, g.n_nodes)
    radius = int(dist.max()) // 2
    bnd = rho_edge.solve(BoundedRadius(0, radius))
    within = base.dist <= radius
    check(torch.equal(bnd.dist, torch.where(within, base.dist, INF))
          and torch.equal(bnd.pred, torch.where(within, base.pred, -1)),
          "rho BoundedRadius differs from the filtered delta answer")
    log(f"[policy] edge/rho PointToPoint 0->{far}: distance {p2p.distance} "
        f"== delta, path valid, rounds={p2p.telemetry.buckets}; "
        f"BoundedRadius({radius}) == delta filtered "
        f"({int(within.sum())} vertices), rounds={bnd.telemetry.buckets}")
    log(f"[batch] phase 8 (small-world) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches_multi, launches_policy, launches_fb, launches_twin, {
        "smallworld_multisource": lane1.best,
        "smallworld_policy": policy_rec.best,
        "smallworld_fallback": capped.best}


def dyn_batches(rng, n_edges: int, w0, k: int, n_sets: int):
    """The update protocol of ``benchmarks/bench_dynamic.py:_batches``:
    ``n_sets`` seeded id sets of ``k`` edges, each with two distinct
    absolute weight assignments (``clip(w0 + U[-5, 5], 1, 20)``, then an
    elementwise-different one), cycled A1..An, B1..Bn, so re-applying
    the cycle always changes weights."""
    import numpy as np
    sets = []
    for _ in range(n_sets):
        ids = rng.choice(n_edges, size=k, replace=False)
        wa = np.clip(w0[ids] + rng.integers(-5, 6, size=k), 1, 20)
        wb = np.where(wa < 20, wa + 1, wa - 1)
        sets.append((ids, wa, wb))
    return ([(ids, wa) for ids, wa, _ in sets]
            + [(ids, wb) for ids, _, wb in sets])


class Split:
    """While active, times the parts of a plan's ``UpdateBatch`` solves:
    ``update`` (the weight swap and backend rebuild), the host repair
    planning (``plan_repair``, the device-to-host copies of its inputs
    included), the choice (or build) of the warm backend, and each warm
    run of the solve loop, whose ``(kind, cap, buckets, inner_iters,
    overflow)`` it also keeps (``kind``: the backend's launch
    equations). Each part ends in a synchronize."""

    KIND = {"PallasEllBackend": "pallas", "FusedBackend": "fused"}

    def __init__(self, torch, plan, engine_mod):
        self.torch, self.plan, self.engine = torch, plan, engine_mod
        self.ms = {"update": 0.0, "planning": 0.0, "twin": 0.0,
                   "loop": 0.0}
        self.runs = []

    def _timed(self, part, fn):
        return synced(self.torch, self.ms, part, fn)

    def _wrap_warm(self):
        real = self.plan._run_warm
        timed = self._timed("loop", real)

        def warm(backend, tent0, explored0):
            out = timed(backend, tent0, explored0)
            self.runs.append((self.KIND.get(type(backend).__name__, "ell"),
                              getattr(backend, "cap", None), out.outer_iters,
                              out.inner_iters, out.overflow))
            return out
        warm.split = self
        self.plan._run_warm = warm

    def __enter__(self):
        plan = self.plan
        real_update = plan.update
        timed_update = self._timed("update", real_update)

        def update(*args, **kw):
            out = timed_update(*args, **kw)
            if getattr(plan._run_warm, "split", None) is not self:
                self._wrap_warm()       # a radius plan rebinds its drivers
            return out
        plan.update = update
        plan._warm_backend = self._timed("twin", plan._warm_backend)
        self._wrap_warm()
        self.real_pr = self.engine.plan_repair
        self.engine.plan_repair = self._timed("planning", self.real_pr)
        return self

    def __exit__(self, *exc):
        del self.plan.update, self.plan._warm_backend
        self.plan._bind_drivers()
        self.engine.plan_repair = self.real_pr

    def check_parts(self, tag: str) -> None:
        """Every part was timed: a part left at 0 ms means the engine no
        longer calls the name it is timed through."""
        check(all(v > 0 for v in self.ms.values()) and self.runs,
              f"{tag}: a part of the split was not timed ({self.ms})")

    def launches(self) -> dict:
        """The warm runs' launches by their own counters' equations (a
        policy loop: two ``ell_relax`` launches per step on ``pallas``,
        no bucket scan)."""
        want = dict.fromkeys(("bucket_scan", "ell_relax", "frontier_relax",
                              "grid_relax"), 0)
        policy = self.plan.config.policy != "delta"
        for kind, _, b, inner, _ in self.runs:
            got = (dict(want, ell_relax=2 * inner if kind == "pallas" else 0)
                   if policy else delta_launches(kind, b, inner))
            for k, v in got.items():
                want[k] += v
        return want


def dynamic_path(torch, np, cuda, g, plans, counters):
    """Phase 9: warm re-solves at full width (see the module note).
    Returns the launches of the small-world and the lattice warm paths
    and, per path, each kernel's recorded input with the largest
    frontier."""
    import repro_torch.api.engine as engine_mod
    import repro_torch.core.backends as backends
    from repro_torch.api import Engine, SingleSource, UpdateBatch
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import square_lattice

    t_phase = time.perf_counter()
    n, n_edges = g.n_nodes, g.n_edges

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    def same_answer(a, b):
        return torch.equal(a.dist, b.dist) and torch.equal(a.pred, b.pred)

    def counted(plan, q, rec, total):
        """One counted run of ``q`` on ``plan``: launches (added to
        ``total``) held to the warm runs' equations, inputs kept by
        ``rec`` (its sizing adds one host sync per kernel call), and the
        run's split. Not timed: ``timed_bumps`` gives the times."""
        zero()
        with rec, Split(torch, plan, engine_mod) as split:
            res = plan.solve(q)
            torch.cuda.synchronize()
        got = read()
        split.check_parts("counted run")
        check(got == split.launches(), f"launches {got} off the warm runs' "
              f"equations {split.launches()} ({split.runs})")
        for k, v in got.items():
            total[k] += v
        return res, got, split

    def timed_bumps(plan, batches):
        """One ``UpdateBatch`` solve per batch, each timed whole and
        split: update, planning, warm backend, device loop, the rest;
        host syncs."""
        rows = []
        for ids, w in batches:
            with Split(torch, plan, engine_mod) as split:
                res, walls = walls_ms(
                    torch, lambda: plan.solve(UpdateBatch(ids, w)), 1)
            check(res.telemetry.warm and res.telemetry.repaired > 0,
                  "a timed batch did not repair warm")
            split.check_parts("timed batch")
            rows.append((walls[0], split.ms, plan.host_syncs))
        return rows

    def split_line(rows) -> str:
        walls = [r[0] for r in rows]
        parts = {k: statistics.median(r[1][k] for r in rows)
                 for k in ("update", "planning", "twin", "loop")}
        rest = statistics.median(r[0] - sum(r[1].values()) for r in rows)
        return (f"update + warm resolve {fmt(walls)}: update "
                f"{parts['update']:.1f}, host repair planning "
                f"{parts['planning']:.1f} (share "
                f"{parts['planning'] / statistics.median(walls):.3f}), warm "
                f"backend {parts['twin']:.1f}, device loop "
                f"{parts['loop']:.1f}, rest {rest:.1f} ms (medians); host "
                f"syncs {[r[2] for r in rows]}")

    w0 = g.w.cpu().numpy()
    rng = np.random.default_rng(DYN_SEED)
    cycles = {k: dyn_batches(rng, n_edges, w0, k, DYN_SETS) for k in DYN_KS}
    launches_sw = dict.fromkeys(counters, 0)
    sw_rec = Largest(backends, frontier_sizes(n, SW_KERNELS))
    keys = (("edge", "argmin"), ("ell", "argmin"), ("pallas", "argmin"),
            ("fused", "argmin"), ("fused", "packed"))
    for key in keys:        # phase 6 solved SingleSource(0) on each plan
        check(plans[key].explain()["resident_source"] == 0,
              f"{key}: no resident SingleSource(0)")

    # -- 9a/9b. the strategies at 0.1 % and 1 % of |E| ------------------
    for k in DYN_KS:
        seq = cycles[k]
        first = k == DYN_KS[0]
        # the first k: two warm-up batches, the counted one, then three
        # timed; the second k: the counted one, then three timed
        warmups, counted_b = (seq[:2], seq[2]) if first else ([], seq[0])
        timed_b = [seq[3], seq[0], seq[1]] if first else seq[1:4]
        agreed = oracle = None
        for key in keys:
            st, pm = key
            plan = plans[key]
            for ids, w in warmups:
                plan.solve(UpdateBatch(ids, w))
            res, got, split = counted(plan, UpdateBatch(*counted_b),
                                      sw_rec, launches_sw)
            t = res.telemetry
            check(t.warm and t.repaired > 0 and not t.fallback,
                  f"{st}/{pm} k={k}: no warm repair")
            if oracle is None:
                t0 = time.perf_counter()
                oracle, ok_keyed = oracle_dist(plan.graph)
                check(np.array_equal(res.dist.cpu().numpy().astype(np.int64),
                                     oracle), f"k={k}: warm dist differs "
                      "from the scipy oracle")
                check_tree(res.dist.cpu().numpy(), res.pred.cpu().numpy(), 0,
                           ok_keyed)
                log(f"[dyn] k={k}: {st}/{pm} warm dist == scipy dijkstra on "
                    f"the updated graph, pred tree ok (oracle "
                    f"{time.perf_counter() - t0:.1f} s)")
                agreed = res
            check(same_answer(res, agreed),
                  f"{st}/{pm} k={k}: warm answer differs from edge's")
            if st == "edge":
                # a fresh Engine of the ELL strategies is a host ELL build
                # (~3 s at 1 M); they are held to edge's warm answer and to
                # their own cold solve of the updated graph
                fresh, walls = walls_ms(torch, lambda: Engine(
                    plan.graph, DeltaConfig(delta=DELTA, strategy=st,
                                            pred_mode=pm),
                    device=cuda).plan().solve(SingleSource(0)), 1)
                check(same_answer(res, fresh),
                      f"{st}/{pm} k={k}: warm != a fresh Engine's cold solve")
                fresh_note = f"== a fresh Engine ({walls[0]:.0f} ms)"
            elif first or st in DYN_TIMED_1PCT:
                fresh_note = "(held to resolve(warm=False) below)"
            else:
                cold, walls = walls_ms(
                    torch, lambda: plan.resolve(warm=False), 1)
                check(same_answer(res, cold) and not cold.telemetry.warm,
                      f"{st}/{pm} k={k}: warm != resolve(warm=False)")
                fresh_note = f"== resolve(warm=False) ({walls[0]:.0f} ms)"
            log(f"[dyn] {st}/{pm} k={k}: warm {fresh_note}, == edge's; "
                f"buckets={t.buckets} inner_iters={t.inner_iters} "
                f"repaired={t.repaired} cone={t.cone} "
                f"host_syncs={plan.host_syncs} runs {split.runs} launches "
                f"{json.dumps(got)}; counted run: update "
                f"{split.ms['update']:.1f}, planning "
                f"{split.ms['planning']:.1f}, warm backend "
                f"{split.ms['twin']:.1f}, loop {split.ms['loop']:.1f} ms")
            if first or st in DYN_TIMED_1PCT:
                # timed: three cold re-solves (the first held to the warm
                # answer), then three batches after the counted one
                cold, walls = walls_ms(
                    torch, lambda: plan.resolve(warm=False), 3)
                check(same_answer(cold, res) and not cold.telemetry.warm,
                      f"{st}/{pm} k={k}: resolve(warm=False) differs")
                log(f"[time] dyn {st}/{pm} k={k}: "
                    + split_line(timed_bumps(plan, timed_b))
                    + f"; resolve(warm=False) {fmt(walls)}, buckets="
                    f"{cold.telemetry.buckets} host_syncs={plan.host_syncs}")
    check(all(launches_sw[x] > 0 for x in SW_KERNELS),
          f"the small-world warm path missed a kernel: {launches_sw}")

    # -- 9c. frontier policies, warm --------------------------------------
    for policy, extra in (("rho", {}), ("radius", dict(radius_k=RADIUS_K))):
        for st in ("edge", "pallas"):
            cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin",
                              policy=policy, **extra)
            plan = Engine(g, cfg, device=cuda).plan()
            plan.solve(SingleSource(0))
            res, got, split = counted(
                plan, UpdateBatch(*cycles[DYN_KS[0]][0]), sw_rec, launches_sw)
            t = res.telemetry
            check(t.warm and t.repaired > 0, f"{st}/{policy}: no warm repair")
            cold, walls = walls_ms(torch, lambda: plan.resolve(warm=False), 1)
            check(same_answer(res, cold),
                  f"{st}/{policy}: warm != the cold solve of the updated graph")
            log(f"[dyn] {st}/{policy} k={DYN_KS[0]}: warm == cold (rounds="
                f"{t.buckets} steps={t.inner_iters} repaired={t.repaired} "
                f"cone={t.cone}; cold rounds={cold.telemetry.buckets}), "
                f"launches {json.dumps(got)}; counted run: update "
                f"{split.ms['update']:.1f}, planning "
                f"{split.ms['planning']:.1f}, loop {split.ms['loop']:.1f} ms;"
                f" cold {walls[0]:.1f} ms")
            del plan

    # -- 9d. long diameter: one far edge flipped on the lattice -----------
    t0 = time.perf_counter()
    lat = square_lattice(LATTICE_SIDE, weighted=True)
    t_gen = time.perf_counter() - t0
    launches_lat = dict.fromkeys(counters, 0)
    lat_rec = Largest(backends, frontier_sizes(lat.n_nodes, SW_KERNELS))
    edge_id = cold_up = None
    for st in LATTICE_STRATEGIES:
        cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin")
        plan = Engine(lat, cfg, device=cuda).plan()
        base, walls = walls_ms(torch, lambda: plan.solve(SingleSource(0)), 1)
        b_cold = base.telemetry.buckets
        if edge_id is None:
            # the tree edge into the vertex farthest from the source
            dist = base.dist.cpu().numpy()
            v = int(np.argmax(np.where(dist < INF, dist, -1)))
            p = int(base.pred[v])
            src, dst = lat.src.numpy(), lat.dst.numpy()
            edge_id = int(np.flatnonzero((src == p) & (dst == v))[0])
            w_e = int(lat.w[edge_id])
            log(f"[dyn] lattice {LATTICE_SIDE}x{LATTICE_SIDE}: n={lat.n_nodes}"
                f" |E|={lat.n_edges}; far vertex {v} at distance "
                f"{int(dist[v])}, its tree edge {edge_id} ({p}->{v}, w={w_e}),"
                f" generated in {t_gen:.1f} s, cold solve {walls[0]:.0f} ms")
        up, got_up, split_up = counted(
            plan, UpdateBatch([edge_id], [w_e + 7]), lat_rec, launches_lat)
        if cold_up is None:
            cold_up = plan.resolve(warm=False)
        check(same_answer(up, cold_up), f"lattice {st}: warm != cold after "
              "the increase")
        back, got_back, split_back = counted(
            plan, UpdateBatch([edge_id], [w_e]), lat_rec, launches_lat)
        check(same_answer(back, base), f"lattice {st}: warm != the cold "
              "solve after the edge is restored")
        for r in (up, back):
            check(r.telemetry.warm and r.telemetry.repaired > 0
                  and 2 * r.telemetry.buckets < b_cold,
                  f"lattice {st}: not far fewer buckets warm than cold")
        rows = timed_bumps(plan, [([edge_id], [w_e + 7]), ([edge_id], [w_e]),
                                  ([edge_id], [w_e + 7])])
        log(f"[dyn] lattice {st}: warm == cold; buckets warm "
            f"{up.telemetry.buckets} / {back.telemetry.buckets} against cold "
            f"{b_cold} (inner_iters {up.telemetry.inner_iters} / "
            f"{back.telemetry.inner_iters} against "
            f"{base.telemetry.inner_iters}), repaired "
            f"{up.telemetry.repaired} / {back.telemetry.repaired}, runs "
            f"{split_up.runs} / {split_back.runs}, launches "
            f"{json.dumps(got_up)} / {json.dumps(got_back)}")
        log(f"[time] dyn lattice {st}: {split_line(rows)}; cold "
            f"SingleSource {walls[0]:.1f} ms")
        del plan
    check(all(launches_lat[x] > 0 for x in SW_KERNELS),
          f"the lattice warm path missed a kernel: {launches_lat}")

    # -- 9e. where a warm solve's device time goes ------------------------
    plan = plans[("pallas", "argmin")]
    # B2, then A2, of the first k: both change weights the plan holds
    flip = iter([cycles[DYN_KS[0]][3], cycles[DYN_KS[0]][1]])
    kern, wall, seen, _ = profiled(torch, lambda: plan.solve(
        UpdateBatch(*next(flip))), counters=counters)
    busy = sum(kern.values())
    log(f"[profile] warm pallas k={DYN_KS[0]}: profiled solve {wall:.1f} ms "
        f"(update included), device busy {busy:.1f} ms (idle share "
        f"{1 - busy / wall:.3f}), {len(kern)} kernel names; kernel records "
        f"{seen_line(seen)}")
    for kname, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:9.3f} ms  {kname[:110]}")
    log(f"[dyn] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches_sw, launches_lat, {"smallworld_warm": sw_rec.best,
                                       "lattice_warm": lat_rec.best}


class Timed:
    """While active, replaces ``obj.name`` for each ``(obj, name)`` in
    ``targets`` by a wrapper that adds its wall time, ended by a
    synchronize, to ``ms[name]``."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.ms = {name: 0.0 for _, name in targets}

    def __enter__(self):
        self.real = [(obj, name, getattr(obj, name))
                     for obj, name in self.targets]
        for obj, name, fn in self.real:
            setattr(obj, name, synced(self.torch, self.ms, name, fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.real:
            setattr(obj, name, fn)


def landmark_path(torch, np, cuda, g, ref_dist, keyed, counters):
    """Phase 10: landmark point-to-point queries at full width (see the
    module note). The launch counters are set to 0 after the game map's
    reference solve and read at the end: every landmark solve runs on an
    all-light ``EllBackend`` and the ``edge`` plan's early exit on
    tensor ops, so all four must read 0."""
    import tempfile

    import repro_torch.landmarks.alt as alt_mod
    import repro_torch.tune.estimator as estimator
    from repro_torch.api import (Engine, LandmarkRefused, PointToPoint,
                                 SingleSource)
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import grid_map

    t_phase = time.perf_counter()
    n = g.n_nodes
    fin = ref_dist < INF
    far = int(np.flatnonzero(ref_dist == ref_dist[fin].max())[0])
    median = np.sort(ref_dist[fin])[(int(fin.sum()) - 1) // 2]
    near = int(np.flatnonzero(ref_dist == median)[0])
    targets = {"far": far, "near": near}

    # the game map's reference answer launches the grid kernels: it is
    # solved before the counters are set to 0
    gs, fs = grid_map(SMALL_SIDE, SMALL_SIDE, OBSTACLES, seed=0)
    cells = np.flatnonzero(fs.ravel())
    gsrc, gtgt = int(cells[0]), int(cells[-1])
    gplan = Engine(gs, DeltaConfig(delta=GRID_DELTA, strategy="pallas",
                                   pred_mode="argmin"), free_mask=fs,
                   device=cuda).plan()
    gdist = gplan.solve(SingleSource(gsrc)).dist.cpu().numpy()
    gkeyed = dedup_min(gs.src.cpu().numpy(), gs.dst.cpu().numpy(),
                       gs.w.cpu().numpy(), gs.n_nodes)

    for fn in counters.values():
        fn.launches = 0
    cfg = DeltaConfig(delta=DELTA, strategy="edge", pred_mode="argmin")
    plan = Engine(g, cfg, device=cuda).plan()
    store = tempfile.TemporaryDirectory()

    # -- 10a. tables: prepare_landmarks, split; one landmark's rows --------
    split = Timed(torch, [(estimator, "graph_stats"),
                          (estimator, "fingerprint"),
                          (alt_mod, "graph_whash"),
                          (alt_mod, "build_tables")])
    with split:
        t0 = time.perf_counter()
        plan.prepare_landmarks(k=LANDMARK_K, store=store.name)
        torch.cuda.synchronize()
        t_prep = (time.perf_counter() - t0) * 1e3
    tables = plan.landmark_tables
    ms = split.ms
    check(all(v > 0 for v in ms.values()), f"a part of prepare_landmarks "
          f"was not timed ({ms})")
    log(f"[landmarks] prepare_landmarks(k={LANDMARK_K}, farthest, seed 0) "
        f"on edge: {t_prep:.1f} ms: graph_stats {ms['graph_stats']:.1f} + "
        f"fingerprint {ms['fingerprint']:.1f}, whash "
        f"{ms['graph_whash']:.1f}, selection + rows "
        f"{ms['build_tables']:.1f} ms (the rows' whash inside it once "
        f"more); landmarks {tables.landmarks.tolist()}, fingerprint "
        f"{tables.fingerprint}")
    lm = int(tables.landmarks[0])
    d_out, _ = oracle_dist(g, lm)
    d_in, _ = oracle_dist(g.reversed(), lm)
    check(np.array_equal(tables.d_out[0].astype(np.int64), d_out),
          f"landmark {lm}: d_out differs from scipy")
    check(np.array_equal(tables.d_in[0].astype(np.int64), d_in),
          f"landmark {lm}: d_in differs from scipy on the reversed edges")
    log(f"[landmarks] landmark {lm}: d_out == scipy, d_in == scipy on the "
        f"reversed edge list")
    t0 = time.perf_counter()
    plan._landmarks._ells(plan.graph)
    torch.cuda.synchronize()
    log(f"[landmarks] all-light ELL blocks (union {2 * n} x "
        f"{plan._landmarks._union_ell.max_deg}, forward {n} x "
        f"{plan._landmarks._fwd_ell.max_deg}) built on the host in "
        f"{time.perf_counter() - t0:.1f} s, once per weight version")

    # -- 10b. queries: every mode to the far and the median target ---------
    walls = {}
    for mode in LM_MODES:
        for name, t in targets.items():
            q = PointToPoint(0, t, mode=mode)
            if name == "far":
                plan.solve(q)                   # warm-up
            r, w = walls_ms(torch, lambda: plan.solve(q),
                            3 if name == "far" else 1)
            tel = r.telemetry
            check(r.distance == int(ref_dist[t]),
                  f"{mode} 0->{t}: distance {r.distance} != scipy")
            check_path(r.path, 0, t, r.distance, keyed, n)
            check(plan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1,
                  f"{mode} 0->{t}: host syncs off the formula")
            check(not tel.overflow, f"{mode}: overflow")
            walls[(mode, name)] = statistics.median(w)
            log(f"[landmarks] {mode} 0->{t} ({name}, dist {r.distance}): "
                f"path of {len(r.path) - 1} valid steps, buckets="
                f"{tel.buckets} inner_iters={tel.inner_iters} host_syncs="
                f"{plan.host_syncs}, {fmt(w)}")

    # -- 10c. one profiled alt query: the scatter's share -----------------
    kern, wall, _, counts = profiled(torch, lambda: plan.solve(
        PointToPoint(0, far, mode="alt")))
    r = plan.solve(PointToPoint(0, far, mode="alt"))
    busy = sum(kern.values())
    scat = [k for k in kern if "scatter" in k]
    got = sum(counts[k] for k in scat)
    # per sweep (light or heavy) one compaction scatter and one
    # scatter-min, and one scatter-min in pred recovery
    want = 2 * (r.telemetry.buckets + r.telemetry.inner_iters) + 1
    if got == want:
        scat_ms = sum(kern[k] for k in scat)
        log(f"[profile] landmarks alt 0->{far}: profiled query {wall:.1f} "
            f"ms, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}); scatter {scat_ms:.1f} ms (share of "
            f"busy {scat_ms / busy:.3f}) over {got} records, every record "
            f"kept")
        for k, ms_ in sorted(kern.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[profile]   {ms_:9.3f} ms  x{counts[k]}  {k[:100]}")
    else:
        log(f"[profile] landmarks alt 0->{far}: the profiler kept {got} "
            f"scatter records of {want}: records lost, no share and no "
            f"breakdown")

    # -- 10d. the store: a second plan hits it -----------------------------
    second = Engine(g, cfg, device=cuda).plan()
    t0 = time.perf_counter()
    second.prepare_landmarks(k=LANDMARK_K, store=store.name)
    t_hit = (time.perf_counter() - t0) * 1e3
    hit = second.landmark_tables
    check(hit is not tables and all(
        np.array_equal(getattr(hit, f), getattr(tables, f))
        for f in ("landmarks", "d_out", "d_in")) and
        (hit.fingerprint, hit.whash) == (tables.fingerprint, tables.whash),
        "the store's tables differ from the built ones")
    log(f"[landmarks] store hit on a second plan in {t_hit:.1f} ms (the "
        f"fingerprint's graph_stats included), tables bitwise equal")
    del second

    # -- 10e. updates: kept, stale and rebuilt, refused --------------------
    w0 = g.w.cpu().numpy()
    batches = dyn_batches(np.random.default_rng(DYN_SEED), g.n_edges, w0,
                          LM_DYN_K, DYN_SETS)
    (ids1, wa1), (ids2, wa2) = batches[0], batches[1]
    inc = np.maximum(wa1, w0[ids1])
    check((inc > w0[ids1]).any(), "the increase-only batch changes nothing")
    plan.update(ids1, inc)
    check(plan.landmark_tables is tables,
          "an increase-only batch dropped the tables")
    r = plan.solve(PointToPoint(0, far, mode="alt"))
    upd, ukeyed = oracle_dist(plan.graph, 0)
    check(r.distance == int(upd[far]), "alt after an increase-only batch "
          "differs from scipy on the updated weights")
    check_path(r.path, 0, far, r.distance, ukeyed, n)
    log(f"[landmarks] increase-only batch (k={LM_DYN_K}): tables kept, alt "
        f"0->{far} dist {r.distance} == scipy on the updated weights")
    plan.update(ids1, wa1)
    check(plan.landmark_tables is None, "a decreasing batch kept the tables")
    t0 = time.perf_counter()
    r = plan.solve(PointToPoint(0, far, mode="alt"))
    t_rebuild = (time.perf_counter() - t0) * 1e3
    ee = plan.solve(PointToPoint(0, far))
    check(plan.landmark_tables is not None and
          plan.landmark_tables is not tables, "alt did not rebuild the tables")
    check(r.distance == ee.distance, "alt after the rebuild differs from "
          "early_exit on the same plan")
    log(f"[landmarks] decreasing batch under recompute: tables dropped; alt "
        f"rebuilt them and answered in {t_rebuild:.1f} ms, dist "
        f"{r.distance} == early_exit")
    plan.prepare_landmarks(k=LANDMARK_K, store=store.name, on_update="refuse")
    check(plan._landmarks.would_invalidate(ids2, wa2),
          "the refused batch lowers no weight")
    w_before = plan.graph.w.clone()
    try:
        plan.update(ids2, wa2)
        check(False, "the refuse policy applied a decreasing batch")
    except LandmarkRefused as e:
        check(e.reason == "landmarks_stale", f"refusal reason {e.reason}")
    check(torch.equal(plan.graph.w, w_before),
          "a refused batch changed the weights")
    log("[landmarks] on_update='refuse': the decreasing batch raised "
        "LandmarkRefused(reason='landmarks_stale'), weights bitwise "
        "unchanged")
    store.cleanup()

    # -- 10f. the game map: every landmark mode on the grid plan -----------
    for mode in LM_MODES[1:]:
        r, w = walls_ms(torch, lambda: gplan.solve(
            PointToPoint(gsrc, gtgt, mode=mode)), 1)
        tel = r.telemetry
        check(r.distance == int(gdist[gtgt]), f"gamemap {mode}: distance "
              "differs from the grid plan's SingleSource")
        check_path(r.path, gsrc, gtgt, r.distance, gkeyed, gs.n_nodes)
        check(gplan.host_syncs == 2 * tel.buckets + tel.inner_iters + 1,
              f"gamemap {mode}: host syncs off the formula")
        log(f"[landmarks] gamemap {SMALL_SIDE}x{SMALL_SIDE} {mode} "
            f"{gsrc}->{gtgt}: dist {r.distance} == SingleSource, path of "
            f"{len(r.path) - 1} valid steps, buckets={tel.buckets} "
            f"inner_iters={tel.inner_iters}, {fmt(w)}"
            + (" (builds the tables)" if mode == LM_MODES[1] else ""))

    launches = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches.values()),
          f"the landmark solves launched a kernel: {launches}")
    log(f"[landmarks] launches over phase 10: {json.dumps(launches)}")
    log(f"[landmarks] far-target medians (ms): " + ", ".join(
        f"{m} {walls[(m, 'far')]:.1f}" for m in LM_MODES))
    log(f"[landmarks] phase 10 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch.core.backends as backends
    from repro_torch.api import Engine, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import (coo_to_csr, csr_to_ell, random_graph,
                                    rmat, watts_strogatz)
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_scan import bucket_scan_cuda, \
        bucket_scan_ref
    from repro_torch.kernels.ell_relax import ell_relax_cuda, ell_relax_ref
    from repro_torch.kernels.frontier_relax import (frontier_relax,
                                                    frontier_relax_cuda,
                                                    frontier_relax_ref)
    from repro_torch.kernels.grid_relax import grid_relax_cuda, grid_relax_ref

    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build = _build.load()
    log(f"[build] {build.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.seconds:.2f} s)")
    for line in build.log.splitlines():
        if "registers" in line or line.startswith("---"):
            log("[build] " + line.strip())

    # -- graph --------------------------------------------------------------
    t0 = time.perf_counter()
    g = watts_strogatz(N_NODES, DEGREE, P_REWIRE, seed=0)
    log(f"[graph] watts_strogatz n={g.n_nodes} |E|={g.n_edges} "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_dist, keyed = oracle_dist(g)
    log(f"[oracle] scipy dijkstra on {keyed[0].shape[0]} deduplicated edges "
        f"in {time.perf_counter() - t0:.1f} s")

    plans = {}
    for strategy, pred_mode in (("fused", "argmin"), ("pallas", "argmin"),
                                ("ell", "argmin"), ("edge", "argmin"),
                                ("fused", "packed")):
        t0 = time.perf_counter()
        cfg = DeltaConfig(delta=DELTA, strategy=strategy, pred_mode=pred_mode)
        plans[(strategy, pred_mode)] = Engine(g, cfg, device=cuda).plan()
        log(f"[plan] {strategy}/{pred_mode} built in "
            f"{time.perf_counter() - t0:.1f} s")

    # -- 2a. record mid-solve kernel inputs (also the warm-up solves) -------
    rec = {"bucket_scan": [], "ell_relax": [], "frontier_relax": []}
    real = {name: getattr(backends, name) for name in rec}

    def recorder(name, size_of):
        def wrapped(*args, **kw):
            out = real[name](*args, **kw)
            stored = tuple(a.clone() if isinstance(a, torch.Tensor) and
                           a.shape[0] == N_NODES else a for a in args)
            rec[name].append((stored, kw, size_of(args, out)))
            return out
        return wrapped

    setattr(backends, "frontier_relax", recorder(
        "frontier_relax", lambda a, o: int(o[3])))
    setattr(backends, "bucket_scan", recorder(
        "bucket_scan", lambda a, o: int(o[0].sum())))
    setattr(backends, "ell_relax", recorder(
        "ell_relax", lambda a, o: int((a[0] < N_NODES).sum())))
    try:
        plans[("fused", "argmin")].solve(SingleSource(0))
        plans[("pallas", "argmin")].solve(SingleSource(0))
    finally:
        for name, fn in real.items():
            setattr(backends, name, fn)
    torch.cuda.synchronize()

    def picks(records):
        big = max(range(len(records)), key=lambda k: records[k][2])
        return big, sorted({0, len(records) // 2, big})

    # -- 2b. kernels against twins on the card -----------------------------
    def run_bs(args, kw, fn):
        t, e, i = args
        return fn(t, e, i, delta=kw["delta"])

    def run_er(args, kw, fn):
        return (fn(*args),)

    def run_fr(args, kw, fn, **over):
        return fn(*args, **(kw | over))

    runners = {"bucket_scan": (run_bs, bucket_scan_cuda, bucket_scan_ref),
               "ell_relax": (run_er, ell_relax_cuda, ell_relax_ref),
               "frontier_relax": (run_fr, frontier_relax_cuda,
                                  frontier_relax_ref)}
    main_case = {}
    for name, records in rec.items():
        check(len(records) > 0, f"no {name} call recorded")
        big, chosen = picks(records)
        main_case[name] = records[big]
        run, kern, twin = runners[name]
        for k in chosen:
            args, kw, size = records[k]
            same(torch, run(args, kw, kern), run(args, kw, twin))
            torch.cuda.synchronize()
        log(f"[kernel] {name}: {len(chosen)} mid-solve states of "
            f"{len(records)} equal to the twin (largest frontier {size})")

    # edge cases
    rng = np.random.default_rng(0)

    def rand_tent(n, hi):
        t = rng.integers(0, hi, size=n).astype(np.int32)
        t[rng.random(n) < 0.3] = INF
        return torch.from_numpy(t).to(cuda)

    ragged = 1_000_003                           # not a multiple of 1024
    tr, er = rand_tent(ragged, 400), rand_tent(ragged, 400)
    allinf = torch.full((ragged,), INF, dtype=torch.int32, device=cuda)
    for a, b, i in ((tr, er, 3), (allinf, allinf, 0)):
        same(torch, bucket_scan_cuda(a, b, i, delta=DELTA),
             bucket_scan_ref(a, b, i, delta=DELTA))
        torch.cuda.synchronize()
    (fidx, dist, w_ell), _, _ = main_case["ell_relax"]
    sentinel = torch.full_like(fidx, N_NODES)
    same(torch, (ell_relax_cuda(sentinel, dist, w_ell),),
         (ell_relax_ref(sentinel, dist, w_ell),))
    torch.cuda.synchronize()
    (d, e, i, nbr, w), kw, pop = main_case["frontier_relax"]
    capped = dict(cap=max(1, pop // 3))
    out = run_fr((d, e, i, nbr, w), kw, frontier_relax_cuda, **capped)
    check(int(out[3]) == pop and pop > capped["cap"], "overflow count")
    same(torch, out, run_fr((d, e, i, nbr, w), kw, frontier_relax_ref,
                            **capped))
    torch.cuda.synchronize()
    same(torch, run_fr((allinf[:N_NODES], allinf[:N_NODES], 0, nbr, w), kw,
                       frontier_relax_cuda),
         run_fr((allinf[:N_NODES], allinf[:N_NODES], 0, nbr, w), kw,
                frontier_relax_ref))
    torch.cuda.synchronize()
    rg = csr_to_ell(coo_to_csr(random_graph(ragged, 4 * ragged, seed=1)))
    rg = rg.to(cuda)
    for cap in (ragged, 5000):
        kw_r = dict(delta=DELTA, cap=cap)
        same(torch, frontier_relax_cuda(tr, er, 3, rg.nbr, rg.w, **kw_r),
             frontier_relax_ref(tr, er, 3, rg.nbr, rg.w, **kw_r))
        torch.cuda.synchronize()
    nbr0 = torch.full((ragged + 1, 0), ragged, dtype=torch.int32, device=cuda)
    w0 = torch.full((ragged + 1, 0), INF, dtype=torch.int32, device=cuda)
    kw0 = dict(delta=DELTA, cap=4096)
    twin0 = frontier_relax_ref(tr, er, 3, nbr0, w0, **kw0)
    same(torch, frontier_relax_cuda(tr, er, 3, nbr0, w0, **kw0), twin0)
    same(torch, frontier_relax(tr, er, 3, nbr0, w0, **kw0), twin0)
    torch.cuda.synchronize()
    # the range form of bucket_scan: int32 tent over the whole range,
    # negative buckets and buckets whose range passes int32, a view 4
    # bytes past 16-byte alignment (scalar path), n = 0; ell_relax on a
    # w_ell view 4 bytes past 16-byte alignment (scalar walk)
    full = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=ragged + 1, dtype=np.int64).astype(np.int32)
    ).to(cuda)
    full[::7] = INF
    for delta in (1, 7, 2**30):
        for i in (-3, 0, INF // delta, -(2**31) // delta):
            for a, b in ((full[:-1], er), (full[1:], tr), (tr, full[1:])):
                same(torch, bucket_scan_cuda(a, b, i, delta=delta),
                     bucket_scan_ref(a, b, i, delta=delta))
    torch.cuda.synchronize()
    empty = bucket_scan_cuda(tr[:0], er[:0], 0, delta=DELTA)
    check(empty[0].shape == (0,) and not bool(empty[1])
          and int(empty[2]) == INF, "bucket_scan on n = 0")
    shifted = torch.empty(w_ell.numel() + 1, dtype=torch.int32,
                          device=cuda)[1:].view(w_ell.shape)
    shifted.copy_(w_ell)
    same(torch, (ell_relax_cuda(fidx, dist, shifted),),
         (ell_relax_ref(fidx, dist, shifted),))
    torch.cuda.synchronize()
    # the range form of frontier_relax: the same int32 range and
    # buckets, the scalar scan of a view 4 bytes past 16-byte alignment,
    # a shard's base and sentinel; then calls of different S and cap
    # queued back to back on one stream (its scratch grows between
    # them), each held against the twin after they all ran
    for delta in (1, 7, 2**30):
        for i in (-3, 0, INF // delta, -(2**31) // delta):
            for a, b in ((full[:-1], er), (full[1:], tr)):
                for cap in (4096, ragged):
                    kw_f = dict(delta=delta, cap=cap, base=3 * ragged,
                                sent=4 * ragged)
                    same(torch,
                         frontier_relax_cuda(a, b, i, rg.nbr, rg.w, **kw_f),
                         frontier_relax_ref(a, b, i, rg.nbr, rg.w, **kw_f))
    torch.cuda.synchronize()
    queued = []
    for s_, cap in ((ragged, 4096), (5, 5), (300_001, 300_001), (1025, 1),
                    (70_001, 64), (ragged, ragged)):
        args_f = (full[1:s_ + 1], tr[:s_], 3, rg.nbr[:s_ + 1], rg.w[:s_ + 1])
        queued.append((args_f, cap, frontier_relax_cuda(
            *args_f, delta=7, cap=cap)))
    torch.cuda.synchronize()
    for args_f, cap, out in queued:
        same(torch, out, frontier_relax_ref(*args_f, delta=7, cap=cap))
    del full, shifted, queued
    torch.cuda.synchronize()
    log("[kernel] edge cases equal to the twins: ragged length, cap < "
        "population, all-INF, sentinel fidx, zero-width ELL block, full "
        "int32 range with negative and past-int32 buckets (bucket_scan, "
        "frontier_relax), unaligned views, n = 0, a shard's base and "
        "sentinel, frontier_relax calls of different S and cap back to "
        "back")

    # -- 3. main path -------------------------------------------------------
    counters = {"bucket_scan": bucket_scan_cuda, "ell_relax": ell_relax_cuda,
                "frontier_relax": frontier_relax_cuda,
                "grid_relax": grid_relax_cuda}
    for fn in counters.values():
        fn.launches = 0
    results, per_solve = {}, {}
    for key, plan in plans.items():
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        r = plan.solve(SingleSource(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_solve[key] = {k: fn.launches - before[k]
                          for k, fn in counters.items()}
        results[key] = (r, plan.host_syncs, wall)
    launches_sw = {k: fn.launches for k, fn in counters.items()}
    log(f"[main] launches over the main path: {json.dumps(launches_sw)}")
    check(per_solve[("fused", "argmin")]["frontier_relax"] > 0,
          "fused solve did not launch frontier_relax")
    check(per_solve[("fused", "argmin")]["bucket_scan"] > 0,
          "fused solve did not launch bucket_scan")
    check(per_solve[("pallas", "argmin")]["bucket_scan"] > 0,
          "pallas solve did not launch bucket_scan")
    check(per_solve[("pallas", "argmin")]["ell_relax"] > 0,
          "pallas solve did not launch ell_relax")
    check(all(launches_sw[k] > 0 for k in
              ("bucket_scan", "ell_relax", "frontier_relax")),
          "a kernel of the small-world path never launched")

    base = results[("edge", "argmin")][0]
    base_pred = base.pred.cpu().numpy()
    for key, (r, syncs, wall) in results.items():
        tel = r.telemetry
        dist = r.dist.cpu().numpy()
        pred = r.pred.cpu().numpy()
        check(dist.dtype == np.int32 and pred.dtype == np.int32, "dtypes")
        check(np.array_equal(dist.astype(np.int64), ref_dist),
              f"{key}: dist differs from the scipy oracle")
        check_tree(dist, pred, 0, keyed)
        check((tel.buckets, tel.inner_iters, tel.overflow) ==
              (base.telemetry.buckets, base.telemetry.inner_iters,
               base.telemetry.overflow), f"{key}: telemetry differs")
        if key[1] == "argmin":
            check(np.array_equal(pred, base_pred), f"{key}: pred differs")
        log(f"[main] {key[0]}/{key[1]}: dist == oracle, pred tree ok, "
            f"buckets={tel.buckets} inner_iters={tel.inner_iters} "
            f"overflow={tel.overflow} host_syncs={syncs} "
            f"launches/solve={json.dumps(per_solve[key])} "
            f"first solve {wall * 1e3:.1f} ms"
            + ("" if key[1] == "argmin" else
               f" pred==argmin pred: {np.array_equal(pred, base_pred)}"))
    reach = int((ref_dist < INF).sum())
    log(f"[main] all strategies bitwise equal; reachable {reach}, "
        f"max dist {int(ref_dist[ref_dist < INF].max())}")

    # -- 4. scale-free family under edge ------------------------------------
    t0 = time.perf_counter()
    gr = rmat(2**20, 16 * 2**20, seed=0)
    rref, rkeyed = oracle_dist(gr)
    rplan = Engine(gr, DeltaConfig(delta=DELTA, strategy="edge",
                                   pred_mode="argmin"), device=cuda).plan()
    log(f"[rmat] n={gr.n_nodes} |E|={gr.n_edges} generated + oracle + plan "
        f"in {time.perf_counter() - t0:.1f} s")
    rr = rplan.solve(SingleSource(0))
    rdist, rpred = rr.dist.cpu().numpy(), rr.pred.cpu().numpy()
    check(np.array_equal(rdist.astype(np.int64), rref),
          "rmat: dist differs from the scipy oracle")
    check_tree(rdist, rpred, 0, rkeyed)
    rwalls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rplan.solve(SingleSource(0))
        torch.cuda.synchronize()
        rwalls.append(time.perf_counter() - t0)
    log(f"[rmat] edge: dist == oracle, pred tree ok, buckets="
        f"{rr.telemetry.buckets} inner_iters={rr.telemetry.inner_iters} "
        f"host_syncs={rplan.host_syncs} median solve "
        f"{statistics.median(rwalls) * 1e3:.1f} ms over 3")

    # -- 8. batched queries and frontier policies (small-world part) -------
    launches_bm, launches_pol, launches_fb, launches_twin, records = \
        batch_and_policy_path(torch, np, cuda, g, keyed, plans, results,
                              counters)
    check(launches_bm["bucket_scan"] > 0 and launches_bm["ell_relax"] > 0
          and launches_bm["frontier_relax"] > 0,
          "the batched path did not launch bucket_scan, ell_relax and "
          "frontier_relax")
    check(launches_pol["ell_relax"] > 0,
          "the policy path did not launch ell_relax")
    check(launches_fb["bucket_scan"] > 0 and launches_fb["ell_relax"] > 0
          and launches_fb["frontier_relax"] > 0,
          "the capped and fallback solves did not launch bucket_scan, "
          "ell_relax and frontier_relax")

    # -- 5. the game-map path ----------------------------------------------
    launches_gm, per_grid, gm_records, in_solve, launches_gm_multi = \
        game_map_path(torch, np, cuda, counters)
    check(launches_gm["grid_relax"] > 0 and launches_gm["bucket_scan"] > 0,
          "the game-map path did not launch grid_relax and bucket_scan")
    check(launches_gm_multi["grid_relax"] > 0
          and launches_gm_multi["bucket_scan"] > 0,
          "the game-map MultiSource did not launch grid_relax and "
          "bucket_scan")
    per_solve.update(per_grid)
    by_path = {"smallworld": launches_sw, "gamemap": launches_gm,
               "smallworld_multisource": launches_bm,
               "smallworld_policy": launches_pol,
               "smallworld_fallback": launches_fb,
               "smallworld_fallback_twin": launches_twin,
               "gamemap_multisource": launches_gm_multi}
    # a full-width twin's re-solve is phase 3's solve of its strategy
    # (checked bitwise): its kernels are timed on that solve's inputs
    records = {"smallworld": main_case, **records,
               "smallworld_fallback_twin": main_case, **gm_records}
    launches = {k: sum(p[k] for p in by_path.values()) for k in counters}

    # -- 6. times -----------------------------------------------------------
    for key, plan in plans.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            plan.solve(SingleSource(0))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        r, syncs, _ = results[key]
        log(f"[time] {key[0]}/{key[1]}: median solve "
            f"{statistics.median(walls) * 1e3:.1f} ms over 3 after warm-up "
            f"({', '.join(f'{x * 1e3:.1f}' for x in walls)}), host_syncs="
            f"{syncs}, buckets={r.telemetry.buckets}, "
            f"inner_iters={r.telemetry.inner_iters}")

    # -- 7. where a solve's device time goes (one profiled solve each) ------
    for key in (("fused", "argmin"), ("pallas", "argmin"), ("ell", "argmin"),
                ("edge", "argmin")):
        kern, wall, seen, _ = profiled(torch, lambda: plans[key].solve(
            SingleSource(0)), counters=counters)
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        log(f"[profile] {key[0]}/{key[1]}: profiled solve {wall:.1f} ms, "
            f"device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}), {len(kern)} kernel names; kernel "
            f"records {seen_line(seen)}")
        for name, ms in top:
            log(f"[profile]   {ms:9.3f} ms  {name[:110]}")

    # -- 10. landmark point-to-point queries (before phase 9's updates) ----
    landmark_path(torch, np, cuda, g, ref_dist, keyed, counters)

    # -- 9. dynamic graphs: warm re-solves (updates phase 3's plans) -------
    launches_dyn, launches_lat, dyn_records = dynamic_path(
        torch, np, cuda, g, plans, counters)
    by_path.update(smallworld_warm=launches_dyn, lattice_warm=launches_lat)
    records.update(dyn_records)
    launches = {k: sum(p[k] for p in by_path.values()) for k in counters}

    kernels = []
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=cuda)

    def entry(name, source, replaces, make):
        """One kernels-line entry. ``make(args, kw, size)`` turns a
        recorded input into ``(kernel_fn, twin_fn, nbytes, ops, err,
        iters, yardstick)``; every path with a recorded input of the
        kernel is timed on it (its largest frontier in that path's run).
        ``yardstick`` is None or ``(what, fn)``: a PyTorch call that moves
        part of the kernel's bytes without computing its function, timed
        as ``ms`` is (``yardstick_ms``), to show what the card does with
        those bytes alone. ``ms`` and
        ``plain_ms`` are CUDA-event device times of back-to-back calls
        queued during a spin (``queued_ms``); ``wrapper_ms`` the same
        calls without the spin (host launch time included); ``cold_ms``
        one call at a time with the L2 emptied. The profiler only breaks
        a call's device time down by kernel, where it kept a record of
        every launch."""
        paths = {}
        counter = {name: counters[name]}
        for path, recs in records.items():
            if name not in recs:
                continue
            kernel_fn, twin_fn, nbytes, ops, err, iters, yard = make(
                *recs[name])
            twin_iters = max(1, iters // 4)
            wrapper_ms = timed_ms(torch, kernel_fn, iters)
            ms, ahead = queued_ms(torch, kernel_fn, iters, wrapper_ms)
            check(ahead, f"{name} ({path}): the host did not queue the "
                  "timed calls within the spin")
            plain_ms, plain_ahead = queued_ms(
                torch, twin_fn, twin_iters,
                timed_ms(torch, twin_fn, twin_iters))
            cold = cold_ms(torch, kernel_fn, iters, scratch)
            yard_ms = None
            if yard is not None:
                yard_ms, _ = queued_ms(torch, yard[1], iters,
                                       timed_ms(torch, yard[1], iters))
            kern, _, seen, _ = profiled(torch, kernel_fn, iters, counter)
            kept, n_launch = seen[name]
            own = OWN_KERNELS.get(name)
            check(own is None or kept < n_launch or (
                kept == n_launch and len(kern) <= len(own)
                and all(any(k in kname for k in own) for kname in kern)),
                f"{name} ({path}): a call runs {len(kern)} device "
                f"operations ({kept} records of {n_launch} launches), not "
                f"at most {len(own or ())} of its own: {', '.join(kern)}")
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / ALU_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            check(ms >= bound and cold >= bound,
                  f"{name} ({path}): {ms:.4f} ms (L2 cold {cold:.4f} ms) "
                  f"is below the {bound:.4f} ms bound")
            paths[path] = {
                "launches": by_path[path][name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": err, "wrapper_ms": wrapper_ms,
                "cold_ms": cold, "bytes": nbytes, "ops": ops}
            if yard is not None:
                paths[path]["yardstick_ms"] = yard_ms
            if path == "gamemap":     # None: the profiler dropped records
                paths[path]["in_solve_ms"] = in_solve[name]
            log(f"[time] kernel {name} ({path}): {ms:.4f} ms/launch (CUDA "
                f"events, calls queued; wrapper_ms {wrapper_ms:.4f}, back "
                f"to back with the host's launch time; "
                f"L2 cold {cold:.4f} ms"
                + (f"; in the solve {in_solve[name]:.4f} ms"
                   if paths[path].get("in_solve_ms") is not None else "")
                + f"), twin {plain_ms:.4f} ms"
                + ("" if plain_ahead else " (it synchronises: host gaps "
                   "included)")
                + f", bound {bound:.4f} ms ({nbytes} bytes, {ops} ops), "
                f"launches {by_path[path][name]}; the profiler kept "
                f"{kept} records of {n_launch} launches"
                + ("" if kept == n_launch else ": no breakdown")
                + ("" if yard is None else
                   f"; yardstick {yard[0]}: {yard_ms:.4f} ms"))
            for kname, kms in (sorted(kern.items(), key=lambda kv: -kv[1])
                               if kept == n_launch else ()):
                log(f"[time]   {kms:.4f} ms  {kname[:100]}")
        total = sum(p["launches"] for p in paths.values())
        check(total == launches[name], f"{name}: a launching path is not "
              "timed")

        def mean(key):
            return sum(p["launches"] * p[key] for p in paths.values()) / total

        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(p["max_abs_err"] for p in paths.values()),
            "ms": mean("ms"), "cold_ms": mean("cold_ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": ("bytes" if all(p["bound_by"] == "bytes"
                                        for p in paths.values())
                         else "operations"),
            "library_ms": None, "by_path": paths})
        log(f"[time] kernel {name}: launch-weighted {mean('ms'):.4f} "
            f"ms/launch, bound {mean('bound_ms'):.4f} ms; launches/solve "
            f"{ {k[0] + '/' + k[1]: v[name] for k, v in per_solve.items()} }")

    def scan_case(t_, e_, i_, delta):
        n = t_.shape[0]
        return (lambda: bucket_scan_cuda(t_, e_, i_, delta=delta),
                lambda: bucket_scan_ref(t_, e_, i_, delta=delta),
                9 * n + 8, 8 * n,
                same(torch, bucket_scan_cuda(t_, e_, i_, delta=delta),
                     bucket_scan_ref(t_, e_, i_, delta=delta)), 40,
                ("torch.lt(tent, explored), its bytes without the "
                 "reduction", lambda: torch.lt(t_, e_)))

    entry("bucket_scan", "src/repro_torch/csrc/bucket_scan.cu",
          "src/repro/kernels/bucket_scan/bucket_scan.py:36",
          lambda args, kw, size: scan_case(*args, kw["delta"]))

    def relax_case(fidx, dist, w_ell, m):
        cap, dd = fidx.shape[0], w_ell.shape[1]
        filled = torch.empty((cap, dd), dtype=torch.int32, device=cuda)
        return (lambda: ell_relax_cuda(fidx, dist, w_ell),
                lambda: ell_relax_ref(fidx, dist, w_ell),
                4 * cap + 4 * m + 4 * dd * (m + int(m < cap)) + 4 * cap * dd,
                4 * cap * dd,
                same(torch, (ell_relax_cuda(fidx, dist, w_ell),),
                     (ell_relax_ref(fidx, dist, w_ell),)), 20,
                ("fill_ of the [cap, D] output, its writes alone",
                 lambda: filled.fill_(INF)))

    entry("ell_relax", "src/repro_torch/csrc/ell_relax.cu",
          "src/repro/kernels/ell_relax/ell_relax.py:29",
          lambda args, kw, m: relax_case(*args, m))

    def fr_case(args, kw, pop):
        d, w = args[0], args[4]
        cap, dd = kw["cap"], w.shape[1]
        filled = min(pop, cap)
        out_n = torch.empty((cap, dd), dtype=torch.int32, device=cuda)
        out_w = torch.empty_like(out_n)
        return (lambda: run_fr(args, kw, frontier_relax_cuda),
                lambda: run_fr(args, kw, frontier_relax_ref),
                8 * d.shape[0] + 4 * cap + 8 * cap * dd
                + 8 * dd * (filled + int(filled < cap)) + 12,
                8 * d.shape[0] + 2 * cap * dd,
                same(torch, run_fr(args, kw, frontier_relax_cuda),
                     run_fr(args, kw, frontier_relax_ref)), 20,
                ("fill_ of the two [cap, D] outputs, their writes alone",
                 lambda: (out_n.fill_(INF), out_w.fill_(INF))))

    entry("frontier_relax", "src/repro_torch/csrc/frontier_relax.cu",
          "src/repro/kernels/frontier_relax/frontier_relax.py:57", fr_case)

    def grid_case(args, kw, size):
        t_, f_, i_ = args
        hw = t_.numel()
        moves = 4   # one move class per phase at Δ = 13: 4 straight or
        #             4 diagonal
        return (lambda: grid_relax_cuda(t_, f_, i_, **kw),
                lambda: grid_relax_ref(t_, f_, i_, **kw),
                9 * hw, hw * (3 + 3 * moves + 2),
                same(torch, (grid_relax_cuda(t_, f_, i_, **kw),),
                     (grid_relax_ref(t_, f_, i_, **kw),)), 40, None)

    entry("grid_relax", "src/repro_torch/csrc/grid_relax.cu",
          "src/repro/kernels/grid_relax/grid_relax.py:45", grid_case)
    torch.cuda.synchronize()

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
