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
   frontier population, all-INF input, sentinel ``fidx`` and a
   zero-width ELL block.
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
5. Times: per strategy the median solve wall time of three solves after
   the warm-up, with host synchronisations and counters.
6. One profiled solve per strategy (``torch.profiler``): device busy
   time, idle share and the kernels that take the most device time.
   Per kernel at the main path's shapes: device time per wrapper call
   (profiler; CUDA events over back-to-back calls where the profiler
   sees no device time), its twin's, and its bound (the bytes this input
   needs ÷ 3.35 TB/s, or its integer operations ÷ 67 T/s if larger).

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
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor-core rate (data sheet)
INF = 2**31 - 1
N_NODES, DEGREE, P_REWIRE, DELTA = 1_000_000, 20, 1e-2, 10


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


def profiled(torch, fn, iters: int = 1):
    """Device time per call of ``fn`` by CUDA kernel name, in ms, from
    ``torch.profiler`` (empty when the profiler saw no device time), and
    the wall time per call of the profiled window."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kern = {}
    for e in prof.key_averages():
        dt = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            kern[e.key] = kern.get(e.key, 0.0) + dt / 1e3 / iters
    return kern, wall


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


def oracle_dist(g):
    """scipy Dijkstra on the deduplicated graph, INF32 for unreachable."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = g.n_nodes
    key, w = dedup_min(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                       g.w.cpu().numpy(), n)
    mat = sp.csr_matrix((w.astype(np.float64), (key // n, key % n)),
                        shape=(n, n))
    d = dijkstra(mat, directed=True, indices=0)
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
    log("[kernel] edge cases equal to the twins: ragged length, cap < "
        "population, all-INF, sentinel fidx, zero-width ELL block")

    # -- 3. main path -------------------------------------------------------
    counters = {"bucket_scan": bucket_scan_cuda, "ell_relax": ell_relax_cuda,
                "frontier_relax": frontier_relax_cuda}
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
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[main] launches over the main path: {json.dumps(launches)}")
    check(per_solve[("fused", "argmin")]["frontier_relax"] > 0,
          "fused solve did not launch frontier_relax")
    check(per_solve[("fused", "argmin")]["bucket_scan"] > 0,
          "fused solve did not launch bucket_scan")
    check(per_solve[("pallas", "argmin")]["bucket_scan"] > 0,
          "pallas solve did not launch bucket_scan")
    check(per_solve[("pallas", "argmin")]["ell_relax"] > 0,
          "pallas solve did not launch ell_relax")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")

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

    # -- 5. times -----------------------------------------------------------
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

    # -- 6. where a solve's device time goes (one profiled solve each) ------
    for key in (("fused", "argmin"), ("pallas", "argmin"), ("ell", "argmin"),
                ("edge", "argmin")):
        kern, wall = profiled(torch, lambda: plans[key].solve(
            SingleSource(0)))
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        log(f"[profile] {key[0]}/{key[1]}: profiled solve {wall:.1f} ms, "
            f"device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}), {len(kern)} kernel names")
        for name, ms in top:
            log(f"[profile]   {ms:9.3f} ms  {name[:110]}")

    kernels = []

    def entry(name, source, replaces, kernel_fn, twin_fn, nbytes, ops, err,
              iters):
        wrapper_ms = timed_ms(torch, kernel_fn, iters)
        kern, _ = profiled(torch, kernel_fn, iters)
        twin, _ = profiled(torch, twin_fn, max(1, iters // 4))
        dev_ms, plain_ms = sum(kern.values()), sum(twin.values())
        if dev_ms > 0:
            ms, how = dev_ms, "profiler device time per wrapper call"
        else:
            ms, how = wrapper_ms, "CUDA events over back-to-back calls"
            plain_ms = timed_ms(torch, twin_fn, max(1, iters // 4))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "ms_how": how, "wrapper_ms": wrapper_ms})
        log(f"[time] kernel {name}: {ms:.4f} ms/launch ({how}; events "
            f"{wrapper_ms:.4f} ms), twin {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes} bytes, {ops} ops), "
            f"launches/solve "
            f"{ {k[0] + '/' + k[1]: v[name] for k, v in per_solve.items()} }")
        for kname, kms in sorted(kern.items(), key=lambda kv: -kv[1]):
            log(f"[time]   {kms:.4f} ms  {kname[:100]}")

    (t_, e_, i_), kw, pop = main_case["bucket_scan"]
    n = t_.shape[0]
    entry("bucket_scan", "src/repro_torch/csrc/bucket_scan.cu",
          "src/repro/kernels/bucket_scan/bucket_scan.py:36",
          lambda: bucket_scan_cuda(t_, e_, i_, delta=DELTA),
          lambda: bucket_scan_ref(t_, e_, i_, delta=DELTA),
          9 * n + 8, 8 * n,
          same(torch, bucket_scan_cuda(t_, e_, i_, delta=DELTA),
               bucket_scan_ref(t_, e_, i_, delta=DELTA)), 40)
    (fidx, dist, w_ell), kw, m = main_case["ell_relax"]
    cap, dd = fidx.shape[0], w_ell.shape[1]
    entry("ell_relax", "src/repro_torch/csrc/ell_relax.cu",
          "src/repro/kernels/ell_relax/ell_relax.py:29",
          lambda: ell_relax_cuda(fidx, dist, w_ell),
          lambda: ell_relax_ref(fidx, dist, w_ell),
          4 * cap + 4 * m + 4 * dd * (m + int(m < cap)) + 4 * cap * dd,
          4 * cap * dd,
          same(torch, (ell_relax_cuda(fidx, dist, w_ell),),
               (ell_relax_ref(fidx, dist, w_ell),)), 20)
    (d, e, i, nbr, w), kw, pop = main_case["frontier_relax"]
    cap, dd = kw["cap"], w.shape[1]
    filled = min(pop, cap)
    entry("frontier_relax", "src/repro_torch/csrc/frontier_relax.cu",
          "src/repro/kernels/frontier_relax/frontier_relax.py:57",
          lambda: run_fr((d, e, i, nbr, w), kw, frontier_relax_cuda),
          lambda: run_fr((d, e, i, nbr, w), kw, frontier_relax_ref),
          8 * d.shape[0] + 4 * cap + 8 * cap * dd
          + 8 * dd * (filled + int(filled < cap)) + 12,
          8 * d.shape[0] + 2 * cap * dd,
          same(torch, run_fr((d, e, i, nbr, w), kw, frontier_relax_cuda),
               run_fr((d, e, i, nbr, w), kw, frontier_relax_ref)), 20)
    torch.cuda.synchronize()

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
