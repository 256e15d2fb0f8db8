"""SSSP launcher of the PyTorch port — the paper's workload end to end.

  PYTHONPATH=src python -m repro_torch.launch.sssp --graph smallworld \\
      --nodes 100000 --degree 20 --delta 10 --strategy fused --verify

  PYTHONPATH=src python -m repro_torch.launch.sssp --graph gamemap \\
      --nodes 250000 --strategy pallas --target 249999 --verify

  PYTHONPATH=src python -m repro_torch.launch.sssp --sources 4 \\
      --policy rho --rho 512 --strategy ell --verify

  PYTHONPATH=src python -m repro_torch.launch.sssp --nodes 100000 \\
      --target 54321 --p2p-mode alt_bidirectional --landmarks 4 --verify

Flag names follow ``repro.launch.sssp``. The solve runs on CUDA unless
``--device cpu`` is given (then the kernels' plain twins run). The
first solve builds the CUDA kernels and warms up; the second is timed.
``--graph gamemap`` is a ``sqrt(nodes)``-square occupancy grid with
obstacle fraction 0.1 at Δ = 13; ``--strategy pallas`` solves it with
the grid stencil. ``--target T`` answers one ``PointToPoint`` query
from source 0 instead of the full solve, in ``--p2p-mode`` (default
``early_exit``; the landmark modes ``alt``, ``bidirectional``,
``alt_bidirectional`` first build ``--landmarks K`` landmark tables,
default 4, and print the build time).
``--sources K`` solves sources 0..K-1 as one ``MultiSource`` query
(``edge`` and ``ell``: one batched loop; the kernel strategies: lane by
lane). ``--policy rho|radius`` (with ``--rho`` / ``--radius-k``) runs
the frontier-policy loop instead of the bucket loop. ``--verify``
checks the distances (lane 0 of a batch) against the heap-Dijkstra
oracle and exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="smallworld",
                    choices=["smallworld", "rmat", "gamemap"])
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--degree", type=int, default=20)
    ap.add_argument("--p", type=float, default=1e-2)
    ap.add_argument("--delta", type=int, default=10)
    ap.add_argument("--strategy", default="edge",
                    choices=["edge", "ell", "pallas", "fused"])
    ap.add_argument("--pred-mode", default="argmin",
                    choices=["none", "argmin", "packed"])
    ap.add_argument("--policy", default="delta",
                    choices=["delta", "rho", "radius"],
                    help="frontier-selection policy: the paper's bucket "
                         "loop, rho-stepping or radius-stepping over the "
                         "same backend")
    ap.add_argument("--rho", type=int, default=None,
                    help="--policy rho: batch size rho (default: "
                         "max(32, |V|/8))")
    ap.add_argument("--radius-k", type=int, default=4,
                    help="--policy radius: r(v) = k-th smallest outgoing "
                         "edge weight")
    ap.add_argument("--sources", type=int, default=1,
                    help="solve sources 0..K-1 as one MultiSource query")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    ap.add_argument("--target", type=int, default=None,
                    help="point-to-point query from source 0 to this "
                         "vertex")
    ap.add_argument("--p2p-mode", default="early_exit",
                    choices=["early_exit", "alt", "bidirectional",
                             "alt_bidirectional"],
                    help="--target search mode: goal-directed (alt*) "
                         "and/or bidirectional Δ-stepping")
    ap.add_argument("--landmarks", type=int, default=None, metavar="K",
                    help="landmark count for --p2p-mode other than "
                         "early_exit (default 4)")
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.api import (Engine, MultiSource, PointToPoint,
                                 SingleSource)
    from repro_torch.core import DeltaConfig, dijkstra
    from repro_torch.graphs import grid_map, rmat, watts_strogatz

    t0 = time.perf_counter()
    free = None
    if args.graph == "smallworld":
        g = watts_strogatz(args.nodes, args.degree - args.degree % 2, args.p,
                           seed=0)
    elif args.graph == "rmat":
        g = rmat(args.nodes, args.nodes * args.degree, seed=0)
    else:
        side = int(np.sqrt(args.nodes))
        g, free = grid_map(side, side, 0.1, seed=0)
        args.delta = 13
    print(f"[sssp] graph {args.graph}: |V|={g.n_nodes} |E|={g.n_edges} "
          f"({time.perf_counter() - t0:.1f}s to generate)")

    cfg = DeltaConfig(delta=args.delta, strategy=args.strategy,
                      pred_mode=args.pred_mode, policy=args.policy,
                      rho=args.rho, radius_k=args.radius_k)
    sources = list(range(args.sources))
    engine = Engine(g, cfg, free_mask=free, device=args.device)
    plan = engine.plan(sources=sources)
    dev = engine.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if cfg.policy != "delta":
        print(f"[sssp] frontier policy: {cfg.policy}")
    if args.target is not None:
        mode = args.p2p_mode
        build = ""
        if mode != "early_exit":
            t0 = time.perf_counter()
            plan.prepare_landmarks(k=args.landmarks or 4)
            build = (f", k={plan.landmark_tables.k} landmark tables in "
                     f"{time.perf_counter() - t0:.1f} s")
        q = PointToPoint(sources[0], args.target, mode=mode)
        plan.solve(q)                           # kernel build + warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = plan.solve(q)
        dt = time.perf_counter() - t0
        hops = 0 if r.path is None else len(r.path) - 1
        print(f"[sssp] p2p {sources[0]}->{args.target} on {name}: "
              f"dist={r.distance} "
              f"hops={hops} buckets={r.telemetry.buckets} "
              f"inner_iters={r.telemetry.inner_iters} ({mode}{build}), "
              f"{dt * 1e3:.1f} ms, host syncs={plan.host_syncs}")
        if args.verify:
            ref, _ = dijkstra(g, sources[0])
            ok = int(ref[args.target]) == r.distance
            print(f"[sssp] verify vs Dijkstra: {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(1)
        return
    if len(sources) > 1:
        q = MultiSource(sources)                # one batched query
    else:
        q = SingleSource(sources[0])
    plan.solve(q)                               # kernel build + warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = plan.solve(q)
    dist = r.dist.cpu().numpy().reshape(len(sources), -1)
    dt = time.perf_counter() - t0
    tel = r.telemetry
    batch = f", batched x{len(sources)}" if len(sources) > 1 else ""
    print(f"[sssp] Δ={cfg.delta} ({cfg.strategy}, {cfg.pred_mode}{batch}) "
          f"on {name}: {dt * 1e3 / len(sources):.1f} ms/source, "
          f"buckets={int(torch.as_tensor(tel.buckets).max())}, "
          f"light sweeps={int(torch.as_tensor(tel.inner_iters).max())}, "
          f"host syncs={plan.host_syncs}")
    if args.verify:
        ref, _ = dijkstra(g, sources[0])
        ok = np.array_equal(dist[0].astype(np.int64), ref)
        print(f"[sssp] verify vs Dijkstra: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
