"""Serving launcher of the PyTorch port: LM decode over the slot server
(``repro_torch.serve.BatchServer``) and batched SSSP queries over the
async serving tier (``repro_torch.serve.Server``, DESIGN.md §13).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
      --smoke --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --sssp --nodes 20000 \\
      --requests 32 --batch 8

  PYTHONPATH=src python -m repro_torch.launch.serve --sssp --device cpu \\
      --nodes 3000 --requests 12 --batch 4

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --sssp --device cpu --nodes 3000 --strategy sharded_edge --shards 2

Flag names and defaults follow ``repro.launch.serve``. Everything runs
on CUDA unless ``--device cpu`` is given (then the kernels' plain twins
run); without a CUDA device and without ``--device`` the launcher raises.

LM decode (``--arch``, an LM architecture of ``repro_torch.configs``;
``--smoke`` for its reduced config): random weights from seed 0 on the
device, ``--requests`` requests of ``--prompt-len`` seeded tokens and
``--max-new`` new tokens each through a ``BatchServer`` of ``--slots``
slots and a ``--max-len`` cache (no end-of-sequence id).

SSSP (``--sssp``): the graph is ``watts_strogatz(--nodes, --degree,
1e-2, seed=0)``; one ``SingleSource(0)`` is served first (kernel build
and warm-up), then ``--requests`` requests, alternating
``SingleSource`` and ``PointToPoint`` from seeded sources, go through
the background batch loop in lane batches of ``--batch``. ``--tune``
tunes the tenant's operating point by measured search at graph load;
``--tune-cache PATH`` persists and reuses the record (alone: a cache
hit or the zero-measurement estimator).

Under ``torchrun`` the launcher starts the process group as
``launch.sssp`` does (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``); ``--strategy sharded_edge|sharded_ell|sharded_fused`` then
shards the tenant's relaxation over the group's ranks (``--shards``:
the group's size, the default, or 1). Rank 0 submits the request
stream and prints; the other ranks run its batch plan.
"""
from __future__ import annotations

import argparse
import time


def _serve_sssp(args, device):
    import numpy as np
    import torch

    from repro_torch.api import PointToPoint, SingleSource, Tuning
    from repro_torch.core import DeltaConfig, resolve_n_shards
    from repro_torch.core.backends import group_size
    from repro_torch.graphs import watts_strogatz
    from repro_torch.serve import Server

    rank0 = group_size() == 1 or torch.distributed.get_rank() == 0

    def say(line):                              # rank 0 prints
        if rank0:
            print(line)

    g = watts_strogatz(args.nodes, args.degree, 1e-2, seed=0)
    t0 = time.perf_counter()
    # the concrete config is the tuning *base*: --strategy, --shards and
    # --policy survive tuning as non-searched fields
    auto = args.tune or args.tune_cache is not None
    config = DeltaConfig(delta=args.delta, strategy=args.strategy,
                         n_shards=args.shards, policy=args.policy,
                         rho=args.rho)
    if not auto and args.policy != "delta":
        say(f"[serve] frontier policy: {args.policy}")
    if not auto and args.strategy.startswith("sharded"):
        say(f"[serve] mesh-sharded relaxation over "
            f"{resolve_n_shards(args.shards)} rank(s)")
    tuning = Tuning(measure=args.tune, cache=args.tune_cache) if auto \
        else None
    srv = Server(g, config=config, tuning=tuning, lane_width=args.batch,
                 device=device)
    dev = srv.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if auto and rank0:
        plan = srv.plan()
        cfg, rec = plan.config, plan.record
        print(f"[serve] tuned at graph load on {name}: Δ={cfg.delta} "
              f"strategy={cfg.strategy} policy={cfg.policy} "
              f"cap={cfg.frontier_cap} record={rec.source} "
              f"({time.perf_counter() - t0:.1f}s)")
    if rank0:
        srv.submit(SingleSource(0))
    srv.drain()             # kernel build + warm-up (other ranks: follow)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tickets = []
    with srv:                                   # continuous batch loop
        for i in range(args.requests if rank0 else 0):
            # mix of full distance-vector and point-to-point queries
            src = int(rng.integers(g.n_nodes))
            q = (PointToPoint(src, int(rng.integers(g.n_nodes)))
                 if i % 2 else SingleSource(src))
            tickets.append(srv.submit(q))
        results = [t.result() for t in tickets]
    if not rank0:
        return
    dt = time.perf_counter() - t0
    n_paths = sum(1 for r in results if getattr(r, "path", None) is not None)
    stats = srv.stats()
    print(f"[serve] answered {len(results)} SSSP queries ({n_paths} with "
          f"paths) in {dt:.2f}s on {name} "
          f"({len(results) / dt:.1f} qps, lanes={args.batch}, "
          f"|V|={g.n_nodes})")
    print(f"[serve] p50={stats['latency_p50_ms']:.1f} ms "
          f"p99={stats['latency_p99_ms']:.1f} ms "
          f"occupancy={stats['mean_occupancy']:.2f} "
          f"batches={stats['batches']} shed={stats['shed'] or 0}")


def _serve_lm(args, device):
    import numpy as np
    import torch

    from repro_torch.configs import family_of, get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import BatchServer, Request

    if family_of(args.arch) != "lm":
        raise ValueError(f"LM serving needs an lm arch, not {args.arch!r}")
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    srv = BatchServer(params, cfg, n_slots=args.slots, max_len=args.max_len,
                      eos_id=-1)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        srv.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                dtype=np.int32),
            max_new=args.max_new))
    done = srv.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    print(f"[serve] completed {len(done)} requests, {tokens} tokens in "
          f"{dt:.2f}s on {name} ({tokens / dt:.1f} tok/s with {args.slots} "
          f"slots, {cfg.name})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--sssp", action="store_true",
                    help="serve batched SSSP queries instead of LM decode")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--degree", type=int, default=12)
    ap.add_argument("--delta", type=int, default=10)
    ap.add_argument("--strategy", default="edge",
                    choices=["edge", "ell", "fused", "sharded_edge",
                             "sharded_ell", "sharded_fused"],
                    help="relaxation strategy (sharded_*: over the ranks "
                         "of the process group, DESIGN.md §9)")
    ap.add_argument("--shards", type=int, default=None,
                    help="sharded_* strategies: shard count (default: "
                         "every rank of the process group)")
    ap.add_argument("--policy", default="delta",
                    choices=["delta", "rho", "radius"],
                    help="frontier-selection policy (DESIGN.md §15)")
    ap.add_argument("--rho", type=int, default=None,
                    help="--policy rho: batch size rho")
    ap.add_argument("--batch", type=int, default=8,
                    help="microbatch size (MultiSource lanes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    ap.add_argument("--tune", action="store_true",
                    help="measured auto-tune at graph load")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="persistent tuning cache")
    args = ap.parse_args(argv)

    if not args.sssp:
        if not args.arch:
            ap.error("--arch is required for LM serving")
        _serve_lm(args, args.device)
        return

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    device, owns_group = init_group(args.device)
    try:
        _serve_sssp(args, device)
    finally:
        if owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
