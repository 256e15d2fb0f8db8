"""Batched multi-source SSSP on the PyTorch/CUDA port, the twin of
``examples/multi_source_sssp.py`` — the paper's betweenness-centrality
regime at two scales:

1. one device: ``MultiSource`` runs the bucket loop over a batch of
   sources (batched tent/explored state, per-source counters, lanes
   freeze as they converge), each lane bitwise its own solve;
2. SPMD: the distributed engine (``repro_torch.core.distributed``:
   vertex partition over ``model``, sources over ``data``) on a
   ``DeviceMesh`` of ranks, one process per GPU.

    PYTHONPATH=src python examples/torch_multi_source_sssp.py
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/torch_multi_source_sssp.py
    PYTHONPATH=src python examples/torch_multi_source_sssp.py --device cpu

The distributed part uses the process group the script is launched with
(``torchrun``: ``(2, W / 2)`` ranks for an even W >= 4, else ``(1,
W)``). Run alone it is one rank on CUDA (a ``(1, 1)`` mesh); with
``--device cpu`` and no group it spawns the reference's ``2 x 4`` layout
itself as 8 gloo ranks. It runs on CUDA unless ``--device cpu`` is
given, and asserts every answer.
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.api import Engine, MultiSource, SingleSource
from repro_torch.core import DeltaConfig, dijkstra
from repro_torch.core.distributed import (DistDeltaConfig,
                                          build_distributed_solver)
from repro_torch.graphs import partition_edges, watts_strogatz

SOURCES = [0, 11, 503, 1999]
SPAWNED = 8                     # the reference's 2 x 4 host mesh


def problem():
    g = watts_strogatz(2_000, 12, 1e-2, seed=3)
    refs = np.stack([dijkstra(g, s)[0] for s in SOURCES])
    return g, refs


def single_device(device):
    """The batched single-device path, lane by lane against solves."""
    g, refs = problem()
    plan = Engine(g, DeltaConfig(delta=10), device=device).plan()
    res = plan.solve(MultiSource(SOURCES))
    assert np.array_equal(res.dist.cpu().numpy().astype(np.int64), refs)
    for i, s in enumerate(SOURCES):
        one = plan.solve(SingleSource(s))
        assert torch.equal(res.dist[i], one.dist)
        assert int(res.telemetry.buckets[i]) == one.telemetry.buckets
    print(f"MultiSource on {plan.device}: {len(SOURCES)} sources in one "
          f"batched loop, {[int(o) for o in res.telemetry.buckets]} buckets "
          f"per source — bitwise equal to per-source solves ✓")


def distributed(device):
    """The distributed engine on the process group's ranks (one rank
    without a group); rank 0 prints."""
    g, refs = problem()
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = 2 if world >= 4 and world % 2 == 0 else 1
    model = world // data
    mesh = None
    if dist.is_initialized():
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(data, model)
    part = partition_edges(g, model, device="cpu")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if rank0:
        print(f"|V|={g.n_nodes} |E|={g.n_edges}, mesh (data={data}, "
              f"model={model}), {part.edges_per_shard} edges/shard")
    for combine in ("allreduce", "reduce_scatter"):
        solve = build_distributed_solver(
            part, mesh, DistDeltaConfig(delta=10, combine=combine,
                                        local_steps=2), device=device)
        d, outer, inner = solve(SOURCES)
        assert np.array_equal(d.cpu().numpy().astype(np.int64), refs), \
            combine
        if rank0:
            print(f"{combine:>15s}: {outer} buckets, {inner} light phases — "
                  f"all {len(SOURCES)} sources match Dijkstra ✓")


def _spawned_rank(rank, world, store_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        distributed("cpu")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    device = ap.parse_args().device
    cpu = device is not None and torch.device(device).type == "cpu"
    if "WORLD_SIZE" in os.environ:              # launched by torchrun
        if cpu:
            dist.init_process_group("gloo")
        else:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
        try:
            if dist.get_rank() == 0:
                single_device(device)
            distributed(device)
        finally:
            dist.destroy_process_group()
        return
    single_device(device)
    if not cpu:
        distributed(device if device is not None else "cuda")
        return
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned_rank,
                           args=(SPAWNED, os.path.join(tmp, "store")),
                           nprocs=SPAWNED, start_method="spawn")


if __name__ == "__main__":
    main()
