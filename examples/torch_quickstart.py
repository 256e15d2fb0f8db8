"""Quickstart of the PyTorch/CUDA port (``repro_torch``), the twin of
``examples/quickstart.py``: the Query/Plan façade (DESIGN.md §10/§11) on
a small-world graph — plan once, then dispatch every query kind against
the same engine; verify against Dijkstra.

    PYTHONPATH=src python examples/torch_quickstart.py              # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

It runs on CUDA unless ``--device cpu`` is given (then the kernels'
plain twins run), asserts every answer, and is façade-only: it runs
clean under ``-W error::DeprecationWarning``.
"""
import argparse

import numpy as np

from repro_torch.api import (
    BoundedRadius,
    Engine,
    ManyToMany,
    MultiSource,
    PointToPoint,
    SingleSource,
    UpdateBatch,
)
from repro_torch.core import DeltaConfig, dijkstra, resolve_n_shards
from repro_torch.dynamic import apply_weight_update
from repro_torch.graphs import watts_strogatz
from repro_torch.serve import Server

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: cuda; 'cpu' runs the kernels' "
                     "plain twins)")
device = ap.parse_args().device
INF = 2**31 - 1

# the paper's small-world family: ring lattice + random rewiring
g = watts_strogatz(n=5_000, k=20, p=1e-2, seed=0)
print(f"graph: |V|={g.n_nodes} |E|={g.n_edges}")

# plan once: config resolution and backend build — then every query
# kind dispatches against the same engine
plan = Engine(g, DeltaConfig(delta=10, pred_mode="argmin"),
              device=device).plan()
res = plan.solve(SingleSource(0))
print(f"Δ-stepping on {plan.device}: {res.telemetry.buckets} buckets, "
      f"{res.telemetry.inner_iters} light sweeps")

# verify against the Dijkstra oracle (the paper's Boost baseline)
ref, _ = dijkstra(g, 0)
dist = res.dist.cpu().numpy()
assert np.array_equal(dist.astype(np.int64), ref)
print("distances match heap Dijkstra ✓")

# point-to-point with early exit: the solve stops as soon as the
# target's bucket settles
far = int(np.argmax(np.where(dist < INF, dist, -1)))
p2p = plan.solve(PointToPoint(0, far))
assert p2p.distance == int(ref[far])
print(f"p2p 0->{far}: dist={p2p.distance}, path {len(p2p.path) - 1} hops, "
      f"{p2p.telemetry.buckets} buckets (early exit)")

# bounded radius: everything farther than r reports as unreachable
r = int(np.median(ref[ref < INF]))
ball = plan.solve(BoundedRadius(0, r))
n_in = int((ball.dist.cpu().numpy() < INF).sum())
assert n_in == int((ref <= r).sum())
print(f"bounded radius {r}: {n_in} vertices within, "
      f"{ball.telemetry.buckets} buckets")

# batched multi-source: lane i is bitwise SingleSource(sources[i])
many = plan.solve(MultiSource([0, 1, 2, 3]))
assert np.array_equal(many.dist[0].cpu().numpy(), dist)
print(f"MultiSource: batch of {many.dist.shape[0]} sources, "
      f"{[int(o) for o in many.telemetry.buckets]} buckets each")

# many-to-many distance matrix, assembled from tiled multi-source runs
mm = plan.solve(ManyToMany(sources=[0, 1, 2], targets=[10, 20, 30], tile=2))
assert np.array_equal(mm.matrix[0], ref[[10, 20, 30]])
print(f"many-to-many: {tuple(mm.matrix.shape)} matrix via tiled solves ✓")

# tuning="auto": Δ from graph statistics with zero measurement; the
# answers never change, only time does
auto_plan = Engine(g, tuning="auto", device=device).plan()
res_auto = auto_plan.solve(SingleSource(0))
assert np.array_equal(res_auto.dist.cpu().numpy(), dist)
print(f"tuning='auto': Δ={auto_plan.config.delta} "
      f"({auto_plan.config.strategy}), same distances ✓")

# sharded strategy (DESIGN.md §9): relaxation partitioned over the ranks
# of the process group, candidates merged with all_reduce(MIN) each
# sweep — bitwise the single-device answer for any shard count. Run
# alone it is one shard; under
#   torchrun --nproc-per-node 4 -m repro_torch.launch.sssp \
#       --strategy sharded_edge --verify
# it shards over every rank.
sh_plan = Engine(g, DeltaConfig(delta=10, strategy="sharded_edge",
                                pred_mode="argmin"), device=device).plan()
res_sh = sh_plan.solve(SingleSource(0))
assert np.array_equal(res_sh.dist.cpu().numpy(), dist)
assert np.array_equal(res_sh.pred.cpu().numpy(), res.pred.cpu().numpy())
print(f"sharded_edge over {resolve_n_shards(None)} shard(s): "
      f"same distances ✓")

# dynamic edge costs: update() swaps costs on the resident plan; the
# warm re-solve repairs from the previous answer and equals a cold solve
# of the updated graph
rng = np.random.default_rng(0)
ids = rng.choice(g.n_edges, size=g.n_edges // 100, replace=False)
new_w = np.clip(plan.graph.w.cpu().numpy()[ids]
                + rng.integers(-5, 6, size=ids.size), 1, None)
warm = plan.solve(UpdateBatch(ids, new_w))
cold_ref, _ = dijkstra(apply_weight_update(g, ids, new_w), 0)
assert np.array_equal(warm.dist.cpu().numpy().astype(np.int64), cold_ref)
print(f"dynamic update of {ids.size} edges: warm re-solve repaired "
      f"{warm.telemetry.repaired} vertices over {warm.telemetry.buckets} "
      f"buckets (cold solve: {res.telemetry.buckets}) ✓")

# async serving tier: submit() returns a Ticket; the batch former packs
# lane-able queries into one padded multi-source solve, so every answer
# is what a serial plan.solve stream would give
with Server(g, config=DeltaConfig(delta=10, pred_mode="argmin"),
            lane_width=4, device=device) as srv:
    tickets = [srv.submit(SingleSource(s)) for s in (0, 1, 2)]
    hop = srv.submit(PointToPoint(0, 42))
    assert np.array_equal(tickets[0].result().dist.cpu().numpy(), dist)
    assert hop.result().distance == int(dist[42])
stats = srv.stats()
print(f"serving tier: {stats['completed']} queries in "
      f"{sum(stats['batches'].values())} microbatches "
      f"(occupancy {stats['mean_occupancy']:.2f}, "
      f"p50 {stats['latency_p50_ms']:.0f} ms) ✓")
