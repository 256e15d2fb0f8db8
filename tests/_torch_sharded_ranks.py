"""One rank of the 4-rank gloo group of ``tests/test_torch_sharded.py``.

    python tests/_torch_sharded_ranks.py RANK WORLD STORE INPUTS OUT

Joins the group (``file://STORE``), loads the graphs and the update
batch from ``INPUTS`` (an ``.npz`` the test wrote from the JAX
package's generators), runs the port's sharded strategies, the
distributed engine on the meshes of ``launch.mesh.make_host_mesh`` (and
that helper's errors) and the tuner on the CPU, and saves what it got to
``OUT`` (``torch.save`` of a dict of tensors, ints and strings) for the
test to hold against the JAX package. Imports no JAX. Every collective
times out after ``COLLECTIVE_TIMEOUT``, so a hang fails fast.
"""
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import (  # noqa: E402
    Engine,
    MultiSource,
    SingleSource,
    UpdateBatch,
)
from repro_torch.core import DeltaConfig  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistDeltaConfig,
    build_distributed_solver,
)
from repro_torch.graphs import coo_from_numpy, partition_edges  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    make_production_mesh,
    mesh_name,
)
from repro_torch.tune import (  # noqa: E402
    default_strategies,
    fingerprint,
    graph_stats,
    tune,
)

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
GRAPHS = ("smallworld", "rmat", "lattice")
STRATEGIES = ("sharded_edge", "sharded_ell", "sharded_fused")
PRED_MODES = ("none", "argmin", "packed")
MULTI_SOURCES = (0, 7, 42, 100)
DIST_SOURCES = (0, 3, 17, 29)
MESHES = ((1, 4), (2, 2))
BAD_MESHES = ((2, 4), (3, 1))        # 8 and 3 ranks in a group of 4
COMBINES = ("allreduce", "reduce_scatter")
LOCAL_STEPS = (1, 2)
CAPPED = dict(delta=1_000, frontier_cap=2)     # overflows per shard
TUNE_DELTAS = (5, 10)


def run_fields(res):
    """A result's fields as a dict of tensors and Python scalars."""
    t = res.telemetry
    return {"dist": res.dist, "pred": res.pred,
            "buckets": torch.as_tensor(t.buckets),
            "inner_iters": torch.as_tensor(t.inner_iters),
            "overflow": torch.as_tensor(t.overflow),
            "fallback": bool(t.fallback), "warm": bool(t.warm),
            "repaired": -1 if t.repaired is None else int(t.repaired)}


def injected_time(rank: int):
    """A measure_fn whose times differ by rank: alone, rank 0 would pick
    sharded_edge at Δ = 10; the slowest rank's times pick it at Δ = 5."""
    base = {(5, "edge"): 3.0, (10, "edge"): 2.0, (5, "sharded_edge"): 1.5,
            (10, "sharded_edge"): 1.0}

    def measure_fn(delta, strat, cap, policy, reps):
        slow = 5.0 if (rank == 1 and (delta, strat) == (10, "sharded_edge")) \
            else 0.0
        return base[(delta, strat)] + slow + 0.01 * rank

    return measure_fn


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    data = np.load(inputs)
    graphs = {name: (coo_from_numpy(data[f"{name}_src"], data[f"{name}_dst"],
                                    data[f"{name}_w"],
                                    int(data[f"{name}_n"])),
                     int(data[f"{name}_delta"])) for name in GRAPHS}
    got = {"default_strategies": ",".join(default_strategies())}
    sw, delta = graphs["smallworld"]
    got["fingerprint"] = fingerprint(graph_stats(sw), "cpu")

    def plan(g, **kw):
        return Engine(g, DeltaConfig(**kw), device="cpu").plan()

    for name, (g, dl) in graphs.items():
        for st in STRATEGIES:
            for pm in PRED_MODES:
                p = plan(g, delta=dl, strategy=st, pred_mode=pm)
                got[f"solve/{name}/{st}/{pm}"] = run_fields(
                    p.solve(SingleSource(0)))
                got[f"explain/{name}/{st}/{pm}"] = str(p.explain())
    for st in STRATEGIES:
        got[f"multi/{st}"] = run_fields(
            plan(sw, delta=delta, strategy=st).solve(
                MultiSource(list(MULTI_SOURCES))))
        got[f"rho/{st}"] = run_fields(
            plan(sw, delta=delta, strategy=st, policy="rho").solve(
                SingleSource(0)))
    p = plan(sw, delta=delta, strategy="sharded_ell")
    p.solve(SingleSource(0))
    got["update/sharded_ell"] = run_fields(p.solve(UpdateBatch(
        data["update_ids"], data["update_w"])))
    got["capped/sharded_ell"] = run_fields(
        plan(sw, strategy="sharded_ell", **CAPPED).solve(SingleSource(0)))
    fb = Engine(sw, DeltaConfig(strategy="sharded_ell", **CAPPED),
                device="cpu").plan(fallback=True)
    got["capped_fallback/sharded_ell"] = run_fields(fb.solve(SingleSource(0)))
    got["capped_fallback/taken"] = bool(fb.explain()["fallback_taken"])
    got["capped_full/sharded_ell"] = run_fields(
        plan(sw, strategy="sharded_ell", delta=CAPPED["delta"]).solve(
            SingleSource(0)))

    # the mesh helpers over this group
    for shape in BAD_MESHES:
        try:
            make_host_mesh(*shape)
            got[f"mesh_error/{shape}"] = "no error"
        except ValueError as e:
            got[f"mesh_error/{shape}"] = str(e)
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod)
            got[f"production_error/{multi_pod}"] = "no error"
        except ValueError as e:
            got[f"production_error/{multi_pod}"] = str(e)

    # the distributed engine on the R-MAT graph (n a multiple of every
    # model width: the reference's engine needs that) and, with padded
    # shards, on the small-world graph, on make_host_mesh's meshes
    for shape in MESHES:
        mesh = make_host_mesh(*shape)
        got[f"mesh/{shape[0]}x{shape[1]}"] = {
            "name": mesh_name(mesh), "dims": ",".join(mesh.mesh_dim_names),
            "device_type": mesh.device_type,
            "ranks": mesh.mesh.to(torch.int64)}
        for name, steps in (("rmat", LOCAL_STEPS), ("smallworld", (1,))):
            g, dl = graphs[name]
            part = partition_edges(g, shape[1])
            for combine in COMBINES:
                for ls in steps:
                    solve = build_distributed_solver(
                        part, mesh, DistDeltaConfig(
                            delta=dl, combine=combine, local_steps=ls),
                        device="cpu")
                    d, outer, inner = solve(list(DIST_SOURCES))
                    got[f"dist/{name}/{shape[0]}x{shape[1]}/{combine}/{ls}"] \
                        = {"dist": d, "outer": outer, "inner": inner}

    axes = dict(deltas=TUNE_DELTAS, strategies=("edge", "sharded_edge"),
                policies=("delta",), device="cpu")
    got["tune/injected"] = tune(sw, measure_fn=injected_time(rank),
                                **axes).to_json()
    rec = tune(sw, **axes).to_json()
    got["tune/measured"] = rec
    dist.destroy_process_group()
    torch.save(got, out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
