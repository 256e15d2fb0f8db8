"""The JAX package's answers that depend on the shard count, on a host
mesh of 4 forced CPU devices (``tests/test_torch_sharded.py``).

    python tests/_jax_sharded_p4.py INPUTS OUT

Reads the graphs from ``INPUTS`` (the ``.npz`` the test wrote) and
saves to ``OUT`` (``.npz``): ``sharded_ell`` on the small-world graph
with a per-shard cap that overflows at ``n_shards=4``, and the
distributed engine on the R-MAT graph on the ``(1, 4)`` and ``(2, 2)``
meshes under both combines and ``local_steps`` 1 and 2. The device count must be forced before JAX
initialises, hence a process of its own.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Engine, SingleSource  # noqa: E402
from repro.core import DeltaConfig  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    DistDeltaConfig,
    build_distributed_solver,
)
from repro.graphs import partition_edges  # noqa: E402
from repro.graphs.structures import COOGraph  # noqa: E402

# the rank program's constants (tests/_torch_sharded_ranks.py)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_sharded_ranks import (  # noqa: E402
    CAPPED,
    COMBINES,
    DIST_SOURCES,
    LOCAL_STEPS,
    MESHES,
)


def main(inputs: str, out: str) -> None:
    data = np.load(inputs)

    def graph(name):
        return COOGraph(jnp.asarray(data[f"{name}_src"]),
                        jnp.asarray(data[f"{name}_dst"]),
                        jnp.asarray(data[f"{name}_w"]),
                        int(data[f"{name}_n"])), int(data[f"{name}_delta"])

    g, _ = graph("smallworld")
    got = {}
    r = Engine(g, DeltaConfig(strategy="sharded_ell", n_shards=4,
                              **CAPPED)).plan().solve(SingleSource(0))
    t = r.telemetry
    got["capped/dist"], got["capped/pred"] = np.asarray(r.dist), \
        np.asarray(r.pred)
    got["capped/counters"] = np.array(
        [int(t.buckets), int(t.inner_iters), int(bool(t.overflow))])
    g, delta = graph("rmat")
    for shape in MESHES:
        mesh = jax.make_mesh(shape, ("data", "model"))
        part = partition_edges(g, shape[1])
        for combine in COMBINES:
            for ls in LOCAL_STEPS:
                solve = build_distributed_solver(
                    part, mesh, DistDeltaConfig(delta=delta, combine=combine,
                                                local_steps=ls))
                d, outer, inner = solve(np.asarray(DIST_SOURCES, np.int32))
                key = f"dist/rmat/{shape[0]}x{shape[1]}/{combine}/{ls}"
                got[f"{key}/dist"] = np.asarray(d)
                got[f"{key}/counters"] = np.array([int(outer), int(inner)])
    np.savez(out, **got)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
