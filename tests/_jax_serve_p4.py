"""The JAX package's ``Server`` on the stream of
``tests/_torch_serve_ranks.py``, on a host mesh of 4 forced CPU devices
(``tests/test_torch_serve_sharded.py``).

    python tests/_jax_serve_p4.py INPUTS OUT

Reads the tenant graphs and the update batch from ``INPUTS`` and saves
to ``OUT`` (pickle), for each sharded strategy at ``n_shards=4``, every
ticket (flattened as the ranks flatten theirs) and ``stats()``. The
device count must be forced before JAX initialises, hence a process of
its own.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import (  # noqa: E402
    BoundedRadius,
    MultiSource,
    PointToPoint,
    SingleSource,
    UpdateBatch,
)
from repro.core import DeltaConfig  # noqa: E402
from repro.graphs.structures import COOGraph  # noqa: E402
from repro.serve import Server  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_serve_ranks import (  # noqa: E402
    DELTA,
    LANE,
    RESIDENT,
    STRATEGIES,
    STREAM,
    queries,
    ticket_record,
)

KINDS = {"SingleSource": SingleSource, "PointToPoint": PointToPoint,
         "BoundedRadius": BoundedRadius, "MultiSource": MultiSource}


def main(inputs: str, out: str) -> None:
    data = np.load(inputs)
    graphs = {name: COOGraph(jnp.asarray(data[f"{name}_src"]),
                             jnp.asarray(data[f"{name}_dst"]),
                             jnp.asarray(data[f"{name}_w"]),
                             int(data[f"{name}_n"])) for name in ("a", "b")}
    update = UpdateBatch(data["update_ids"], data["update_w"])
    got = {}
    for st in STRATEGIES:
        now = [0.0]
        srv = Server(graphs, config=DeltaConfig(
            delta=DELTA, strategy=st, pred_mode="argmin", n_shards=4),
            lane_width=LANE, max_resident=RESIDENT, clock=lambda: now[0])
        tickets = [srv.submit(q, graph=name, deadline=deadline)
                   for name, q, deadline in queries(STREAM, KINDS, update)]
        now[0] = 1.0
        srv.drain()
        got[f"stream/{st}"] = ([ticket_record(t) for t in tickets],
                               srv.stats())
    with open(out, "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
