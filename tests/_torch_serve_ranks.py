"""One rank of the 4-rank gloo group of ``tests/test_torch_serve_sharded.py``.

    python tests/_torch_serve_ranks.py RANK WORLD STORE INPUTS OUT

Joins the group (``file://STORE``), loads the two tenant graphs and the
update batch from ``INPUTS`` (an ``.npz`` the test wrote from the JAX
package's generators) and runs the port's ``Server`` as one SPMD
program: rank 0 submits and serves inline, the other ranks follow its
batch plan. Cases: ``STREAM`` under each sharded strategy; the
background loop with an idle pause past the control channel's
timeout, every ticket held to a serial solve; ``plan()`` from a second
thread beside the loop; ``plan()`` and ``close(drain=False)`` after one
batch; ``submit``/``pump``/``plan`` on
the other ranks. Saves
rank 0's tickets (flattened by ``flat``) and every rank's ``stats()``
to ``OUT`` (pickle). Imports no JAX. Every collective times out after
``COLLECTIVE_TIMEOUT``, so a hang fails fast.
"""
import dataclasses
import datetime
import pickle
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.serve.server as server_mod  # noqa: E402
from repro_torch.api import (  # noqa: E402
    BoundedRadius,
    Engine,
    MultiSource,
    PointToPoint,
    SingleSource,
    UpdateBatch,
)
from repro_torch.core import DeltaConfig  # noqa: E402
from repro_torch.graphs import coo_from_numpy  # noqa: E402
from repro_torch.serve import Server  # noqa: E402

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
CONTROL_TIMEOUT = datetime.timedelta(seconds=0.5)   # the channel's, here
STRATEGIES = ("sharded_edge", "sharded_ell", "sharded_fused")
LANE, RESIDENT, DELTA = 3, 1, 10
# (tenant, query kind, arguments, deadline): lane kinds, a solo
# MultiSource (three sources: the lanes' shape), a 16-edge update, an
# expired deadline, a source out of range (shed at submit) and a
# MultiSource out of range (a ValueError of plan.solve on every rank),
# over two tenants under max_resident=1 (evictions and a rebuild)
STREAM = (
    ("a", "SingleSource", (0,), None),
    ("a", "PointToPoint", (5, 77), None),
    ("a", "BoundedRadius", (9, 30), None),
    ("b", "SingleSource", (3,), None),
    ("a", "MultiSource", ([0, 42, 100],), None),
    ("a", "UpdateBatch", None, None),
    ("a", "SingleSource", (0,), None),
    ("a", "SingleSource", (7,), 0.5),
    ("a", "SingleSource", (10**6,), None),
    ("a", "MultiSource", ([0, 10**6, 1],), None),
    ("b", "PointToPoint", (3, 50), None),
    ("b", "SingleSource", (11,), None),
)
# the background loop's requests, before and after the idle pause
IDLE = ((("a", "SingleSource", (4,), None), ("a", "PointToPoint", (4, 90),
                                             None)),
        (("a", "BoundedRadius", (4, 25), None),
         ("a", "MultiSource", ([1, 2, 3],), None)))
IDLE_PAUSE_S = 2.0
RACE_PLANS, RACE_REQUESTS = 8, 6
KINDS = {"SingleSource": SingleSource, "PointToPoint": PointToPoint,
         "BoundedRadius": BoundedRadius, "MultiSource": MultiSource}


def queries(stream, kinds, update):
    """``(tenant, query, deadline)`` from a stream spec; ``kinds`` maps a
    kind name to its query class, ``update`` is the update batch."""
    return [(name, update if kind == "UpdateBatch" else kinds[kind](*args),
             deadline) for name, kind, args, deadline in stream]


def flat(x):
    """A result or stats value as plain Python and numpy values."""
    if dataclasses.is_dataclass(x):
        return {"type": type(x).__name__, **{
            f.name: flat(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, (list, tuple)):
        return [flat(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    a = np.asarray(x)
    return a.item() if a.ndim == 0 else a


def ticket_record(t):
    exc = t.exception(0)
    out = {"trace": dataclasses.asdict(t.trace)}
    if exc is None:
        out["result"] = flat(t.result(0))
    else:
        out["error"] = (type(exc).__name__, getattr(exc, "reason", None))
    return out


def stream_case(rank, graphs, cfg, update):
    """``STREAM`` inline on a constant clock: every request submitted at
    0, served at 1.0 (the deadline of 0.5 has expired)."""
    now = [0.0]
    srv = Server(graphs, config=cfg, lane_width=LANE, max_resident=RESIDENT,
                 clock=lambda: now[0], device="cpu")
    tickets = []
    if rank == 0:
        for name, q, deadline in queries(STREAM, KINDS, update):
            tickets.append(srv.submit(q, graph=name, deadline=deadline))
        now[0] = 1.0
    srv.drain()
    srv.close()
    return [ticket_record(t) for t in tickets], srv.stats()


def idle_case(rank, graphs, cfg):
    """The background loop on rank 0 with a pause of ``IDLE_PAUSE_S``
    (four of the channel's timeouts) between two groups of requests;
    then every rank solves the same queries serially on a fresh plan."""
    got = []
    with Server(graphs, config=cfg, lane_width=LANE, device="cpu") as srv:
        for k, group in enumerate(IDLE if rank == 0 else ()):
            if k:
                time.sleep(IDLE_PAUSE_S)    # the other ranks wait on
            ts = [srv.submit(q, graph=name)     # the channel meanwhile
                  for name, q, _ in queries(group, KINDS, None)]
            got += [t.result(timeout=120) for t in ts]
    stats = srv.stats()
    plan = Engine(graphs["a"], cfg, device="cpu").plan(fallback=True)
    serial = [plan.solve(q) for group in IDLE
              for _, q, _ in queries(group, KINDS, None)]
    return {"served": [flat(r) for r in got],
            "serial": [flat(r) for r in serial], "stats": stats}


def race_case(rank, graphs, cfg):
    """Rank 0's background loop serves tenant ``a`` while a second
    thread calls ``plan()`` on both tenants in turn (``max_resident=1``:
    each call can evict), with a short switch interval; every step must
    reach the other ranks in the order rank 0 ran it."""
    srv = Server(graphs, config=cfg, lane_width=LANE, max_resident=1,
                 device="cpu")
    with srv:
        if rank == 0:
            interval = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                planner = threading.Thread(target=lambda: [
                    srv.plan("ab"[k % 2]) for k in range(RACE_PLANS)])
                planner.start()
                ts = [srv.submit(SingleSource(s), graph="a")
                      for s in range(RACE_REQUESTS)]
                for t in ts:
                    t.result(timeout=120)
                planner.join(timeout=120)
                assert not planner.is_alive(), "plan() calls did not end"
            finally:
                sys.setswitchinterval(interval)
    return srv.stats()


def close_case(rank, graphs, cfg):
    """Rank 0 builds tenant ``b``'s plan (``plan()``), serves one batch
    of ``a``, queues two more requests and closes without draining; the
    other ranks first try the front end's calls."""
    srv = Server(graphs, config=cfg, lane_width=LANE, device="cpu")
    out = {}
    if rank == 0:
        srv.plan("b")
        first = [srv.submit(SingleSource(s), graph="a") for s in (1, 2)]
        srv.pump()
        rest = [srv.submit(SingleSource(s), graph="a") for s in (3, 4)]
        srv.close(drain=False)
        out["tickets"] = [ticket_record(t) for t in first + rest]
    else:
        for what, call in (("submit", lambda: srv.submit(SingleSource(0),
                                                          graph="a")),
                           ("pump", srv.pump), ("plan", lambda: srv.plan("a"))):
            try:
                call()
                out[what] = "no error"
            except RuntimeError as e:
                out[what] = str(e)
        srv.close()
    out["stats"] = srv.stats()
    return out


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    server_mod._CONTROL_TIMEOUT = CONTROL_TIMEOUT
    data = np.load(inputs)
    graphs = {name: coo_from_numpy(data[f"{name}_src"], data[f"{name}_dst"],
                                   data[f"{name}_w"], int(data[f"{name}_n"]))
              for name in ("a", "b")}
    update = UpdateBatch(data["update_ids"], data["update_w"])
    got = {}
    for st in STRATEGIES:
        cfg = DeltaConfig(delta=DELTA, strategy=st, pred_mode="argmin")
        got[f"stream/{st}"] = stream_case(rank, graphs, cfg, update)
    cfg = DeltaConfig(delta=DELTA, strategy="sharded_edge")
    got["idle"] = idle_case(rank, graphs, cfg)
    got["race"] = race_case(rank, graphs, cfg)
    got["close"] = close_case(rank, graphs, cfg)
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
