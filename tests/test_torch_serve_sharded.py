"""Sharded serving: the port's ``Server`` in a 4-rank gloo group against
the JAX package's ``Server`` on 4 host devices (P = 4), on the CPU.

One SPMD program per rank (``tests/_torch_serve_ranks.py``, no JAX):
rank 0 submits ``STREAM`` (lane kinds, a solo ``MultiSource``, a 16-edge
update, an expired deadline on an injected clock, two invalid requests,
two tenants under ``max_resident=1``) and serves inline; the other ranks
run its batch plan through the control channel. Under ``sharded_edge``,
``sharded_ell`` and ``sharded_fused`` rank 0's tickets must equal the
reference's bitwise (dist, pred, telemetry, distance, path, the typed
rejections and the request traces) and its ``stats()`` must equal the
reference's, latencies excepted; every other rank's batch and tenancy
counts must equal rank 0's. Further cases of the same group: the
background loop across an idle pause of four control-channel timeouts
(every ticket equal to a serial solve), ``plan()`` calls from a second
thread beside the loop, ``plan()`` and ``close(drain=False)`` on rank
0, and the front end's calls on the other ranks. Beside the group: the serving
launcher under ``torchrun`` with two gloo ranks, against its one-rank
run. The group, the JAX process (``tests/_jax_serve_p4.py``) and the
launchers start once per test session (``_torch_fixtures.SpawnedGroup``);
every process has a hard time limit, and every collective a 60 s
timeout. Tolerance: none.
"""
import pickle
import re
from pathlib import Path

import numpy as np
import pytest

import _torch_serve_ranks as ranks
from _torch_fixtures import SpawnedGroup, fresh_caches_one_thread, spawn
from repro.graphs import generators as jgen

HERE = Path(__file__).resolve().parent
WORLD = 4
LIMIT_S = 300                # each spawned process's hard time limit
LAUNCH = ["-m", "repro_torch.launch.serve", "--sssp", "--device", "cpu",
          "--nodes", "400", "--degree", "6", "--requests", "6", "--batch",
          "3", "--strategy", "sharded_edge"]
TENANT_KEYS = ("batches", "mean_occupancy", "resident", "plans_built",
               "evictions")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _write_inputs(path: Path) -> None:
    """Tenant ``a``: a 256-vertex small world; ``b``: a 225-vertex
    weighted lattice (its last shard padded at P = 4); 16 of ``a``'s
    edges re-weighted."""
    arrays = {}
    for name, g in (("a", jgen.watts_strogatz(256, 6, 0.05, seed=3)),
                    ("b", jgen.square_lattice(15, seed=1, weighted=True))):
        arrays.update({f"{name}_src": np.asarray(g.src),
                       f"{name}_dst": np.asarray(g.dst),
                       f"{name}_w": np.asarray(g.w), f"{name}_n": g.n_nodes})
        if name == "a":
            rng = np.random.default_rng(6)
            ids = rng.choice(g.n_edges, size=16, replace=False)
            arrays["update_ids"] = ids.astype(np.int64)
            arrays["update_w"] = np.clip(
                np.asarray(g.w)[ids] + rng.integers(-5, 6, 16), 1, 20
            ).astype(np.int32)
    np.savez(path, **arrays)


def _start(root: Path):
    inputs = root / "inputs.npz"
    _write_inputs(inputs)
    procs = [spawn(HERE / "_torch_serve_ranks.py", r, WORLD, root / "store",
                   inputs, root / f"rank{r}.pkl") for r in range(WORLD)]
    procs.append(spawn(HERE / "_jax_serve_p4.py", inputs,
                       root / "jax_p4.pkl"))
    procs.append(spawn("-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", "2", *LAUNCH, "--shards", "2",
                       log=root / "launch2.log"))
    procs.append(spawn(*LAUNCH, log=root / "launch1.log"))
    return procs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    grp = SpawnedGroup(tmp_path_factory, "torch_serve_sharded_group",
                       _start, LIMIT_S)
    try:
        yield grp.wait()
    finally:
        grp.close()


@pytest.fixture(scope="module")
def group(root):
    def load(name):
        with open(root / name, "rb") as f:   # written by the processes
            return pickle.load(f)              # this module started
    return [load(f"rank{r}.pkl") for r in range(WORLD)], load("jax_p4.pkl")


def _same(a, b, tag):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), (tag, a, b)
        for k in b:
            _same(a[k], b[k], f"{tag}/{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), tag
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{tag}[{k}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), tag
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=tag)
    else:
        assert type(a) is type(b) and a == b, (tag, a, b)


def _no_latency(stats):
    return {k: v for k, v in stats.items() if not k.startswith("latency")}


@pytest.mark.parametrize("strategy", ranks.STRATEGIES)
def test_stream_tickets_bitwise_equal_reference(group, strategy):
    got, ref = group
    ours, theirs = got[0][f"stream/{strategy}"][0], ref[f"stream/{strategy}"][0]
    assert len(ours) == len(theirs) == len(ranks.STREAM)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        _same(a, b, f"{strategy} request {k} {ranks.STREAM[k][:3]}")
    # the stream took every path it was written for
    errors = [t.get("error") for t in ours]
    assert errors.count(("RequestRejected", "deadline")) == 1
    assert errors.count(("RequestRejected", "invalid")) == 1
    assert errors.count(("ValueError", None)) == 1
    kinds = [t["result"]["type"] for t in ours if "result" in t]
    assert {"SingleSourceResult", "PointToPointResult", "BoundedRadiusResult",
            "MultiSourceResult", "UpdateApplied"} <= set(kinds)
    assert any(t["result"].get("path") for t in ours if "result" in t)


@pytest.mark.parametrize("strategy", ranks.STRATEGIES)
def test_stream_stats_equal_reference_on_every_rank(group, strategy):
    got, ref = group
    stats = got[0][f"stream/{strategy}"][1]
    _same(_no_latency(stats), _no_latency(ref[f"stream/{strategy}"][1]),
          f"{strategy} stats")
    assert stats["evictions"] >= 2 and stats["plans_built"] >= 3
    assert stats["batches"]["update"] == 1 and stats["batches"]["solo"] == 2
    for r in range(1, WORLD):
        other = got[r][f"stream/{strategy}"][1]
        for key in TENANT_KEYS:
            assert other[key] == stats[key], (r, key)
        assert (other["submitted"], other["completed"], other["shed"],
                other["queued"]) == (0, 0, {}, 0), r


def test_idle_pause_past_control_timeout_answers_as_serial(group):
    got, _ = group
    assert ranks.IDLE_PAUSE_S >= 4 * ranks.CONTROL_TIMEOUT.total_seconds()
    idle = got[0]["idle"]
    qs = [q for part in ranks.IDLE for q in part]
    assert len(idle["served"]) == len(idle["serial"]) == len(qs)
    for (_, kind, args, _), a, b in zip(qs, idle["served"], idle["serial"]):
        if kind == "PointToPoint":
            # a lane settles every vertex, the serial early exit does not:
            # the same distance, and a path between the two ends
            assert a["distance"] == b["distance"], args
            assert a["path"][0] == args[0] and a["path"][-1] == args[1]
        elif kind == "BoundedRadius":
            # the serial solve stops at the radius (fewer buckets)
            _same(a["dist"], b["dist"], f"{kind}{args}")
            _same(a["pred"], b["pred"], f"{kind}{args}")
        else:
            _same(a, b, f"{kind}{args}")
    stats = idle["stats"]
    assert stats["completed"] == len(qs) and stats["shed"] == {}
    for r in range(1, WORLD):
        for key in TENANT_KEYS:
            assert got[r]["idle"]["stats"][key] == stats[key], (r, key)


def test_plan_calls_beside_the_loop_keep_one_order_on_every_rank(group):
    got, _ = group
    stats = got[0]["race"]
    assert stats["completed"] == ranks.RACE_REQUESTS
    assert stats["evictions"] > 0
    for r in range(1, WORLD):
        for key in TENANT_KEYS:
            assert got[r]["race"][key] == stats[key], (r, key)


def test_plan_and_close_without_drain_follow_rank0_on_every_rank(group):
    got, _ = group
    close = got[0]["close"]
    tickets = close["tickets"]
    assert [t["result"]["type"] for t in tickets[:2]] == [
        "SingleSourceResult"] * 2
    assert [t.get("error") for t in tickets[2:]] == [
        ("RequestRejected", "closed")] * 2
    assert close["stats"]["shed"] == {"closed": 2}
    assert close["stats"]["batches"] == {"lanes": 1, "solo": 0, "update": 0}
    # plan("b") on rank 0 built b's plan on every rank, before a's batch
    assert close["stats"]["resident"] == ["a", "b"]
    assert close["stats"]["plans_built"] == 2
    for r in range(1, WORLD):
        for key in TENANT_KEYS:
            assert got[r]["close"]["stats"][key] == close["stats"][key]


def test_front_end_calls_raise_on_other_ranks(group):
    got, _ = group
    for r in range(1, WORLD):
        for what in ("submit", "pump", "plan"):
            msg = got[r]["close"][what]
            assert msg.startswith(f"{what}() on rank {r}:"), msg
            assert "rank 0 is the server's front end" in msg


def test_launcher_two_gloo_ranks_print_one_rank_counts(root):
    two = (root / "launch2.log").read_text()
    one = (root / "launch1.log").read_text()
    assert two.count("[serve] mesh-sharded relaxation over 2 rank(s)") == 1
    assert "[serve] mesh-sharded relaxation over 1 rank(s)" in one
    pattern = r"\[serve\] answered (\d+) SSSP queries \((\d+) with paths\)"
    counts = re.findall(pattern, two)
    assert len(counts) == 1                      # rank 0 alone prints
    assert counts == re.findall(pattern, one) == [("6", "3")]
