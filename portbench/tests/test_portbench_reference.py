"""The plain reference agrees with the port's CPU twins at a tiny size,
and the control (the reference put in the program's place, one
relaxation round short of its answer) fails the comparison."""
import json

import pytest
import torch

from pbcore import check, traffic
from pbcore.spec import HERE, Spec
from repro_torch.api import Engine, PointToPoint, SingleSource
from repro_torch.core import DeltaConfig
from repro_torch.graphs.structures import COOGraph

CPU = torch.device("cpu")
SPEC = Spec()
COO_BF = SPEC.reference("coo_bellman_ford")
GRID_BF = SPEC.reference("grid_bellman_ford")
TREE = SPEC.tree()
INF = 2**31 - 1


def _smallworld(seed=3, n=2000):
    return SPEC.generator("watts_strogatz").make(
        {"n": n, "k": 20, "p": 0.01, "w_lo": 1, "w_hi": 20}, seed, CPU)


def _map(seed=4, side=48):
    return SPEC.generator("grid_map").make(
        {"height": side, "width": side, "obstacle_frac": 0.1,
         "straight_cost": 10, "diag_cost": 14}, seed, CPU)


def _plan(inst, **solver):
    return Engine(COOGraph(inst.src, inst.dst, inst.w, inst.n),
                  DeltaConfig(**solver), free_mask=inst.free,
                  device=CPU).plan()


def _solver(config):
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in json.loads((HERE / "configs" / f"{config}.json")
                                   .read_text())["solver"].items()}


@pytest.mark.parametrize("source", [0, 777, 1999])
def test_smallworld_reference_equals_the_fused_twin(source):
    inst = _smallworld()
    res = _plan(inst, **_solver("smallworld-1m-k20-fused")).solve(
        SingleSource(source))
    ref = COO_BF.solve(inst, source)
    assert torch.equal(res.dist, ref.dist)
    assert torch.equal(res.pred, TREE.argmin_pred(inst, ref.dist, source))
    assert ref.rounds > 3


@pytest.mark.parametrize("source", [0, 1150, 48 * 48 - 1])
def test_grid_reference_equals_the_stencil_twin_and_the_coo(source):
    inst = _map()
    if not bool(inst.free.reshape(-1)[source]):
        source = int(torch.nonzero(inst.free.reshape(-1))[0])
    res = _plan(inst, **_solver("gamemap-3000-grid")).solve(
        SingleSource(source))
    grid = GRID_BF.solve(inst, source)
    coo = COO_BF.solve(inst, source)
    assert torch.equal(grid.dist, coo.dist)
    assert torch.equal(res.dist, grid.dist)
    assert torch.equal(res.pred, TREE.argmin_pred(inst, grid.dist, source))
    assert int((grid.dist == INF).sum()) >= int((~inst.free).sum())


def test_point_to_point_paths_are_checked_as_shortest():
    inst = _map(side=64)
    plan = _plan(inst, **_solver("gamemap-3000-grid"))
    mix = SPEC.traffic("p2p-octile-bands")
    mix["bands"] = [[100, 200], [400, 500], [700, 800]]
    qs = traffic.stream(mix, inst.n, inst.free.numpy(), 2, traffic.WINDOW)
    table = TREE.EdgeTable(inst)
    for _ in range(3):
        q = next(qs)
        r = plan.solve(PointToPoint(q.source, q.target, mode=q.mode))
        d = int(GRID_BF.solve(inst, q.source).dist[q.target])
        assert r.distance == d
        assert TREE.path_is_shortest(table, r.path, q.source, q.target, d)
        bent = list(r.path)
        bent[len(bent) // 2] = bent[len(bent) // 2] + 1
        assert not TREE.path_is_shortest(table, bent, q.source, q.target, d)
        assert not TREE.path_is_shortest(table, r.path[:-1], q.source,
                                         q.target, d)


def _control_sssp(solver, inst, source):
    """The reference in the program's place, one round short."""
    full = solver.solve(inst, source)
    short = solver.solve(inst, source, max_rounds=full.rounds - 1).dist
    return short, TREE.argmin_pred(inst, short, source)


@pytest.mark.parametrize("which", ["smallworld", "map"])
def test_the_control_fails_the_comparison(which):
    inst, solver = ((_smallworld(), COO_BF) if which == "smallworld"
                    else (_map(), GRID_BF))
    src = int(torch.nonzero(inst.free.reshape(-1))[0]) if inst.free is not \
        None else 5
    q = traffic.Query("single_source", src)
    sound = check.compare("single_source", solver, TREE, inst,
                          [(q, *_control_sssp(solver, inst, src))])
    assert sound["dist_wrong"] > 0 and not check.verdict(sound)
    exact = solver.solve(inst, src).dist
    ok = check.compare("single_source", solver, TREE, inst,
                       [(q, exact, TREE.argmin_pred(inst, exact, src))])
    assert check.verdict(ok) and ok == {"dist_wrong": 0, "pred_wrong": 0}


def test_the_point_to_point_control_fails_the_comparison():
    inst = _map(side=64)
    mix = SPEC.traffic("p2p-octile-bands")
    mix["bands"] = [[400, 500]]
    q = next(traffic.stream(mix, inst.n, inst.free.numpy(), 6,
                            traffic.WINDOW))
    full = GRID_BF.solve(inst, q.source, track=True)
    settled = int(full.changed_at[q.target])
    short = GRID_BF.solve(inst, q.source, max_rounds=settled - 1).dist
    got = check.compare("point_to_point", GRID_BF, TREE, inst,
                        [(q, int(short[q.target]), None)])
    assert got["distance_gap"] > 0 and not check.verdict(got)
