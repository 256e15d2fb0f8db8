"""Traffic and instances are functions of the seed; rotations give every
seed the same mix."""
import itertools
import json

import numpy as np
import pytest
import torch

from pbcore import traffic
from pbcore.spec import HERE, Spec

CPU = torch.device("cpu")


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _gen(name):
    return Spec().generator(name)


def _map(side=200, seed=5):
    return _gen("grid_map").make(
        {"height": side, "width": side, "obstacle_frac": 0.1,
         "straight_cost": 10, "diag_cost": 14}, seed, CPU)


def _take(it, k):
    return list(itertools.islice(it, k))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_smallworld_instance_is_a_function_of_the_seed(seed):
    p = {"n": 500, "k": 20, "p": 0.01, "w_lo": 1, "w_hi": 20}
    a, b = _gen("watts_strogatz").make(p, seed, CPU), \
        _gen("watts_strogatz").make(p, seed, CPU)
    assert torch.equal(a.src, b.src) and torch.equal(a.w, b.w)
    other = _gen("watts_strogatz").make(p, seed + 1, CPU)
    assert not (torch.equal(a.dst, other.dst) and torch.equal(a.w, other.w))
    # both directions with one weight, no self loop, weights in U{1..20}
    half = a.m // 2
    assert torch.equal(a.src[:half], a.dst[half:])
    assert torch.equal(a.w[:half], a.w[half:])
    assert bool((a.src != a.dst).all())
    assert int(a.w.min()) >= 1 and int(a.w.max()) <= 20
    assert a.src.dtype == a.dst.dtype == a.w.dtype == torch.int32


def test_grid_instance_is_the_8_neighbour_graph_of_its_mask():
    inst = _map(37)
    free = inst.free.numpy()
    h, w = free.shape
    edges = set(zip(inst.src.tolist(), inst.dst.tolist(), inst.w.tolist()))
    want = set()
    for r, c in itertools.product(range(h), range(w)):
        for dr, dc in itertools.product((-1, 0, 1), repeat=2):
            r2, c2 = r + dr, c + dc
            if (dr or dc) and 0 <= r2 < h and 0 <= c2 < w and free[r, c] \
                    and free[r2, c2]:
                want.add((r * w + c, r2 * w + c2, 14 if dr and dc else 10))
    assert edges == want and len(edges) == inst.m
    assert torch.equal(inst.free, _map(37).free)


@pytest.mark.parametrize("name", ["sssp-uniform", "sssp-anchor-strata",
                                  "p2p-octile-bands"])
def test_streams_are_functions_of_the_seed(name):
    inst = _map(400)
    free = inst.free.numpy()
    mix = _mix(name)
    if "bands" in mix:
        mix["bands"] = [[300, 500], [1500, 1700], [3000, 3200]]
    a = _take(traffic.stream(mix, inst.n, free, 3, traffic.WINDOW), 20)
    b = _take(traffic.stream(mix, inst.n, free, 3, traffic.WINDOW), 20)
    c = _take(traffic.stream(mix, inst.n, free, 4, traffic.WINDOW), 20)
    w = _take(traffic.stream(mix, inst.n, free, 3, traffic.WARMUP), 20)
    assert a == b and a != c and a != w
    for q in a:
        assert free.ravel()[q.source]
        assert q.target is None or free.ravel()[q.target]


def test_anchor_strata_rotate_in_a_fixed_order():
    inst = _map(600)
    free = inst.free.numpy()
    mix = _mix("sssp-anchor-strata")
    k = len(mix["anchors"])
    for seed in (1, 99):
        qs = _take(traffic.stream(mix, inst.n, free, seed, traffic.WINDOW),
                   2 * k)
        for i, q in enumerate(qs):
            fr, fc = mix["anchors"][i % k]
            r, c = divmod(q.source, 600)
            half = mix["box"] // 2
            assert abs(r - min(max(round(fr * 599), half), 599 - half)) \
                <= half
            assert abs(c - min(max(round(fc * 599), half), 599 - half)) \
                <= half


def test_octile_bands_rotate_in_a_fixed_order():
    inst = _map(500)
    free = inst.free.numpy()
    mix = _mix("p2p-octile-bands")
    mix["bands"] = [[200, 400], [2000, 2300], [4500, 4800]]
    qs = _take(traffic.stream(mix, inst.n, free, 8, traffic.WINDOW), 12)
    for i, q in enumerate(qs):
        lo, hi = mix["bands"][i % 3]
        (r0, c0), (r1, c1) = divmod(q.source, 500), divmod(q.target, 500)
        d = int(traffic.octile(np.int64(r1 - r0), np.int64(c1 - c0), 10, 14))
        assert lo <= d < hi and q.mode == "early_exit"


def test_uniform_sources_cover_the_vertices_of_a_graph():
    qs = _take(traffic.stream(_mix("sssp-uniform"), 1000, None, 5,
                              traffic.WINDOW), 2000)
    src = np.array([q.source for q in qs])
    assert src.min() >= 0 and src.max() < 1000 and len(set(src)) > 800
