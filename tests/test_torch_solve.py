"""The port's cold single-source solve against the JAX package.

``repro_torch.api.Engine(g, cfg, device="cpu")`` (the kernels' plain
twins) and ``repro.api.Engine(g, cfg)`` (Pallas kernels in interpret
mode, x64 for packed words) solve the same instances from fixed seeds:
``dist``, ``pred``, ``buckets``, ``inner_iters`` and ``overflow`` must be
bitwise equal for every strategy × pred mode × Δ on the adversarial COO
construction of the differential suite (zero weights on odd seeds, self
loops, duplicate edges, a disconnected tail), and for every strategy ×
pred mode at Δ = 7 on one small Watts–Strogatz and one small R-MAT
graph. Each case compiles its own JAX program, so the Δ axis is swept on
the one instance that carries every adversarial feature.
"""
import contextlib

import jax
import numpy as np
import pytest

from repro.api import Engine as JEngine
from repro.api import SingleSource as JSingleSource
from repro.compat import enable_x64
from repro.core import DeltaConfig as JDeltaConfig
from repro.graphs import generators as jgen
from repro.graphs.structures import COOGraph as JCOOGraph
from repro_torch.api import Engine, SingleSource
from repro_torch.core import DeltaConfig, dijkstra
from repro_torch.graphs import coo_from_numpy

STRATEGIES = ("edge", "ell", "pallas", "fused")
PRED_MODES = ("none", "argmin", "packed")
DELTAS = (1, 7, 31)
N, M = 32, 96


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    # leave no compiled executables behind for the modules that follow
    jax.clear_caches()
    yield
    jax.clear_caches()


def adversarial_coo(seed: int):
    """Copy of ``tests/test_differential.py::adversarial_coo``: edges
    confined to the first ``k`` vertices (the rest are disconnected), a
    forced self-loop, a forced duplicate edge pair with independent
    weights, and zero-weight edges on odd seeds."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, N + 1))
    src = rng.integers(0, k, size=M).astype(np.int64)
    dst = rng.integers(0, k, size=M).astype(np.int64)
    w_lo = int(seed % 2)
    w = rng.integers(w_lo, 21, size=M).astype(np.int64)
    src[0] = dst[0] = int(rng.integers(0, k))
    src[1], dst[1] = src[2], dst[2]
    w[1] = int(rng.integers(w_lo, 21))
    g = JCOOGraph(src=src.astype(np.int32), dst=dst.astype(np.int32),
                  w=w.astype(np.int32), n_nodes=N)
    return g, int(rng.integers(0, k))


def _graph(name):
    if name == "adversarial":    # odd seed: zero-weight edges as well
        return adversarial_coo(7)
    if name == "watts_strogatz":
        return jgen.watts_strogatz(48, 4, 0.2, seed=3), 5
    assert name == "rmat"
    return jgen.rmat(40, 200, seed=2), 0


# the adversarial instance carries the self loop, the duplicate pair,
# the disconnected tail and zero weights (the non-canonical packed
# regime); the two generator graphs have weights >= 1 (the canonical
# word-order regime), and R-MAT keeps duplicate edges
GRAPHS = ("adversarial", "watts_strogatz", "rmat")
CASES = [("adversarial", d) for d in DELTAS] + [
    ("watts_strogatz", 7), ("rmat", 7)]


def _jax_solve(jg, source, strategy, pred_mode, delta, cap=None):
    cfg = JDeltaConfig(delta=delta, strategy=strategy, pred_mode=pred_mode,
                       interpret=True, frontier_cap=cap)
    ctx = enable_x64() if pred_mode == "packed" else contextlib.nullcontext()
    with ctx:
        r = JEngine(jg, cfg).plan().solve(JSingleSource(source))
        t = r.telemetry
        return (np.asarray(r.dist), np.asarray(r.pred), int(t.buckets),
                int(t.inner_iters), bool(t.overflow))


def _torch_solve(jg, source, strategy, pred_mode, delta, cap=None):
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    cfg = DeltaConfig(delta=delta, strategy=strategy, pred_mode=pred_mode,
                      frontier_cap=cap)
    r = Engine(g, cfg, device="cpu").plan().solve(SingleSource(source))
    t = r.telemetry
    return (r.dist.numpy(), r.pred.numpy(), int(t.buckets),
            int(t.inner_iters), bool(t.overflow))


def _assert_same(ours, ref, tag):
    for name, a, b in zip(("dist", "pred", "buckets", "inner_iters",
                           "overflow"), ours, ref):
        if isinstance(a, np.ndarray):
            assert a.dtype == np.int32 and b.dtype == np.int32, (tag, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {name}")
        else:
            assert a == b, (tag, name, a, b)


@pytest.mark.parametrize("pred_mode", PRED_MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("graph,delta", CASES)
def test_solve_bitwise_equals_reference(graph, delta, strategy, pred_mode):
    jg, source = _graph(graph)
    dref, _ = dijkstra(coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                                      np.asarray(jg.w), jg.n_nodes), source)
    tag = (graph, strategy, pred_mode, delta)
    ours = _torch_solve(jg, source, strategy, pred_mode, delta)
    _assert_same(ours, _jax_solve(jg, source, strategy, pred_mode, delta),
                 tag)
    np.testing.assert_array_equal(ours[0].astype(np.int64), dref,
                                  err_msg=str(tag))


@pytest.mark.parametrize("strategy", ["ell", "pallas", "fused"])
def test_capped_frontier_overflows_like_reference(strategy):
    jg = jgen.watts_strogatz(48, 6, 0.3, seed=1)
    ours = _torch_solve(jg, 0, strategy, "argmin", 31, cap=3)
    ref = _jax_solve(jg, 0, strategy, "argmin", 31, cap=3)
    assert ours[4] and ref[4]                      # both overflowed
    _assert_same(ours, ref, ("capped", strategy))
