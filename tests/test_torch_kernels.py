"""The port's kernel twins against the reference kernels on the CPU.

Each plain PyTorch twin (``repro_torch.kernels.*.ref``, which is what
the ops dispatchers run on CPU tensors) is held bitwise against the JAX
Pallas kernel run as ``tests/test_kernels.py`` runs it
(``backend="pallas", interpret=True``) and against the JAX ``ref``, on
the same numpy inputs from fixed seeds. Cases cover INF entries, the
sentinel ``fidx``, ``cap`` below the frontier population, a zero-width
ELL block and lengths that are not a multiple of 1024. The CUDA kernels
themselves are compared with the twins on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import generators as jgen
from repro.graphs import structures as jst
from repro.kernels.bucket_scan import bucket_scan as j_bucket_scan
from repro.kernels.bucket_scan import bucket_scan_ref as j_bucket_scan_ref
from repro.kernels.ell_relax import ell_relax as j_ell_relax
from repro.kernels.ell_relax import ell_relax_ref as j_ell_relax_ref
from repro.kernels.frontier_relax import frontier_relax as j_frontier_relax
from repro.kernels.frontier_relax import (
    frontier_relax_ref as j_frontier_relax_ref,
)
from repro_torch.kernels.bucket_scan import bucket_scan, bucket_scan_ref
from repro_torch.kernels.ell_relax import ell_relax, ell_relax_ref
from repro_torch.kernels.frontier_relax import (
    compact_ref,
    frontier_relax,
    frontier_relax_ref,
)

INF = int(jst.INF32)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    # leave no compiled executables behind for the modules that follow
    jax.clear_caches()
    yield
    jax.clear_caches()


def _tent(rng, n, frac_inf=0.3, hi=400):
    t = rng.integers(0, hi, size=n).astype(np.int32)
    return np.where(rng.random(n) < frac_inf, INF, t).astype(np.int32)


def _eq(torch_out, jax_out, tag=""):
    assert len(torch_out) == len(jax_out), tag
    for k, (t, j) in enumerate(zip(torch_out, jax_out)):
        j = np.asarray(j)
        t = t.numpy()
        assert t.shape == j.shape, (tag, k, t.shape, j.shape)
        if j.dtype == np.bool_:
            assert t.dtype == np.bool_, (tag, k)
        else:
            assert t.dtype == np.int32 and j.dtype == np.int32, (tag, k)
        np.testing.assert_array_equal(t, j, err_msg=f"{tag} output {k}")


# --------------------------------------------------------------- bucket_scan
@pytest.mark.parametrize("n", [5, 64, 1030])
@pytest.mark.parametrize("delta", [1, 10, 64])
@pytest.mark.parametrize("seed", [0])
def test_bucket_scan_twin_matches_reference(n, delta, seed):
    rng = np.random.default_rng(seed * 100003 + n * 7 + delta)
    tent = _tent(rng, n)
    explored = _tent(rng, n)
    t_t, e_t = torch.from_numpy(tent), torch.from_numpy(explored)
    for i in [0, 2, 9]:
        twin = bucket_scan_ref(t_t, e_t, i, delta=delta)
        _eq(bucket_scan(t_t, e_t, i, delta=delta), twin, "dispatch")
        _eq(twin, j_bucket_scan_ref(jnp.asarray(tent), jnp.asarray(explored),
                                    i, delta=delta), "jax ref")
        if n <= 64 and i == 2:   # interpret-mode Pallas: small, one i
            _eq(twin, j_bucket_scan(jnp.asarray(tent), jnp.asarray(explored),
                                    i, delta=delta, backend="pallas",
                                    interpret=True), "jax pallas")


def test_bucket_scan_all_inf():
    n = 37
    allinf = np.full(n, INF, np.int32)
    t = torch.from_numpy(allinf)
    f, any_, nxt = bucket_scan(t, t, 0, delta=5)
    assert not bool(f.any()) and not bool(any_) and int(nxt) == 2**31 - 1
    _eq((f, any_, nxt), j_bucket_scan(jnp.asarray(allinf), jnp.asarray(allinf),
                                      0, delta=5, backend="pallas",
                                      interpret=True))


# ----------------------------------------------------------------- ell_relax
@pytest.mark.parametrize("n,deg,cap", [(16, 4, 8), (64, 7, 64), (33, 1, 16),
                                       (60, 16, 40)])
@pytest.mark.parametrize("backend", ["pallas", "pallas_row"])
def test_ell_relax_twin_matches_reference(n, deg, cap, backend):
    rng = np.random.default_rng(n * 1000 + deg)
    g = jgen.random_graph(n, n * deg, seed=int(rng.integers(2**31)))
    ell = jst.csr_to_ell(jst.coo_to_csr(g))
    dist = _tent(rng, n)
    fidx = np.full(cap, n, np.int32)                 # sentinel padding slots
    k = int(rng.integers(1, cap + 1))
    fidx[:k] = rng.choice(n, size=k, replace=False)
    w_ell = np.array(ell.w)
    # the JAX package has two kernel entries (blocked, row gather); the
    # port has one kernel, held against each
    out = ell_relax(torch.from_numpy(fidx), torch.from_numpy(dist),
                    torch.from_numpy(w_ell))
    ref = j_ell_relax_ref(jnp.asarray(fidx), jnp.asarray(dist), ell.w)
    pal = j_ell_relax(jnp.asarray(fidx), jnp.asarray(dist), ell.w,
                      backend=backend, interpret=True)
    _eq([out], [ref], "jax ref")
    _eq([out], [pal], "jax pallas")
    _eq([ell_relax_ref(torch.from_numpy(fidx), torch.from_numpy(dist),
                       torch.from_numpy(w_ell))], [ref], "twin")


def test_ell_relax_all_sentinel_and_all_inf():
    n, cap = 20, 12
    g = jgen.random_graph(n, 80, seed=4)
    ell = jst.csr_to_ell(jst.coo_to_csr(g))
    w_ell = torch.from_numpy(np.array(ell.w))
    fidx = torch.full((cap,), n, dtype=torch.int32)
    dist = torch.full((n,), INF, dtype=torch.int32)
    out = ell_relax(fidx, torch.zeros(n, dtype=torch.int32), w_ell)
    assert bool((out == INF).all())
    out = ell_relax(torch.arange(cap, dtype=torch.int32), dist, w_ell)
    assert bool((out == INF).all())


# ------------------------------------------------------------ frontier_relax
def _fr_case(seed, s, deg, d_zero=False):
    rng = np.random.default_rng(seed)
    if d_zero:
        nbr = np.full((s + 1, 0), s, np.int32)
        w = np.full((s + 1, 0), INF, np.int32)
    else:
        g = jgen.random_graph(s, s * deg, seed=seed)
        ell = jst.csr_to_ell(jst.coo_to_csr(g))
        nbr, w = np.array(ell.nbr), np.array(ell.w)
    dist = _tent(rng, s, hi=60)
    explored = _tent(rng, s, hi=60)
    return dist, explored, nbr, w


@pytest.mark.parametrize("s,deg", [(5, 3), (48, 4)])
@pytest.mark.parametrize("cap_frac", [1.0, 0.25])
@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_relax_twin_matches_reference(s, deg, cap_frac, seed):
    dist, explored, nbr, w = _fr_case(seed * 31 + s, s, deg)
    cap = max(1, int(s * cap_frac))          # small caps overflow
    base, sent = (0, s) if seed == 0 else (100, 1000)
    tt = [torch.from_numpy(a) for a in (dist, explored, nbr, w)]
    jj = [jnp.asarray(a) for a in (dist, explored, nbr, w)]
    for i in [0, 3]:
        kw = dict(delta=7, cap=cap, base=base, sent=sent)
        out = frontier_relax(tt[0], tt[1], i, tt[2], tt[3], **kw)
        _eq(out, j_frontier_relax_ref(jj[0], jj[1], i, jj[2], jj[3], **kw),
            "jax ref")
        if i == 3:          # interpret-mode Pallas: one bucket per case
            _eq(out, j_frontier_relax(jj[0], jj[1], i, jj[2], jj[3],
                                      backend="pallas", interpret=True,
                                      **kw), "jax pallas")
        _eq(out, frontier_relax_ref(tt[0], tt[1], i, tt[2], tt[3], **kw),
            "twin")


@pytest.mark.parametrize("s", [7, 1030])
def test_frontier_relax_zero_width_block(s):
    dist, explored, nbr, w = _fr_case(5, s, 2, d_zero=True)
    tt = [torch.from_numpy(a) for a in (dist, explored, nbr, w)]
    jj = [jnp.asarray(a) for a in (dist, explored, nbr, w)]
    kw = dict(delta=7, cap=s // 2 + 1)
    out = frontier_relax(tt[0], tt[1], 0, tt[2], tt[3], **kw)
    assert out[1].shape == (s // 2 + 1, 0)
    _eq(out, j_frontier_relax(jj[0], jj[1], 0, jj[2], jj[3],
                              backend="pallas", **kw), "jax D=0 route")


def test_frontier_relax_all_inf_and_large_ragged():
    s = 1030                                    # not a multiple of 1024
    dist, explored, nbr, w = _fr_case(9, s, 3)
    tt = [torch.from_numpy(a) for a in (dist, explored, nbr, w)]
    jj = [jnp.asarray(a) for a in (dist, explored, nbr, w)]
    for cap in (s, 17):
        _eq(frontier_relax(tt[0], tt[1], 1, tt[2], tt[3], delta=7, cap=cap),
            j_frontier_relax_ref(jj[0], jj[1], 1, jj[2], jj[3], delta=7,
                                 cap=cap), f"cap={cap}")
    allinf = torch.full((s,), INF, dtype=torch.int32)
    fidx, rows_n, rows_w, count, any_, nxt = frontier_relax(
        allinf, allinf, 0, tt[2], tt[3], delta=7, cap=64)
    assert int(count) == 0 and not bool(any_) and int(nxt) == 2**31 - 1
    assert bool((fidx == s).all()) and bool((rows_n == s).all())
    assert bool((rows_w == INF).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap", [1, 9, 40, 64])
def test_compaction_equals_jnp_nonzero(seed, cap):
    rng = np.random.default_rng(seed)
    mask = rng.random(40) < 0.4
    ours = compact_ref(torch.from_numpy(mask), cap, 40)
    ref = jnp.nonzero(jnp.asarray(mask), size=cap, fill_value=40)[0]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref, np.int32))


@pytest.mark.parametrize("d_zero", [True, False])
def test_dispatchers_run_twins_on_cpu_tensors(d_zero):
    """A CPU tensor goes to the twin, by its device alone: no kernel
    launch is counted, the zero-width ELL block included."""
    from repro_torch.kernels.bucket_scan import bucket_scan_cuda
    from repro_torch.kernels.ell_relax import ell_relax_cuda
    from repro_torch.kernels.frontier_relax import frontier_relax_cuda
    s = 40
    dist, explored, nbr, w = _fr_case(11, s, 3, d_zero=d_zero)
    tt = [torch.from_numpy(a) for a in (dist, explored, nbr, w)]
    counters = (bucket_scan_cuda, ell_relax_cuda, frontier_relax_cuda)
    before = [fn.launches for fn in counters]
    fidx = torch.arange(8, dtype=torch.int32)
    _eq(bucket_scan(tt[0], tt[1], 2, delta=7),
        [np.asarray(x) for x in bucket_scan_ref(tt[0], tt[1], 2, delta=7)])
    _eq([ell_relax(fidx, tt[0], tt[3])],
        [ell_relax_ref(fidx, tt[0], tt[3]).numpy()])
    _eq(frontier_relax(tt[0], tt[1], 2, tt[2], tt[3], delta=7, cap=9),
        [np.asarray(x) for x in frontier_relax_ref(tt[0], tt[1], 2, tt[2],
                                                   tt[3], delta=7, cap=9)])
    assert [fn.launches for fn in counters] == before
