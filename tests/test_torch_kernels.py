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
from repro_torch.kernels.bucket_scan.bucket_scan import (scan_range,
                                                         scan_vector_path)
from repro_torch.kernels.ell_relax import ell_relax, ell_relax_ref
from repro_torch.kernels.ell_relax.ell_relax import relax_layout
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


def _full_range_case(seed, n=4000):
    """tent/explored over the whole int32 range: INF, INF - 1, negatives,
    small values around 0 and ``t == e``."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
    e = rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
    t[rng.random(n) < 0.1] = INF
    t[rng.random(n) < 0.05] = INF - 1
    e[rng.random(n) < 0.3] = INF
    small = rng.random(n) < 0.3
    t[small] = rng.integers(-60, 60, size=int(small.sum()))
    same = rng.random(n) < 0.1
    e[same] = t[same]
    return t.astype(np.int32), e.astype(np.int32)


def _range_rule(tent, explored, bucket_i, delta):
    """The CUDA kernel's arithmetic on the CPU: the frontier is ``lo <= t
    < hi & t < e`` and the next bucket ``floor(min t / delta)`` over ``t
    >= hi & t < e``, with ``[lo, hi)`` from the launcher's
    ``scan_range``."""
    lo, hi = scan_range(bucket_i, delta)
    t, e = tent.astype(np.int64), explored.astype(np.int64)
    frontier = (t >= lo) & (t < hi) & (t < e)
    cand = t[(t >= hi) & (t < e)]
    nxt = int(cand.min()) // delta if cand.size else 2**31 - 1
    return frontier, frontier.any(), np.int32(nxt)


@pytest.mark.parametrize("delta", [1, 7, 2**30])
@pytest.mark.parametrize("bucket", [-3, 0, 1, 5, "past_int32"])
def test_bucket_scan_range_rule_matches_twin(bucket, delta):
    """The identities the CUDA kernel rests on, over the whole int32
    range of ``tent``: the range rule gives the twin's frontier, flag and
    next bucket bitwise, for negative buckets and for the last bucket,
    whose ``(i + 1) * delta`` is past int32."""
    i = INF // delta if bucket == "past_int32" else bucket
    if bucket == "past_int32":
        assert (i + 1) * delta > INF
    t, e = _full_range_case(delta % 1000 + 17 * (i % 97))
    twin = bucket_scan_ref(torch.from_numpy(t), torch.from_numpy(e), i,
                           delta=delta)
    _eq(twin, _range_rule(t, e, i, delta), f"i={i} delta={delta}")


@pytest.mark.parametrize("bucket_i,delta", [(-3, 7), (INF // 7, 7)])
def test_bucket_scan_range_rule_matches_jax_reference(bucket_i, delta):
    t, e = _full_range_case(bucket_i % 1000)
    _eq([torch.from_numpy(np.asarray(x))
         for x in _range_rule(t, e, bucket_i, delta)],
        j_bucket_scan_ref(jnp.asarray(t), jnp.asarray(e), bucket_i,
                          delta=delta), "jax ref")


def test_scan_range_clamps_and_refuses():
    assert scan_range(3, 10) == (30, 40)
    assert scan_range(-3, 10) == (-30, -20)
    assert scan_range(INF, 1) == (INF, INF)            # (i + 1) past int32
    assert scan_range(-2**31, 2) == (-2**31, -2**31)   # i * delta below it
    assert scan_range(2**40, 3) == (INF, INF)
    for bad in (0, -1, 2**31):
        with pytest.raises(ValueError):
            scan_range(0, bad)


def test_scan_vector_path_needs_aligned_inputs():
    buf = torch.zeros(64, dtype=torch.int32)
    flags = torch.zeros(64, dtype=torch.bool)
    assert buf.data_ptr() % 16 == 0
    assert scan_vector_path(buf, buf, flags)
    assert scan_vector_path(buf[4:], buf[8:], flags[4:])
    assert not scan_vector_path(buf[1:], buf, flags)
    assert not scan_vector_path(buf, buf[3:], flags)
    assert not scan_vector_path(buf, buf, flags[1:])


# ----------------------------------------------------------------- ell_relax
def _walk(cap, units, batch, split_log2, q, rem):
    """The kernel's walk over the output units of every chunk of 32
    rows, on the host: each of a chunk's ``2**split_log2`` warps starts
    its lanes at unit ``32 * part + lane`` and advances their (row,
    unit) by ``(q, rem)`` per step. Asserts each lane's (row, unit) is
    ``divmod(p, units)`` of its output unit ``p`` and returns how often
    each unit was written."""
    split = 1 << split_log2
    step = 32 * split
    counts = {}
    for row0 in range(0, cap, 32):
        total = min(cap - row0, 32) * units
        for part in range(split):
            for lane in range(32):
                r, k = divmod(32 * part + lane, units)
                for base in range(32 * part, total, step * batch):
                    for s in range(batch):
                        p = base + s * step + lane
                        if p < total:
                            assert (r, k) == divmod(p, units)
                            key = row0 * units + p
                            counts[key] = counts.get(key, 0) + 1
                        k, r = k + rem, r + q
                        if k >= units:
                            k, r = k - units, r + 1
    return counts


@pytest.mark.parametrize("width", [0, 1, 3, 4, 19, 24, 28, 33, 64])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("cap", [37, 4096, 200_000])
def test_relax_layout_walk_covers_each_output_once(width, offset, cap):
    """The launcher's ``(vec, units, batch, split_log2, q, rem)``: the
    vector walk exactly where ``D % 4 == 0`` and ``w_ell`` starts 16-byte
    aligned; batches of 4 steps where a chunk takes 4 or more; warps
    split a chunk only while the chunks are too few to fill the card;
    and the kernel's stepping writes every output unit exactly once, at
    its own (row, unit)."""
    flat = torch.zeros(8 * width + offset, dtype=torch.int32)
    w_ell = flat[offset:].view(8, width)       # offset 1: 4 bytes past 16
    vec, units, batch, split_log2, q, rem = relax_layout(w_ell, cap)
    aligned = w_ell.data_ptr() % 16 == 0
    assert vec == int(width > 0 and width % 4 == 0 and aligned)
    assert units == (width // 4 if vec else width)
    if units == 0:
        return
    assert batch == (4 if units >= 4 else 1)
    chunks = -(-cap // 32)
    split = 1 << split_log2
    assert split == 1 or (chunks * split // 2 < 132 * 32
                          and batch * split // 2 < units)
    assert q * units + rem == 32 * split and 0 <= rem < units
    if cap <= 4096:
        counts = _walk(cap, units, batch, split_log2, q, rem)
        assert sorted(counts) == list(range(cap * units))
        assert set(counts.values()) == {1}
    else:                      # enough chunks to fill the card
        assert split == 1


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
