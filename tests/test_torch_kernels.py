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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
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
from repro_torch.kernels.frontier_relax.frontier_relax import (
    GATHER_MAX_BLOCKS,
    PAD_MAX_BLOCKS,
    PAD_STEPS,
    SCAN_MAX_BLOCKS,
    SUB,
    THREADS,
    TILE,
    gather_layout,
    n_tiles,
    scratch_ints,
    vector_path,
)

INF = int(jst.INF32)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


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


@pytest.mark.parametrize("s,tiles", [(0, 1), (1, 1), (5, 1), (1023, 1),
                                     (1024, 1), (1025, 2), (70_001, 69),
                                     (1_000_003, 977), (2**31 - 1, 2**21)])
def test_frontier_relax_tiles_and_scratch(s, tiles):
    """A tile per 1024 vertices (one for S = 0); the scratch holds the
    ticket (and 3 unused ints), a minimum per scan block, the tile
    populations and offsets, each rounded up to 4 so that every region
    starts 16-byte aligned, and per tile 4 sub-tile populations and 32
    ballot words."""
    assert TILE == 1024 and TILE // SUB == 4 and n_tiles(s) == tiles
    padded = -(-tiles // 4) * 4
    assert (4 + SCAN_MAX_BLOCKS) % 4 == 0 and padded % 4 == 0
    assert scratch_ints(s) == 4 + SCAN_MAX_BLOCKS + 2 * padded \
        + (4 + TILE // 32) * tiles


@pytest.mark.parametrize("s,cap,d", [(1, 1, 0), (5, 5, 3), (1025, 64, 19),
                                     (1_000_000, 1_000_000, 19),
                                     (1_000_000, 4096, 19),
                                     (1_000_000, 64, 4),
                                     (120_000, 262_144, 24),
                                     (70_001, 70_001, 33),
                                     (1_000_003, 1_000_003, 1),
                                     (1000, 1_953_000, 1100)])
def test_frontier_relax_gather_layout(s, cap, d):
    """The scan takes a block per tile up to 4 per SM; the gather a
    block per sub-tile of 256 vertices up to 4 per SM; the padding
    blocks cover the most padding a call can have (``cap`` ids and
    ``cap * D / 4`` 16-byte units per block) at ``PAD_STEPS`` units a
    thread, no block more than needed, at most 2 per SM; a frontier row
    is owned by the least power-of-two group of lanes >= min(D, 32)."""
    tiles, scan_blocks, gather_blocks, pad_blocks, group_log2 = \
        gather_layout(s, cap, d)
    assert tiles == n_tiles(s)
    assert scan_blocks == min(tiles, SCAN_MAX_BLOCKS) and scan_blocks >= 1
    assert SUB == 256 and GATHER_MAX_BLOCKS == 132 * 4
    assert PAD_MAX_BLOCKS == 132 * 2
    assert gather_blocks == min(tiles * TILE // SUB, GATHER_MAX_BLOCKS)
    units = max(cap, cap * d // 4)
    per_block = THREADS * PAD_STEPS
    assert 1 <= pad_blocks <= PAD_MAX_BLOCKS
    assert pad_blocks == PAD_MAX_BLOCKS or pad_blocks * per_block >= units
    assert pad_blocks == 1 or (pad_blocks - 1) * per_block < units
    g = 1 << group_log2
    assert g <= 32 and g >= min(d, 32) and (g == 1 or g // 2 < min(d, 32))


def test_frontier_relax_vector_path_needs_aligned_inputs():
    buf = torch.zeros(64, dtype=torch.int32)
    assert buf.data_ptr() % 16 == 0
    assert vector_path(buf, buf) and vector_path(buf[4:], buf[8:])
    assert not vector_path(buf[1:], buf)
    assert not vector_path(buf, buf[3:])


def _pad_walk(filled, cap, d, pad_blocks):
    """The padding blocks' walk over the words ``[filled * D, cap * D)``
    of a ``[cap, D]`` output, on the host: thread ``t`` of ``T`` takes
    the 16-byte units ``qa + t, qa + t + T, ...`` below ``qb``, starting
    at column ``4 * q % D`` and advancing it by ``4 * T % D`` per step;
    threads 0-3 of the first block take the words before unit ``qa``,
    4-7 those from unit ``qb`` on. Asserts each unit's column is its
    first word's and returns how often each word is written."""
    T = pad_blocks * THREADS
    wlo, whi = filled * d, cap * d
    counts = {}
    if wlo >= whi:
        return counts
    qa, qb = (wlo + 3) >> 2, whi >> 2
    dk = 4 * T % d
    for t in range(min(T, max(0, qb - qa))):
        q = qa + t
        k = 4 * q % d
        while q < qb:
            assert k == 4 * q % d
            for w in range(4 * q, 4 * q + 4):
                counts[w] = counts.get(w, 0) + 1
            q, k = q + T, k + dk
            if k >= d:
                k -= d
    for tid in range(8):
        if tid < 4:
            w, mine = wlo + tid, wlo + tid < min(4 * qa, whi)
        else:
            w = 4 * qb + tid - 4
            mine = qa <= qb and w < whi
        if mine:
            counts[w] = counts.get(w, 0) + 1
    return counts


@pytest.mark.parametrize("d", [1, 3, 4, 19, 24, 33, 1100])
@pytest.mark.parametrize("filled,cap", [(0, 1), (0, 37), (5, 37), (37, 37),
                                        (1, 600), (599, 600), (234, 600)])
def test_frontier_relax_padding_covers_each_word_once(d, filled, cap):
    """The padding split of the gather kernel: the 16-byte units and
    the head and tail words together write every padding word exactly
    once and no frontier word, at the launcher's padding grid."""
    pad_blocks = gather_layout(cap, cap, d)[3]
    counts = _pad_walk(filled, cap, d, pad_blocks)
    assert sorted(counts) == list(range(filled * d, cap * d))
    assert set(counts.values()) <= {1}


def _frontier_rule(dist, explored, bucket_i, nbr, w, *, delta, cap, base,
                   sent):
    """The two CUDA kernels' arithmetic on the host. Flags by the range
    rule (``lo <= t < hi & t < e`` with ``[lo, hi)`` from
    ``scan_range``), packed into ballot words of 32; tile populations
    and their exclusive scan; a flag's slot is its tile's offset plus
    the popcounts below it in its tile (a gather sub-tile's first slot
    is its tile's offset plus the popcounts of the tile's words before
    it); slots from ``min(count, cap)``
    on hold ``sent`` and row S; ``next`` is ``floor(min t / delta)``
    over ``t >= hi & t < e``."""
    lo, hi = scan_range(bucket_i, delta)
    s = dist.shape[0]
    t, e = dist.astype(np.int64), explored.astype(np.int64)
    flags = (t < e) & (t >= lo) & (t < hi)
    tiles = n_tiles(s)
    bits = np.zeros(tiles * TILE, np.int64)
    bits[:s] = flags
    words = (bits.reshape(-1, 32) << np.arange(32)).sum(1)
    word_pop = np.array([bin(int(x)).count("1") for x in words])
    tile_pop = word_pop.reshape(tiles, TILE // 32).sum(1)
    tile_off = np.cumsum(tile_pop) - tile_pop
    fidx = np.full(cap, sent, np.int64)
    rows_n = np.broadcast_to(nbr[s], (cap, nbr.shape[1])).copy()
    rows_w = np.broadcast_to(w[s], (cap, w.shape[1])).copy()
    for v in np.flatnonzero(flags):
        tile, word, bit = v // TILE, v // 32, v % 32
        below = int(word_pop[tile * (TILE // 32):word].sum())
        below += bin(int(words[word]) & ((1 << bit) - 1)).count("1")
        slot = int(tile_off[tile]) + below
        if slot < cap:
            fidx[slot] = v + base
            rows_n[slot], rows_w[slot] = nbr[v], w[v]
    cand = t[(t < e) & (t >= hi)]
    nxt = int(cand.min()) // delta if cand.size else 2**31 - 1
    count = int(flags.sum())
    return (fidx.astype(np.int32), rows_n, rows_w, np.int32(count),
            np.bool_(count > 0), np.int32(nxt))


def _fr_full_range(seed, s=2500, d=3):
    t, e = _full_range_case(seed, s)
    rng = np.random.default_rng(seed + 1)
    nbr = rng.integers(-2**31, 2**31, size=(s + 1, d),
                       dtype=np.int64).astype(np.int32)
    w = rng.integers(-2**31, 2**31, size=(s + 1, d),
                     dtype=np.int64).astype(np.int32)
    return t, e, nbr, w


@pytest.mark.parametrize("delta", [1, 7, 2**30])
@pytest.mark.parametrize("bucket", [-3, 0, 5, "past_int32"])
def test_frontier_relax_range_rule_matches_twin(bucket, delta):
    """The identities the CUDA kernels rest on, over the whole int32
    range of ``dist`` (INF, INF - 1, negatives, ``t == e``): the range
    rule with the ballot-word compaction gives the twin's six outputs
    bitwise, for negative buckets and for the last bucket, whose ``(i +
    1) * delta`` is past int32; caps below, at and above the
    population, ``base``/``sent`` of a shard, an arbitrary row S."""
    i = INF // delta if bucket == "past_int32" else bucket
    if bucket == "past_int32":
        assert (i + 1) * delta > INF
    t, e, nbr, w = _fr_full_range(delta % 1000 + 17 * (i % 97))
    tt = [torch.from_numpy(a) for a in (t, e, nbr, w)]
    pop = int(frontier_relax_ref(*tt[:2], i, *tt[2:], delta=delta,
                                 cap=1)[3])
    for cap, base, sent in ((1, 0, t.shape[0]), (max(pop, 1), 0, 2500),
                            (pop + 40, 7000, 99), (2500, 1 << 20, 123)):
        kw = dict(delta=delta, cap=cap, base=base, sent=sent)
        _eq(frontier_relax_ref(*tt[:2], i, *tt[2:], **kw),
            _frontier_rule(t, e, i, nbr, w, **kw), f"i={i} {kw}")


@pytest.mark.parametrize("bucket_i,delta", [(-3, 7), (INF // 7, 7)])
def test_frontier_relax_range_rule_matches_jax_reference(bucket_i, delta):
    t, e, nbr, w = _fr_full_range(bucket_i % 1000)
    kw = dict(delta=delta, cap=300, base=5, sent=2500)
    _eq([torch.from_numpy(np.asarray(x))
         for x in _frontier_rule(t, e, bucket_i, nbr, w, **kw)],
        j_frontier_relax_ref(jnp.asarray(t), jnp.asarray(e), bucket_i,
                             jnp.asarray(nbr), jnp.asarray(w), **kw),
        "jax ref")


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
