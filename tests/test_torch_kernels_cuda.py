"""Hand-written CUDA kernels of ``repro_torch`` against their plain
PyTorch twins, on the card: every output bitwise equal. Marked ``cuda``;
each test decides inside its fixture whether a card is present and
skips where there is none. Imports torch and numpy only, so it runs on
the GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.graphs import coo_to_csr, csr_to_ell, random_graph
from repro_torch.kernels.bucket_scan import bucket_scan_cuda, bucket_scan_ref
from repro_torch.kernels.bucket_scan.bucket_scan import scan_vector_path
from repro_torch.kernels.ell_relax import ell_relax_cuda, ell_relax_ref
from repro_torch.kernels.ell_relax.ell_relax import relax_layout
from repro_torch.kernels.frontier_relax import (
    frontier_relax_cuda,
    frontier_relax_ref,
)
from repro_torch.kernels.frontier_relax.frontier_relax import (
    vector_path as fr_vector_path,
)
from repro_torch.kernels.grid_relax import (grid_relax_cuda, grid_relax_ref,
                                            vector_path)

INF = 2**31 - 1
SEEDS = (0, 1, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tent(rng, n, frac_inf=0.3, hi=400):
    t = rng.integers(0, hi, size=n).astype(np.int32)
    return np.where(rng.random(n) < frac_inf, INF, t).astype(np.int32)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 1000, 1024, 4097, 300_001])
@pytest.mark.parametrize("seed", SEEDS)
def test_bucket_scan_kernel_matches_twin(cuda, n, seed):
    rng = np.random.default_rng(seed * 7919 + n)
    tent = torch.from_numpy(_tent(rng, n)).to(cuda)
    explored = torch.from_numpy(_tent(rng, n)).to(cuda)
    for delta in (1, 10, 64):
        for i in (0, 2, 9):
            out = bucket_scan_cuda(tent, explored, i, delta=delta)
            torch.cuda.synchronize()
            _equal(out, bucket_scan_ref(tent, explored, i, delta=delta))
    allinf = torch.full((n,), INF, dtype=torch.int32, device=cuda)
    _equal(bucket_scan_cuda(allinf, allinf, 0, delta=3),
           bucket_scan_ref(allinf, allinf, 0, delta=3))


def _full_range(rng, n):
    """int32 tent/explored over the whole range: INF, INF - 1, negatives,
    small values around 0 and ``t == e``."""
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


def _scan_twin(tent, explored, i, delta):
    """The twin's answer; (empty, False, IMAX) for n = 0, where the
    twin's min has nothing to reduce."""
    if tent.shape[0] == 0:
        return (torch.zeros(0, dtype=torch.bool), torch.tensor(False),
                torch.tensor(INF, dtype=torch.int32))
    return bucket_scan_ref(tent, explored, i, delta=delta)


def _buckets(delta):
    """Negative, small and huge int32 buckets: the last one's ``(i + 1) *
    delta`` and the one past it are beyond int32, the first's ``i *
    delta`` below it."""
    return [i for i in (-3, 0, 1, 5, INF // delta, INF // delta + 1,
                        -(2**31) // delta, -(2**31) // delta - 1)
            if -2**31 <= i <= INF]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 4097, 1_000_003])
def test_bucket_scan_kernel_full_int32_range(cuda, n):
    """Every int32 ``tent`` (negative included) and every int32 bucket,
    on the vector path (aligned) and the scalar one (a view 4 bytes past
    16-byte alignment, and inputs of different alignment)."""
    rng = np.random.default_rng(n)
    t, e = _full_range(rng, n + 1)
    tent = torch.from_numpy(t).to(cuda)
    explored = torch.from_numpy(e).to(cuda)
    views = [(tent[:n], explored[:n]), (tent[1:], explored[1:]),
             (tent[:n], explored[1:])]
    flags = torch.empty(n, dtype=torch.bool, device=cuda)
    assert scan_vector_path(*views[0], flags)
    if n:
        assert not scan_vector_path(*views[1], flags)
        assert not scan_vector_path(*views[2], flags)
    for tt, ee in views:
        for delta in (1, 7, 2**30):
            for i in _buckets(delta):
                out = bucket_scan_cuda(tt, ee, i, delta=delta)
                torch.cuda.synchronize()
                _equal(out, _scan_twin(tt, ee, i, delta))


@pytest.mark.cuda
def test_bucket_scan_back_to_back_sizes_and_streams(cuda):
    """Launches of different sizes queued back to back on one stream, and
    interleaved on two streams, each equal to the twin: the kernel's
    cross-block ticket is reset by every launch and is not shared by two
    streams."""
    rng = np.random.default_rng(11)
    sizes = (1_000_003, 5, 300_001, 0, 4096, 2_000_000, 1)
    cases = []
    for n in sizes:
        t, e = _full_range(rng, n)
        cases.append((torch.from_numpy(t).to(cuda),
                      torch.from_numpy(e).to(cuda), int(rng.integers(-3, 9)),
                      int(rng.choice([1, 7, 64]))))
    outs = [bucket_scan_cuda(t, e, i, delta=d) for t, e, i, d in cases]
    torch.cuda.synchronize()
    for (t, e, i, d), out in zip(cases, outs):
        _equal(out, _scan_twin(t, e, i, d))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for rep in range(4):
        for k, (t, e, i, d) in enumerate(cases):
            with torch.cuda.stream(streams[(k + rep) % 2]):
                outs.append(bucket_scan_cuda(t, e, i, delta=d))
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        t, e, i, d = cases[k % len(cases)]
        _equal(out, _scan_twin(t, e, i, d))


def _device_ops(fn):
    """Names of the device operations (kernels, copies, fills) of one
    call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# each wrapper's own device kernels: a call runs these and nothing else
OWN_KERNELS = {"bucket_scan": ("bucket_scan_kernel",),
               "ell_relax": ("ell_relax_kernel",),
               "frontier_relax": ("frontier_scan_kernel",
                                  "frontier_gather_kernel")}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bucket_scan", "ell_relax",
                                    "frontier_relax"])
def test_one_call_is_one_device_kernel(cuda, kernel):
    """A call of the wrapper runs only its own kernels, one device
    operation for ``bucket_scan`` and ``ell_relax``, at most two for
    ``frontier_relax``: no fill before them and no compare after them.
    The profiler may lose records of so short a window, so the call is
    profiled until a profile holds the first kernel's record, and every
    profile that holds it must hold nothing else."""
    rng = np.random.default_rng(3)
    n = 1_000_000
    tent = torch.from_numpy(_tent(rng, n)).to(cuda)
    explored = torch.from_numpy(_tent(rng, n)).to(cuda)
    w = torch.from_numpy(rng.integers(1, 20, size=(n + 1, 19))
                         .astype(np.int32)).to(cuda)
    w[n] = INF
    nbr = torch.from_numpy(rng.integers(0, n, size=(n + 1, 19))
                           .astype(np.int32)).to(cuda)
    nbr[n] = n
    fidx = torch.full((n,), n, dtype=torch.int32, device=cuda)
    fidx[:1000] = torch.arange(1000, dtype=torch.int32, device=cuda)
    call = {"bucket_scan": lambda: bucket_scan_cuda(tent, explored, 2,
                                                    delta=7),
            "ell_relax": lambda: ell_relax_cuda(fidx, tent, w),
            "frontier_relax": lambda: frontier_relax_cuda(
                tent, explored, 2, nbr, w, delta=7, cap=4096)}[kernel]
    own = OWN_KERNELS[kernel]
    call()                    # warm-up: the build and the scratch
    torch.cuda.synchronize()
    kept = 0
    for _ in range(10):
        names = _device_ops(call)
        if any(own[0] in name for name in names):
            assert len(names) <= len(own), names
            assert all(any(k in name for k in own) for name in names), names
            kept += 1
    assert kept > 0, "no profile kept the kernel's record"


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3, 4, 28, 33, 64])
@pytest.mark.parametrize("rows", ["mixed", "all_padding", "no_padding"])
@pytest.mark.parametrize("cap", [2048, 300_001])
def test_ell_relax_kernel_widths_and_padding(cuda, width, rows, cap):
    """Both walks of the kernel (16-byte units for D % 4 == 0 on aligned
    blocks, 4-byte words otherwise and for a ``w_ell`` view 4 bytes past
    16-byte alignment), with warps splitting a chunk (2048 rows) and not
    (300 001, a ragged last chunk), all-padding and padding-free
    ``fidx``, distances whose sum with a weight wraps past int32."""
    n = 3001
    rng = np.random.default_rng(width * 10 + len(rows) + cap)
    w = rng.integers(1, 40, size=(n + 1, width)).astype(np.int64)
    w[rng.random(w.shape) < 0.2] = INF
    w[rng.random(w.shape) < 0.05] = INF - 3
    w[n] = INF
    d = _tent(rng, n).astype(np.int64)
    d[rng.random(n) < 0.05] = INF - 2
    dist = torch.from_numpy(d.astype(np.int32)).to(cuda)
    if rows == "all_padding":
        f = np.full(cap, n, np.int32)
    elif rows == "no_padding":
        f = rng.integers(0, n, size=cap).astype(np.int32)
    else:
        f = np.full(cap, n, np.int32)
        f[:cap * 3 // 4] = rng.integers(0, n, size=cap * 3 // 4)
    fidx = torch.from_numpy(f).to(cuda)
    w_ell = torch.from_numpy(w.astype(np.int32)).to(cuda)
    shifted = _offset_copy(w_ell, 1)
    assert relax_layout(w_ell, cap)[0] == int(width % 4 == 0)
    assert relax_layout(shifted, cap)[0] == 0
    for ww in (w_ell, shifted):
        got = ell_relax_cuda(fidx, dist, ww)
        torch.cuda.synchronize()
        _equal([got], [ell_relax_ref(fidx, dist, ww)])
        if rows == "all_padding":
            assert bool((got == INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,deg,cap", [(16, 4, 8), (64, 7, 64), (33, 1, 16),
                                       (5000, 12, 3000)])
def test_ell_relax_kernel_matches_twin(cuda, n, deg, cap):
    rng = np.random.default_rng(n * 1000 + deg)
    g = random_graph(n, n * deg, seed=int(rng.integers(2**31)))
    ell = csr_to_ell(coo_to_csr(g)).to(cuda)
    dist = torch.from_numpy(_tent(rng, n)).to(cuda)
    fidx = np.full(cap, n, np.int32)                 # sentinel padding
    k = int(rng.integers(1, cap + 1))
    fidx[:k] = rng.choice(n, size=k, replace=False)
    fidx = torch.from_numpy(fidx).to(cuda)
    out = ell_relax_cuda(fidx, dist, ell.w)
    torch.cuda.synchronize()
    _equal([out], [ell_relax_ref(fidx, dist, ell.w)])


@pytest.mark.cuda
@pytest.mark.parametrize("s,deg", [(5, 3), (1024, 4), (3000, 9), (70_001, 6)])
@pytest.mark.parametrize("cap_frac", [1.0, 0.01])
@pytest.mark.parametrize("width", ["ell", "zero"])
def test_frontier_relax_kernel_matches_twin(cuda, s, deg, cap_frac, width):
    rng = np.random.default_rng(s + deg)
    if width == "zero":
        nbr = torch.full((s + 1, 0), s, dtype=torch.int32, device=cuda)
        w = torch.full((s + 1, 0), INF, dtype=torch.int32, device=cuda)
    else:
        ell = csr_to_ell(coo_to_csr(random_graph(s, s * deg, seed=s))).to(cuda)
        nbr, w = ell.nbr, ell.w
    dist = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    explored = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    cap = max(1, int(s * cap_frac))                   # small cap: overflow
    for i in (0, 3):
        kw = dict(delta=7, cap=cap, base=0, sent=s)
        out = frontier_relax_cuda(dist, explored, i, nbr, w, **kw)
        torch.cuda.synchronize()
        _equal(out, frontier_relax_ref(dist, explored, i, nbr, w, **kw))
    allinf = torch.full((s,), INF, dtype=torch.int32, device=cuda)
    _equal(frontier_relax_cuda(allinf, allinf, 0, nbr, w, delta=7, cap=cap),
           frontier_relax_ref(allinf, allinf, 0, nbr, w, delta=7, cap=cap))


def _fr_block(s, d, seed):
    """An ELL block int32[S + 1, D] pair of arbitrary values (row S too:
    the kernel copies it, it assumes nothing of it), made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nbr = torch.randint(0, 2**31 - 1, (s + 1, d), generator=g,
                        dtype=torch.int32, device="cuda")
    w = torch.randint(-2**31, 2**31 - 1, (s + 1, d), generator=g,
                      dtype=torch.int32, device="cuda")
    return nbr, w


def _fr_equal(dist, explored, i, nbr, w, **kw):
    out = frontier_relax_cuda(dist, explored, i, nbr, w, **kw)
    torch.cuda.synchronize()
    _equal(out, frontier_relax_ref(dist, explored, i, nbr, w, **kw))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 1, 3, 4, 19, 24, 33])
@pytest.mark.parametrize("s", [1, 5, 1023, 1024, 1025, 70_001, 1_000_003])
def test_frontier_relax_kernel_sizes_widths_and_caps(cuda, s, d):
    """Slices of one vertex to a ragged million, zero to 33 columns
    (a group of 1, 4 and 32 lanes a row, two column steps at D = 33),
    and caps of 1, 64, 4096 and S: below, at and above the population
    (count untruncated), with an all-INF tent and ``base``/``sent`` of
    a shard."""
    rng = np.random.default_rng(s * 40 + d)
    dist = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    explored = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    nbr, w = _fr_block(s, d, s + d)
    allinf = torch.full((s,), INF, dtype=torch.int32, device=cuda)
    for cap in (1, 64, 4096, s):
        for i in (0, 3):
            _fr_equal(dist, explored, i, nbr, w, delta=7, cap=cap)
        _fr_equal(dist, explored, 3, nbr, w, delta=7, cap=cap,
                  base=3 * s + 11, sent=5 * s)
        out = _fr_equal(allinf, allinf, 0, nbr, w, delta=7, cap=cap)
        assert int(out[3]) == 0 and int(out[5]) == INF


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 1025, 1_000_003])
def test_frontier_relax_kernel_full_int32_range(cuda, s):
    """Every int32 ``dist`` (negative included) and every int32 bucket,
    negative and past int32, on the vector scan (aligned) and the scalar
    one (views 4 bytes past 16-byte alignment, and inputs of different
    alignment)."""
    rng = np.random.default_rng(s + 5)
    t, e = _full_range(rng, s + 1)
    tent = torch.from_numpy(t).to(cuda)
    explored = torch.from_numpy(e).to(cuda)
    nbr, w = _fr_block(s, 3, s)
    views = [(tent[:s], explored[:s]), (tent[1:], explored[1:]),
             (tent[:s], explored[1:])]
    assert fr_vector_path(*views[0])
    assert not fr_vector_path(*views[1]) and not fr_vector_path(*views[2])
    for tt, ee in views:
        for delta in (1, 7, 2**30):
            for i in _buckets(delta):
                for cap in (64, s):
                    _fr_equal(tt, ee, i, nbr, w, delta=delta, cap=cap,
                              base=1, sent=s + 7)


@pytest.mark.cuda
@pytest.mark.parametrize("population", [0, 1, 4095, 4096, 4097, 20_000])
def test_frontier_relax_kernel_population_at_cap(cuda, population):
    """A bucket population of 0, below, exactly at and above a cap of
    4096 over 300 001 vertices, members spread over every tile."""
    s, cap, delta, i = 300_001, 4096, 10, 3
    rng = np.random.default_rng(population)
    dist = np.full(s, INF, np.int32)
    dist[rng.choice(s, size=s // 2, replace=False)] = rng.integers(
        40, 400, size=s // 2)
    members = rng.choice(s, size=population, replace=False)
    dist[members] = rng.integers(i * delta, (i + 1) * delta,
                                 size=population)
    explored = np.where(rng.random(s) < 0.5, dist, INF).astype(np.int32)
    explored[members] = INF
    d = torch.from_numpy(dist).to(cuda)
    e = torch.from_numpy(explored).to(cuda)
    nbr, w = _fr_block(s, 19, population)
    out = _fr_equal(d, e, i, nbr, w, delta=delta, cap=cap)
    assert int(out[3]) == population and bool(out[4]) == (population > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1025, 1500])
def test_frontier_relax_kernel_wide_rows(cuda, d):
    """Rows wider than the padding's shared-memory stage (1024
    columns): row S is read from device memory, and the column steps of
    a row loop several times."""
    s = 3000
    rng = np.random.default_rng(d)
    dist = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    explored = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    nbr, w = _fr_block(s, d, d)
    for cap in (1, 64, s):
        _fr_equal(dist, explored, 3, nbr, w, delta=7, cap=cap)


@pytest.mark.cuda
def test_frontier_relax_kernel_offsets_past_int32(cuda):
    """``cap * D`` past 2**31 words (cap above S, so most slots are
    padding): the 64-bit offsets of the row copy and of the padding."""
    s, d = 1000, 1100
    cap = 2**31 // d + 1000
    assert cap * d > 2**31
    rng = np.random.default_rng(2)
    dist = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    explored = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    nbr, w = _fr_block(s, d, 9)
    out = frontier_relax_cuda(dist, explored, 3, nbr, w, delta=7, cap=cap)
    torch.cuda.synchronize()
    fidx, rows_n, rows_w, count, any_, nxt = out
    n = int(count)
    twin = frontier_relax_ref(dist, explored, 3, nbr, w, delta=7, cap=s)
    _equal((fidx[:s], rows_n[:s], rows_w[:s], count, any_, nxt), twin)
    assert 0 < n < s
    assert bool((fidx[s:] == s).all())
    for rows, block in ((rows_n, nbr), (rows_w, w)):
        assert torch.equal(rows[-1], block[s]) and torch.equal(rows[s],
                                                               block[s])
        assert bool((rows[s:] == block[s]).all())
    del out, fidx, rows_n, rows_w
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_frontier_relax_back_to_back_sizes_and_streams(cuda):
    """Calls of different S and cap queued back to back on one stream
    (the scratch grows between them), and interleaved on two streams,
    each equal to the twin: the scan's ticket is reset by every call,
    and no scratch is shared by two streams."""
    rng = np.random.default_rng(13)
    cases = []
    for s, cap in ((1_000_003, 4096), (5, 5), (300_001, 300_001), (1, 1),
                   (70_001, 64), (2_000_000, 2_000_000), (1025, 1)):
        t, e = _full_range(rng, s)
        nbr, w = _fr_block(s, 3, s)
        cases.append((torch.from_numpy(t).to(cuda),
                      torch.from_numpy(e).to(cuda), int(rng.integers(-3, 9)),
                      nbr, w, dict(delta=int(rng.choice([1, 7, 64])),
                                   cap=cap)))
    torch.cuda.synchronize()
    outs = [frontier_relax_cuda(t, e, i, nb, w, **kw)
            for t, e, i, nb, w, kw in cases]
    torch.cuda.synchronize()
    for (t, e, i, nb, w, kw), out in zip(cases, outs):
        _equal(out, frontier_relax_ref(t, e, i, nb, w, **kw))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for rep in range(3):
        for k, (t, e, i, nb, w, kw) in enumerate(cases):
            with torch.cuda.stream(streams[(k + rep) % 2]):
                outs.append(frontier_relax_cuda(t, e, i, nb, w, **kw))
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        t, e, i, nb, w, kw = cases[k % len(cases)]
        _equal(out, frontier_relax_ref(t, e, i, nb, w, **kw))


def _grid_case(rng, shape):
    """tent int32[H, W] with INF cells and values within 14 of INF, and
    a free mask with blocked cells."""
    t = rng.integers(0, 60, size=shape).astype(np.int64)
    t[rng.random(shape) < 0.3] = INF
    near = rng.random(shape) < 0.15
    t[near] = INF - rng.integers(1, 15, size=int(near.sum()))
    return t.astype(np.int32), rng.random(shape) >= 0.2


def _offset_copy(x, offset):
    """A contiguous copy of ``x`` viewed from a flat buffer at element
    ``offset`` (``offset`` 1: an int32 view 4 bytes past 16-byte
    alignment, which the launcher must send down the scalar path)."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1, 700), (700, 1), (32, 32),
                                   (37, 129), (300, 517), (37, 4),
                                   (45, 128), (33, 132), (70, 3000),
                                   (41, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("delta", [5, 13, 20])
def test_grid_relax_kernel_matches_twin(cuda, shape, delta):
    """Both kernel paths: the vector path for W % 4 == 0 (W = 4, 32,
    128, 132, 3000 here) and the scalar one for every other width and
    for a ``tent`` 4 bytes past 16-byte alignment; heights that are no
    multiple of the kernel's row band; a low bucket, one whose values
    wrap past INF when a cost is added, and one past int32
    (``i * delta > INT32_MAX``)."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1] + delta)
    t, f = _grid_case(rng, shape)
    tent = torch.from_numpy(t).to(cuda)
    free = torch.from_numpy(f).to(cuda)
    shifted = _offset_copy(tent, 1)
    assert not vector_path(shifted, free, torch.empty_like(tent))
    assert vector_path(tent, free, torch.empty_like(tent)) == \
        (shape[1] % 4 == 0)
    cases = [(tent, free), (tent, torch.zeros_like(free)),
             (torch.full_like(tent, INF), free), (shifted, free)]
    for tt, ff in cases:      # as drawn, all-blocked, all-INF, unaligned
        for light in (True, False):
            for i in (2, (INF - 8) // delta, INF // delta + 1):
                kw = dict(delta=delta, cost_straight=10, cost_diag=14,
                          light=light)
                out = grid_relax_cuda(tt, ff, i, **kw)
                torch.cuda.synchronize()
                _equal([out], [grid_relax_ref(tt, ff, i, **kw)])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_grid_solver_launches_kernel_on_cuda(cuda, backend):
    """``GridDeltaSolver`` on the card sweeps through the hand-written
    kernel for either ``backend`` value, with the default config too."""
    from repro_torch.core import GridDeltaConfig, GridDeltaSolver
    from repro_torch.graphs import grid_map
    _, free = grid_map(40, 57, 0.1, seed=2)
    src = int(np.flatnonzero(free.ravel())[0])
    rc = (src // 57, src % 57)
    before = grid_relax_cuda.launches
    res = GridDeltaSolver(free, GridDeltaConfig(backend=backend),
                          device=cuda).solve(rc)
    launched = grid_relax_cuda.launches - before
    assert launched == res.outer_iters + res.inner_iters > 0
    cpu = GridDeltaSolver(free, GridDeltaConfig(), device="cpu").solve(rc)
    assert torch.equal(res.dist.cpu(), cpu.dist)
    assert (res.outer_iters, res.inner_iters) == (cpu.outer_iters,
                                                  cpu.inner_iters)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 3])
def test_dispatchers_launch_kernels_on_cuda_tensors(cuda, width):
    """A CUDA tensor reaches the kernel through every dispatcher, the
    zero-width ELL block of ``frontier_relax`` included."""
    from repro_torch.kernels.bucket_scan import bucket_scan
    from repro_torch.kernels.ell_relax import ell_relax
    from repro_torch.kernels.frontier_relax import frontier_relax
    from repro_torch.kernels.grid_relax import grid_relax
    s = 2000
    rng = np.random.default_rng(width)
    dist = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    explored = torch.from_numpy(_tent(rng, s, hi=60)).to(cuda)
    nbr = torch.from_numpy(rng.integers(0, s + 1, size=(s + 1, width))
                           .astype(np.int32)).to(cuda)
    nbr[s] = s
    w = torch.from_numpy(rng.integers(1, 20, size=(s + 1, width))
                         .astype(np.int32)).to(cuda)
    w[s] = INF
    fidx = torch.arange(64, dtype=torch.int32, device=cuda)
    t, f = _grid_case(rng, (40, 50))
    tent = torch.from_numpy(t).to(cuda)
    free = torch.from_numpy(f).to(cuda)
    for fn, call, twin in (
            (grid_relax_cuda,
             lambda: (grid_relax(tent, free, 1, delta=13, light=True),),
             lambda: (grid_relax_ref(tent, free, 1, delta=13,
                                     cost_straight=10, cost_diag=14,
                                     light=True),)),
            (bucket_scan_cuda,
             lambda: bucket_scan(dist, explored, 1, delta=7),
             lambda: bucket_scan_ref(dist, explored, 1, delta=7)),
            (ell_relax_cuda, lambda: (ell_relax(fidx, dist, w),),
             lambda: (ell_relax_ref(fidx, dist, w),)),
            (frontier_relax_cuda,
             lambda: frontier_relax(dist, explored, 1, nbr, w, delta=7,
                                    cap=500),
             lambda: frontier_relax_ref(dist, explored, 1, nbr, w, delta=7,
                                        cap=500))):
        before = fn.launches
        out = call()
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _equal(out, twin())


def _answer(plan, q):
    """A query's answer on the host: arrays and counters as lists."""
    r = plan.solve(q)
    t = r.telemetry
    return ([x.cpu().tolist() for x in (r.dist, r.pred)],
            [torch.as_tensor(x).tolist()
             for x in (t.buckets, t.inner_iters, t.overflow)])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["delta", "rho", "radius"])
@pytest.mark.parametrize("strategy", ["edge", "ell", "pallas", "fused"])
def test_batched_and_policy_paths_on_cuda_equal_cpu(cuda, strategy, policy):
    """``MultiSource`` (one ``[B, n]`` loop on edge/ell, lane by lane on
    the kernel strategies) and the frontier-policy loop give on the card
    what they give on the CPU, and the kernel strategies launch their
    kernels: ``bucket_scan`` + ``ell_relax`` on ``pallas``,
    ``frontier_relax`` + ``bucket_scan`` on ``fused`` (delta), two
    ``ell_relax`` launches per policy step on ``pallas``."""
    from repro_torch.api import Engine, MultiSource, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import watts_strogatz
    g = watts_strogatz(3000, 10, 0.05, seed=4)
    cfg = DeltaConfig(delta=10, strategy=strategy, policy=policy, rho=64)
    sources = [0, 1234, 0, 2999]
    counters = (bucket_scan_cuda, ell_relax_cuda, frontier_relax_cuda)
    before = [fn.launches for fn in counters]
    gpu = Engine(g, cfg, device=cuda).plan()
    multi = _answer(gpu, MultiSource(sources))
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    cpu = Engine(g, cfg, device="cpu").plan()
    assert multi == _answer(cpu, MultiSource(sources))
    assert _answer(gpu, SingleSource(1234)) == _answer(cpu, SingleSource(1234))
    buckets, inner = sum(multi[1][0]), sum(multi[1][1])
    if strategy == "pallas" and policy == "delta":
        assert launched == [2 * buckets + inner, buckets + inner, 0]
    elif strategy == "pallas":
        assert launched == [0, 2 * inner, 0]
    elif strategy == "fused" and policy == "delta":
        assert launched == [buckets, 0, buckets + inner]
    else:       # a policy sweep on fused is the plain compact-and-expand
        assert launched == [0, 0, 0]


@pytest.mark.cuda
def test_grid_multisource_on_cuda_equals_cpu(cuda):
    from repro_torch.api import Engine, MultiSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import grid_map
    g, free = grid_map(60, 70, 0.1, seed=3)
    sources = np.flatnonzero(free.ravel())[[0, 500, 0]].tolist()
    cfg = DeltaConfig(delta=13, strategy="pallas")
    before = grid_relax_cuda.launches
    gpu = _answer(Engine(g, cfg, free_mask=free, device=cuda).plan(),
                  MultiSource(sources))
    assert grid_relax_cuda.launches - before == sum(gpu[1][0]) + sum(
        gpu[1][1])
    assert gpu == _answer(Engine(g, cfg, free_mask=free, device="cpu").plan(),
                          MultiSource(sources))


def _counted(plan, q):
    """``_answer`` and the launches it made: [bucket_scan, ell_relax,
    frontier_relax]."""
    counters = (bucket_scan_cuda, ell_relax_cuda, frontier_relax_cuda)
    before = [fn.launches for fn in counters]
    ans = _answer(plan, q)
    return ans, [fn.launches - b for fn, b in zip(counters, before)]


def _delta_launches(strategy, buckets, inner):
    """[bucket_scan, ell_relax, frontier_relax] launches of delta solves
    whose counters sum to ``buckets`` and ``inner``."""
    return {"ell": [0, 0, 0],
            "pallas": [2 * buckets + inner, buckets + inner, 0],
            "fused": [buckets, 0, buckets + inner]}[strategy]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["ell", "pallas", "fused"])
def test_capped_plan_and_fallback_on_cuda_equal_cpu(cuda, strategy):
    """A ``frontier_cap`` below the frontier: the capped answer (overflow
    flagged) and the fallback's (the full-width twin's) are on the card
    what they are on the CPU, for a single and a batched query, and the
    kernel strategies launch their kernels in the capped solve and in
    the twin's."""
    from repro_torch.api import Engine, MultiSource, SingleSource
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import watts_strogatz
    g = watts_strogatz(3000, 10, 0.05, seed=4)
    cfg = DeltaConfig(delta=10, strategy=strategy, frontier_cap=16)

    def sums(ans):
        return [int(torch.as_tensor(x).sum()) for x in ans[1][:2]]

    for q in (SingleSource(0), MultiSource([0, 1234, 0])):
        raw, n_raw = _counted(Engine(g, cfg, device=cuda).plan(), q)
        assert raw == _answer(Engine(g, cfg, device="cpu").plan(), q)
        assert torch.as_tensor(raw[1][2]).any()
        assert n_raw == _delta_launches(strategy, *sums(raw))
        gpu = Engine(g, cfg, device=cuda).plan(fallback=True)
        cpu = Engine(g, cfg, device="cpu").plan(fallback=True)
        res, n_fb = _counted(gpu, q)
        assert res == _answer(cpu, q)
        assert not torch.as_tensor(res[1][2]).any()
        assert gpu.explain()["fallback_taken"]
        full = _delta_launches(strategy, *sums(res))
        assert n_fb == [a + b for a, b in zip(n_raw, full)]


@pytest.mark.cuda
def test_ell_relax_at_pinned_width_matches_twin(cuda):
    """The dynamic path's rebuilds pad both ELL blocks to the full
    adjacency degree, wider than the tight light width: the kernel
    against its twin on the light block at that width."""
    from repro_torch.core.backends import _ell_blocks
    from repro_torch.graphs import watts_strogatz
    g = watts_strogatz(20_000, 10, 0.05, seed=6)
    deg = int(np.bincount(g.src.numpy(), minlength=g.n_nodes).max())
    light, _ = _ell_blocks(g, 10, deg)
    tight, _ = _ell_blocks(g, 10)
    assert light.max_deg == deg > tight.max_deg
    rng = np.random.default_rng(6)
    dist = torch.from_numpy(_tent(rng, g.n_nodes)).to(cuda)
    w = light.w.to(cuda)
    for k in (1, 777, 4096):
        fidx = np.full(4096, g.n_nodes, np.int32)
        fidx[:k] = np.sort(rng.choice(g.n_nodes, size=k, replace=False))
        fidx = torch.from_numpy(fidx).to(cuda)
        out = ell_relax_cuda(fidx, dist, w)
        torch.cuda.synchronize()
        _equal([out], [ell_relax_ref(fidx, dist, w)])


@pytest.mark.cuda
@pytest.mark.parametrize("population", [40, 64, 5000])
def test_frontier_relax_small_cap_over_large_n_matches_twin(cuda,
                                                            population):
    """The fused repair twin's shape: cap 64 over n = 120 000, with a
    bucket population below, at and above the cap (overflow)."""
    s, cap, delta, i = 120_000, 64, 10, 3
    rng = np.random.default_rng(population)
    ell = csr_to_ell(coo_to_csr(random_graph(s, s * 8, seed=5))).to(cuda)
    dist = np.full(s, INF, np.int32)
    dist[rng.choice(s, size=s // 2, replace=False)] = rng.integers(
        40, 400, size=s // 2)
    members = rng.choice(s, size=population, replace=False)
    dist[members] = rng.integers(i * delta, (i + 1) * delta,
                                 size=population)
    explored = np.where(rng.random(s) < 0.5, dist, INF).astype(np.int32)
    explored[members] = INF
    d = torch.from_numpy(dist).to(cuda)
    e = torch.from_numpy(explored).to(cuda)
    kw = dict(delta=delta, cap=cap, base=0, sent=s)
    out = frontier_relax_cuda(d, e, i, ell.nbr, ell.w, **kw)
    torch.cuda.synchronize()
    assert int(out[3]) >= population
    assert (int(out[3]) > cap) == (population > cap)
    _equal(out, frontier_relax_ref(d, e, i, ell.nbr, ell.w, **kw))


def _warm_runs(plan, q):
    """Solve ``q`` (an ``UpdateBatch``) on ``plan`` and return its answer
    with ``warm``/``repaired``/``cone``, the launches it made and each
    warm run's (backend cap, buckets, inner_iters, overflow)."""
    runs = []
    orig = plan._run_warm

    def run(backend, tent0, explored0):
        out = orig(backend, tent0, explored0)
        runs.append((backend.cap, out.outer_iters, out.inner_iters,
                     out.overflow))
        return out

    plan._run_warm = run
    try:
        counters = (bucket_scan_cuda, ell_relax_cuda, frontier_relax_cuda)
        before = [fn.launches for fn in counters]
        r = plan.solve(q)
        launched = [fn.launches - b for fn, b in zip(counters, before)]
    finally:
        plan._run_warm = orig
    t = r.telemetry
    ans = ([x.cpu().tolist() for x in (r.dist, r.pred)],
           [t.buckets, t.inner_iters, t.overflow, t.warm, t.repaired,
            t.cone])
    return ans, launched, runs


@pytest.mark.cuda
@pytest.mark.parametrize("pred_mode", ["argmin", "packed"])
@pytest.mark.parametrize("strategy", ["pallas", "fused"])
def test_warm_update_batch_on_cuda_equals_cpu(cuda, strategy, pred_mode):
    """Stacked ``UpdateBatch`` re-solves on the card equal the same plan's
    on the CPU (answers, counters, ``warm``/``repaired``/``cone``, and the
    warm runs made: ``pallas`` on its rebuilt backend, ``fused`` on a
    capped fused twin, re-run full-width if it overflows), and each warm
    run launches the kernels by its own counters' equations."""
    from repro_torch.api import Engine, SingleSource, UpdateBatch
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import watts_strogatz
    g = watts_strogatz(3000, 10, 0.05, seed=4)
    cfg = DeltaConfig(delta=10, strategy=strategy, pred_mode=pred_mode)
    gpu = Engine(g, cfg, device=cuda).plan()
    cpu = Engine(g, cfg, device="cpu").plan()
    assert _answer(gpu, SingleSource(0)) == _answer(cpu, SingleSource(0))
    rng = np.random.default_rng(8)
    w = g.w.numpy().copy()
    repaired = []
    for k in (6, 60, 600):                 # the first batch is a no-op
        ids = rng.choice(w.shape[0], size=k, replace=False)
        neww = np.clip(w[ids] + rng.integers(-5, 6, size=k), 1, 20)
        w[ids] = neww
        ans, launched, runs = _warm_runs(gpu, UpdateBatch(ids, neww))
        cans, _, cruns = _warm_runs(cpu, UpdateBatch(ids, neww))
        assert ans == cans and runs == cruns
        assert ans[1][3] and bool(runs) == (ans[1][4] > 0)
        repaired.append(ans[1][4])
        if strategy == "fused" and runs:
            assert runs[0][0] < g.n_nodes          # the capped twin
        want = [0, 0, 0]
        for _, b, inner, _ in runs:
            for j, v in enumerate(_delta_launches(strategy, b, inner)):
                want[j] += v
        assert launched == want
    assert repaired[0] == 0 and min(repaired[1:]) > 0
