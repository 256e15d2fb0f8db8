"""The ``grid_relax`` launcher's host-side arithmetic, on the CPU.

The CUDA kernel tests bucket membership as ``lo <= v < hi`` with the
range from ``bucket_range``, in place of the reference's
``v < INF and v // delta == i``; these tests hold the two tests equal
over every int32 corner (INT32_MIN, -1, 0, bucket edges, the 15 values
below INF and INF), ``delta`` 1-64 and buckets up to past
``INT32_MAX // delta + 1``, and check the launcher's refusals and its
choice between the vector and the scalar path.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, seed, settings
from hypothesis import strategies as st

from repro_torch.kernels.grid_relax import (bucket_range, grid_relax_cuda,
                                            grid_relax_ref, vector_path)

INF = 2**31 - 1
INT32_MIN = -2**31
HYPOTHESIS_SEED = 20261017


def _in_bucket(v: int, i: int, delta: int) -> bool:
    return v < INF and v // delta == i


def _buckets(delta: int):
    top = INF // delta
    return sorted({0, 1, 2, 7, top - 1, top, top + 1, top + 2,
                   2**31 // delta + 1, 2**31, 2**40})


def _values(i: int, delta: int):
    edges = [i * delta + k for k in (-1, 0, 1)] + \
            [(i + 1) * delta + k for k in (-1, 0, 1)]
    vals = {INT32_MIN, INT32_MIN + 1, -delta, -1, 0, 1, delta - 1, delta}
    vals |= {INF - k for k in range(15)}
    vals |= {v for v in edges if INT32_MIN <= v <= INF}
    return sorted(vals)


@pytest.mark.parametrize("delta", range(1, 65))
def test_bucket_range_equals_floor_division(delta):
    for i in _buckets(delta):
        lo, hi = bucket_range(i, delta)
        assert 0 <= lo <= hi <= INF              # both fit int32
        for v in _values(i, delta):
            assert (lo <= v < hi) == _in_bucket(v, i, delta), (v, i, delta)


@pytest.mark.parametrize("delta", [1, 5, 13, 14, 64])
def test_bucket_range_matches_twin_membership_on_int32_tensors(delta):
    """The twin's own int32 tensor test (``(v < INF) & (v // delta ==
    i)``) agrees with the range on every corner value, for every bucket
    that fits int32."""
    for i in _buckets(delta):
        if i > INF:
            continue
        lo, hi = bucket_range(i, delta)
        v = torch.tensor(_values(i, delta), dtype=torch.int32)
        twin = (v < INF) & (v // delta == i)
        assert torch.equal((v >= lo) & (v < hi), twin), (i, delta)


@seed(HYPOTHESIS_SEED)
@settings(max_examples=400, deadline=None, database=None)
@given(v=st.integers(INT32_MIN, INF), delta=st.integers(1, 64),
       frac=st.floats(0.0, 1.0), jitter=st.integers(-2, 2))
def test_bucket_range_property(v, delta, frac, jitter):
    print(f"hypothesis seed {HYPOTHESIS_SEED}")
    i = max(0, int(frac * (INF // delta + 2)) + jitter)
    lo, hi = bucket_range(i, delta)
    assert (lo <= v < hi) == _in_bucket(v, i, delta)
    own = max(0, v // delta)                     # v's own bucket too
    lo, hi = bucket_range(own, delta)
    assert (lo <= v < hi) == _in_bucket(v, own, delta)


@pytest.mark.parametrize("i,delta", [(-1, 13), (-2**31, 1), (0, 0), (3, -1)])
def test_launcher_refuses_bad_bucket_or_delta(i, delta):
    t = torch.zeros((4, 4), dtype=torch.int32)
    f = torch.ones((4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="bucket index|delta"):
        bucket_range(i, delta)
    with pytest.raises(ValueError, match="bucket index|delta"):
        grid_relax_cuda(t, f, i, delta=delta, cost_straight=10,
                        cost_diag=14, light=True)


def _offset_view(shape, dtype, offset):
    """A contiguous ``shape`` view of a flat buffer at element ``offset``."""
    flat = torch.zeros(shape[0] * shape[1] + offset, dtype=dtype)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("w,vec", [(4, True), (128, True), (132, True),
                                   (3000, True), (1, False), (3, False),
                                   (129, False), (517, False)])
def test_vector_path_follows_width(w, vec):
    t = torch.zeros((5, w), dtype=torch.int32)
    f = torch.zeros((5, w), dtype=torch.bool)
    assert t.data_ptr() % 16 == 0 and f.data_ptr() % 4 == 0
    assert vector_path(t, f, torch.empty_like(t)) is vec


@pytest.mark.parametrize("which", ["tent", "out", "free"])
def test_vector_path_refuses_unaligned_views(which):
    shape = (7, 128)
    t = _offset_view(shape, torch.int32, 1 if which == "tent" else 0)
    o = _offset_view(shape, torch.int32, 1 if which == "out" else 0)
    f = _offset_view(shape, torch.bool, 1 if which == "free" else 0)
    assert t.is_contiguous() and f.is_contiguous()
    assert not vector_path(t, f, o)
    assert vector_path(_offset_view(shape, torch.int32, 4),
                       _offset_view(shape, torch.bool, 4),
                       _offset_view(shape, torch.int32, 4))


def test_twin_on_an_empty_bucket_keeps_free_cells():
    """A bucket past int32 (``i * delta > INT32_MAX``) has no frontier:
    the sweep keeps every free cell's value and blocks the rest, which
    is what the kernel gets from the empty range ``[INF, INF)``."""
    rng = np.random.default_rng(3)
    t = rng.integers(0, INF, size=(9, 13), dtype=np.int64).astype(np.int32)
    f = rng.random((9, 13)) >= 0.2
    tent, free = torch.from_numpy(t), torch.from_numpy(f)
    i = INF // 13 + 1
    assert bucket_range(i, 13) == (INF, INF)
    out = grid_relax_ref(tent, free, i, delta=13, cost_straight=10,
                         cost_diag=14, light=True)
    assert torch.equal(out, torch.where(free, tent, INF))
