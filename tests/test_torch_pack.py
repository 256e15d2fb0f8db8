"""Packing of (cost, pred) words in the port against the reference:
round trips, ``INF_PACKED``, and the low-32-bit wrap of ``unpack_pred``
(the reference's uint32 → int32 cast)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import pack as jpack
from repro_torch.core import pack as tpack

INF = 2**31 - 1


def test_constants_equal_reference():
    assert tpack.INF_PACKED == jpack.INF_PACKED == 2**63 - 1
    assert tpack.MASK32 == jpack.MASK32


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pack_round_trip_and_reference_words(seed):
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, INF, size=257, dtype=np.int64).astype(np.int32)
    dist[:3] = [0, INF, INF - 1]
    pred = rng.integers(0, INF, size=257, dtype=np.int64).astype(np.int32)
    pred[:3] = [0, INF, 5]
    words = tpack.pack(torch.from_numpy(dist), torch.from_numpy(pred))
    assert words.dtype == torch.int64
    np.testing.assert_array_equal(tpack.unpack_dist(words).numpy(), dist)
    np.testing.assert_array_equal(tpack.unpack_pred(words).numpy(), pred)
    with enable_x64():
        jw = jpack.pack(jnp.asarray(dist), jnp.asarray(pred))
        np.testing.assert_array_equal(np.asarray(jw), words.numpy())


def test_inf_word_decodes_to_sentinels():
    w = torch.tensor([tpack.INF_PACKED], dtype=torch.int64)
    assert int(tpack.unpack_dist(w)[0]) == INF
    assert int(tpack.unpack_pred(w)[0]) == -1


@pytest.mark.parametrize("low", [2**31 - 1, 2**31, 2**31 + 5, 2**32 - 2,
                                 2**32 - 1, 0, 12345])
@pytest.mark.parametrize("high", [0, 7, INF])
def test_unpack_pred_wraps_low_32_bits_like_reference(low, high):
    word = (high << 32) | low
    t = tpack.unpack_pred(torch.tensor([word], dtype=torch.int64))
    assert t.dtype == torch.int32
    with enable_x64():
        j = jpack.unpack_pred(jnp.asarray([word], jnp.int64))
        assert int(t[0]) == int(j[0])
        assert int(tpack.unpack_dist(torch.tensor([word]))[0]) == int(
            jpack.unpack_dist(jnp.asarray([word], jnp.int64))[0])
    expect = low - 2**32 if low >= 2**31 else low
    assert int(t[0]) == expect


def test_pack_orders_words_by_cost_then_pred():
    d = torch.tensor([5, 5, 4, 6], dtype=torch.int32)
    p = torch.tensor([9, 2, 100, 0], dtype=torch.int32)
    words = tpack.pack(d, p)
    order = torch.argsort(words).tolist()
    assert order == [2, 1, 0, 3]
