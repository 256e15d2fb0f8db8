"""The port's graph substrate against the reference: the generators and
``coo_to_csr`` / ``csr_to_ell`` / ``light_heavy_split`` give arrays
equal to ``repro.graphs``' for the same seeds (fixed seed lists)."""
import numpy as np
import pytest
import torch

from repro.graphs import generators as jgen
from repro.graphs import structures as jst
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import structures as tst

SEEDS = (0, 1, 7)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_coo(jg, tg):
    assert jg.n_nodes == tg.n_nodes
    for name in ("src", "dst", "w"):
        a, b = np.asarray(getattr(jg, name)), _np(getattr(tg, name))
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=name)


GENERATORS = {
    "watts_strogatz": lambda m, s: m.watts_strogatz(300, 8, 0.1, seed=s),
    "watts_strogatz_p0": lambda m, s: m.watts_strogatz(64, 4, 0.0, seed=s),
    "rmat": lambda m, s: m.rmat(500, 4000, seed=s),
    "rmat_odd_n": lambda m, s: m.rmat(333, 2000, seed=s),
    "random_graph": lambda m, s: m.random_graph(200, 900, seed=s),
    "random_graph_undirected": lambda m, s: m.random_graph(
        100, 300, seed=s, undirected=True),
    "square_lattice": lambda m, s: m.square_lattice(9, seed=s),
    "square_lattice_weighted": lambda m, s: m.square_lattice(
        9, seed=s, weighted=True),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_reference(name, seed):
    print("seed", seed)
    _same_coo(GENERATORS[name](jgen, seed), GENERATORS[name](tgen, seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_grid_map_equals_reference(seed):
    jg, jfree = jgen.grid_map(17, 23, 0.2, seed=seed)
    tg, tfree = tgen.grid_map(17, 23, 0.2, seed=seed)
    _same_coo(jg, tg)
    np.testing.assert_array_equal(np.asarray(jfree), tfree)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("delta", [1, 7, 31])
def test_csr_ell_split_equal_reference(seed, delta):
    jg = jgen.rmat(200, 1500, seed=seed)
    tg = tst.coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                            np.asarray(jg.w), jg.n_nodes)
    _same_coo(jg, tg)
    jcsr, tcsr = jst.coo_to_csr(jg), tst.coo_to_csr(tg)
    for name in ("row_ptr", "col", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(jcsr, name)),
                                      _np(getattr(tcsr, name)))
    jparts = jst.light_heavy_split(jcsr, delta)
    tparts = tst.light_heavy_split(tcsr, delta)
    for jp, tp in zip(jparts, tparts):
        for name in ("row_ptr", "col", "w"):
            np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                          _np(getattr(tp, name)))
        je, te = jst.csr_to_ell(jp), tst.csr_to_ell(tp)
        assert (je.n_nodes, je.max_deg) == (te.n_nodes, te.max_deg)
        np.testing.assert_array_equal(np.asarray(je.nbr), _np(te.nbr))
        np.testing.assert_array_equal(np.asarray(je.w), _np(te.w))
        # the sentinel row n is all padding
        assert (_np(te.nbr)[-1] == te.n_nodes).all()
        assert (_np(te.w)[-1] == tst.INF32).all()


def test_csr_to_ell_pinned_width_and_overflow():
    tg = tgen.random_graph(50, 300, seed=3)
    csr = tst.coo_to_csr(tg)
    wide = tst.csr_to_ell(csr, max_deg=40)
    jwide = jst.csr_to_ell(jst.coo_to_csr(jgen.random_graph(50, 300, seed=3)),
                           max_deg=40)
    np.testing.assert_array_equal(np.asarray(jwide.nbr), _np(wide.nbr))
    with pytest.raises(ValueError):
        tst.csr_to_ell(csr, max_deg=1)


def test_graph_to_device_keeps_arrays():
    tg = tgen.watts_strogatz(40, 4, 0.2, seed=2)
    moved = tg.to("cpu")
    assert moved.n_nodes == tg.n_nodes and moved.device.type == "cpu"
    ell = tst.csr_to_ell(tst.coo_to_csr(tg)).to("cpu")
    assert ell.nbr.shape == (41, ell.max_deg)
    assert bool(ell.valid[:-1].any()) and not bool(ell.valid[-1].any())
