"""The port's GNNs, DLRM, embedding bag, synthetic data and neighbour
sampler against the JAX package's, on the CPU.

Inputs come from numpy seeds (printed by each test); whole models go
from the reference to the port through ``gnn_params_from_jax`` and
``dlrm_params_from_jax``. Bitwise: ``gnn_full_batch``,
``molecule_batch``, ``sample_khop`` given the reference's uniforms,
``embedding_bag`` (sum, mean, max; out-of-range and padding ids) and
``multi_hot_lookup``. Float models are float32 arithmetic in another
order, so losses are held within ``TOL`` (``atol = rtol = 1e-5``) and
each gradient leaf within ``GRAD_TOL``: max |Δ| ≤ ``2e-5`` · (1 + max
|g_ref|) over the leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from _torch_fixtures import fresh_caches_one_thread
from repro.data import gnn_full_batch as jgnn_full_batch
from repro.data import molecule_batch as jmolecule_batch
from repro.graphs import coo_to_csr as jcoo_to_csr
from repro.graphs import random_graph as jrandom_graph
from repro.graphs.sampler import sample_khop as jsample_khop
from repro.models import dlrm as jdlrm
from repro.models import embedding as jembedding
from repro.models import gnn as jgnn
from repro_torch import configs
from repro_torch.data import gnn_full_batch, molecule_batch
from repro_torch.graphs import sample_khop, sampler
from repro_torch.models import dlrm, embedding, gnn
from repro_torch.optim.optimizers import named_from_tree

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 2e-5
CPU = torch.device("cpu")
GNN_ARCHS = ["gin-tu", "gatedgcn", "gat-cora", "schnet"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_bits(ours, ref, what=""):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.dtype == ref.dtype, (what, ours.dtype, ref.dtype)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert np.array_equal(_bits(ours), _bits(ref)), what


# --------------------------------------------------------------- data

def test_gnn_full_batch_and_molecule_batch_bitwise():
    for seed in (0, 5):
        print(f"numpy seed {seed}")
        ours = gnn_full_batch(300, 17, 7, seed=seed, device=CPU)
        ref = jgnn_full_batch(300, 17, 7, seed=seed)
        assert set(ours) == set(ref)
        for k in ref:
            _same_bits(ours[k], ref[k], k)
        ours = molecule_batch(4, 9, 25, seed=seed, device=CPU)
        ref = jmolecule_batch(4, 9, 25, seed=seed)
        assert set(ours) == set(ref)
        for k in ref:
            _same_bits(ours[k], ref[k], k)


def test_synthetic_streams_are_pure_functions_of_seed_and_step():
    from repro_torch.data import SyntheticClicks, SyntheticTokens
    toks = SyntheticTokens(vocab=50, batch=3, seq_len=9, seed=2, device=CPU)
    a, b = toks.batch_at(4), toks.batch_at(4)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], toks.batch_at(5)["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 50
    vocab = (7, 3, 100)
    clicks = SyntheticClicks(vocab, n_dense=4, batch=64, seed=1, device=CPU)
    c = clicks.batch_at(0)
    assert torch.equal(c["sparse"], clicks.batch_at(0)["sparse"])
    assert bool((c["sparse"] < torch.tensor(vocab)).all())
    assert c["dense"].shape == (64, 4) and c["labels"].dtype == torch.float32


# ------------------------------------------------------------- sampler

def test_sample_khop_bitwise_given_the_reference_uniforms(monkeypatch):
    seed = 3
    print(f"numpy seed {seed}, jax key 9")
    g = jrandom_graph(300, 400, seed=seed)       # leaves degree-0 nodes
    csr = jcoo_to_csr(g)
    seeds = np.random.default_rng(seed).choice(300, 24, replace=False)
    fanouts = (5, 3)
    key = jax.random.key(9)
    ref_nodes, ref_blocks = jsample_khop(key, csr.row_ptr, csr.col,
                                         jnp.asarray(seeds, jnp.int32),
                                         fanouts)
    # the reference's uniforms: one split of the key per hop
    draws, n = [], len(seeds)
    for f in fanouts:
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(
            jax.random.uniform(sub, (n, f)))))
        n = n * (f + 1)
    monkeypatch.setattr(sampler, "_uniforms",
                        lambda gen, shape, device: draws.pop(0))
    row_ptr, col = (torch.from_numpy(np.array(a)) for a in (csr.row_ptr,
                                                             csr.col))
    deg = row_ptr[1:] - row_ptr[:-1]
    assert int((deg == 0).sum()) > 0
    nodes, blocks = sample_khop(torch.Generator(), row_ptr, col,
                                torch.from_numpy(seeds), fanouts)
    assert not draws
    _same_bits(nodes, ref_nodes, "input nodes")
    assert len(blocks) == len(ref_blocks)
    for b, rb in zip(blocks, ref_blocks):
        assert b.n_dst == rb.n_dst
        for f in ("src_nodes", "src_local", "dst_local"):
            _same_bits(getattr(b, f), getattr(rb, f), f)


def test_sample_khop_draws_in_range():
    g = jrandom_graph(200, 900, seed=1)
    csr = jcoo_to_csr(g)
    row_ptr, col = (torch.from_numpy(np.array(a)) for a in (csr.row_ptr,
                                                             csr.col))
    seeds = torch.arange(0, 200, 7)
    nodes, blocks = sample_khop(torch.Generator().manual_seed(0), row_ptr,
                                col, seeds, (4, 2))
    assert nodes.shape == (len(seeds) * 5 * 3,)
    nbrs = nodes[len(seeds):len(seeds) * 5].reshape(len(seeds), 4).long()
    for s, row in zip(seeds.tolist(), nbrs.tolist()):
        adj = set(col[row_ptr[s]:row_ptr[s + 1]].tolist()) or {s}
        assert set(row) <= adj


# ------------------------------------------------------------ embedding

@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
def test_embedding_bag_bitwise(mode, weighted):
    seed = 7
    print(f"numpy seed {seed}")
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((30, 8)).astype(np.float32)
    # ids past the table (30, 99), wrapped negatives (-1, -30), one below
    # -V (-31); bag ids past num_bags (6, 9) and negative (-1) are dropped;
    # bag 4 stays empty
    idx = np.concatenate([rng.integers(0, 30, 40),
                          [30, 99, -1, -30, -31]]).astype(np.int32)
    seg = np.concatenate([rng.choice([0, 1, 2, 3, 5], 40),
                          [0, 1, 6, 9, -1]]).astype(np.int32)
    w = rng.random(idx.shape[0]).astype(np.float32) if weighted else None
    ours = embedding.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(seg),
        6, mode=mode, weights=None if w is None else torch.from_numpy(w))
    ref = jembedding.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 6, mode=mode,
        weights=None if w is None else jnp.asarray(w))
    _same_bits(ours, ref, mode)


def test_multi_hot_lookup_bitwise():
    rng = np.random.default_rng(8)
    table = rng.standard_normal((12, 5)).astype(np.float32)
    hot = rng.integers(-1, 12, (9, 4)).astype(np.int32)
    hot[0] = -1                       # all padding
    hot[1, 0] = 12                    # past the table: NaN, as the reference
    ours = embedding.multi_hot_lookup(torch.from_numpy(table),
                                      torch.from_numpy(hot))
    ref = jembedding.multi_hot_lookup(jnp.asarray(table), jnp.asarray(hot))
    _same_bits(ours, ref, "multi_hot_lookup")
    assert bool(torch.isnan(ours[1]).all())


# ----------------------------------------------------------- gradients

def _port_grads(model, loss_fn):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, metrics = loss_fn(model)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def _check_grads(ours, ref_tree, what):
    ref = named_from_tree(jax.tree.map(np.asarray, ref_tree))
    assert set(ours) == set(ref), (what, set(ours) ^ set(ref))
    for k, r in ref.items():
        g = ours[k].numpy()
        bound = GRAD_TOL * (1 + np.abs(r).max())
        err = np.abs(g - r).max()
        assert err <= bound, f"{what} {k}: max |Δ| {err} > {bound}"


def _graph_inputs(cfg, seed):
    """A random graph with padding edges (src == dst == n) appended, its
    features, labels and mask; SchNet: a molecule batch with padding
    edges."""
    rng = np.random.default_rng(seed)
    if cfg.arch == "schnet":
        mb = jmolecule_batch(4, 9, 25, seed=seed)
        n = mb["pos"].shape[0]
        pad = np.full(5, n, np.int32)
        inputs = {"pos": np.array(mb["pos"]),
                  "atom_z": np.array(mb["atom_z"]),
                  "src": np.concatenate([np.asarray(mb["src"]), pad]),
                  "dst": np.concatenate([np.asarray(mb["dst"]), pad]),
                  "mol_id": np.array(mb["mol_id"])}
        return inputs, np.array(mb["energy"]), None
    n, e = 40, 150
    src = np.concatenate([rng.integers(0, n, e), np.full(6, n)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(6, n)])
    inputs = {"x": rng.standard_normal((n, cfg.d_in)).astype(np.float32),
              "src": src.astype(np.int32), "dst": dst.astype(np.int32)}
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    return inputs, labels, mask


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_loss_and_gradients_match_reference(arch):
    seed = 13
    print(f"numpy seed {seed}, jax key 0")
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = jgnn.init_gnn(jcfg, jax.random.key(0))
    model = gnn.gnn_params_from_jax(cfg, jax.tree.map(np.asarray, jp), CPU)
    inputs, labels, mask = _graph_inputs(cfg, seed)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}

    def ours_loss(m):
        return gnn.gnn_loss(m, cfg, tin, torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))

    def ref_loss(p):
        return jgnn.gnn_loss(p, jcfg, jin, jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))

    loss, grads = _port_grads(model, ours_loss)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(ref_loss, has_aux=True))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert ours_loss(model)[1] == ({"mse": True} if arch == "schnet" else {})
    _check_grads(grads, jgrads, arch)
    assert any(float(g.abs().max()) > 0 for g in grads.values())


def test_gnn_init_matches_reference_shapes():
    for arch in GNN_ARCHS:
        cfg = configs.get_config(arch, smoke=True)
        jp = jgnn.init_gnn(jconfigs.get_config(arch, smoke=True),
                           jax.random.key(0))
        ref = {k: v.shape for k, v in named_from_tree(
            jax.tree.map(np.asarray, jp)).items()}
        model = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), CPU)
        assert {k: tuple(p.shape) for k, p in model.named_parameters()} \
            == ref, arch
        assert not any(p.requires_grad for p in model.parameters())


def _dlrm_inputs(cfg, seed, b=32):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    vocab = np.asarray(cfg.vocab_sizes)
    sparse = (rng.random((b, cfg.n_sparse)) * vocab).astype(np.int32)
    sparse[0, :3] = [-4, 10_000, 511]        # clipped into the table
    labels = (rng.random(b) < 0.3).astype(np.float32)
    return dense, sparse, labels


def test_dlrm_loss_gradients_and_retrieval_match_reference():
    seed = 17
    print(f"numpy seed {seed}, jax key 1")
    cfg = configs.get_config("dlrm-mlperf", smoke=True)
    jcfg = jconfigs.get_config("dlrm-mlperf", smoke=True)
    jp = jdlrm.init_dlrm(jcfg, jax.random.key(1))
    model = dlrm.dlrm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), CPU)
    assert all(t.shape[0] % 512 == 0 for t in model.tables)
    dense, sparse, labels = _dlrm_inputs(cfg, seed)
    td, ts, tl = map(torch.from_numpy, (dense, sparse, labels))

    loss, grads = _port_grads(
        model, lambda m: dlrm.dlrm_loss(m, cfg, td, ts, tl))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdlrm.dlrm_loss(p, jcfg, jnp.asarray(dense),
                                  jnp.asarray(sparse), jnp.asarray(labels)),
        has_aux=True))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _check_grads(grads, jgrads, "dlrm")

    with torch.no_grad():
        np.testing.assert_allclose(
            dlrm.apply_dlrm(model, cfg, td, ts).numpy(),
            np.asarray(jdlrm.apply_dlrm(jp, jcfg, jnp.asarray(dense),
                                        jnp.asarray(sparse))), **TOL)
        cand = np.random.default_rng(seed).standard_normal(
            (300, cfg.embed_dim)).astype(np.float32)
        scores, idx = dlrm.retrieval_score(model, cfg, td[:2], ts[:2],
                                           torch.from_numpy(cand), top_k=10)
    jscores, jidx = jdlrm.retrieval_score(
        jp, jcfg, jnp.asarray(dense[:2]), jnp.asarray(sparse[:2]),
        jnp.asarray(cand), top_k=10)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_dlrm_init_matches_reference_shapes():
    cfg = configs.get_config("dlrm-mlperf", smoke=True)
    jp = jdlrm.init_dlrm(jconfigs.get_config("dlrm-mlperf", smoke=True),
                         jax.random.key(0))
    ref = {k: v.shape for k, v in named_from_tree(
        jax.tree.map(np.asarray, jp)).items()}
    model = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0), CPU)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == ref
    bound = 1 / np.sqrt(cfg.embed_dim)
    assert all(float(t.abs().max()) <= bound for t in model.tables)
