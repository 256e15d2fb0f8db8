"""The port's mesh path in a 4-rank gloo group against the JAX package on
4 host devices, both on a ``(2, 2)`` ``("data", "model")`` mesh under
the reference EP test's mapping (``tests/test_models_extra.py``), on
the CPU.

One SPMD program per rank (``tests/_torch_mesh_ranks.py``, no JAX) and
one JAX process (``tests/_jax_mesh_p4.py``) start once per test session
(``_torch_fixtures.SpawnedGroup``) on the same weights (the JAX
package's ``init_lm`` of the reference test's MoE LM) and inputs, which
this module writes. Cases: ``impl="ep"`` logits against the port's
dense logits (2e-3, the reference test's bound) and against the JAX
package's sharded EP (logits and ``aux`` at every mesh coordinate, at
capacity factors 4.0 and 1.25); at 1.25 the region's output equals the
dense formulation on each data rank's own block of tokens (the kept
pairs), with picks dropped; one layer's region at a sequence-parallel
and a decode-sized token block with its gradients, and the gradient of
``lm_loss`` through the region, against JAX's; the dense-impl MoE LM
and the yi-34b smoke LM under the rules against the unsharded port; a
gemma2-9b smoke decode step over a cache whose sequence is split over
the model dim, or over both dims, against the plain step;
every rank's parameter shards bitwise equal to the block JAX places on
the device at the same mesh coordinate; one AdamW train step under the
rules and its state re-meshed onto ``(1, 2)`` bitwise. Tolerances are
float32 (1e-5; gradients of the layer-level loss, whose magnitudes
reach ~100, relative to the leaf's largest). Seed: ``ranks.SEED``.
"""
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from _torch_fixtures import SpawnedGroup, fresh_caches_one_thread, spawn
from repro.configs.base import LMConfig as JLMConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim.optimizers import named_from_tree

HERE = Path(__file__).resolve().parent
WORLD = 4
LIMIT_S = 300                # each spawned process's hard time limit
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def _write_inputs(path: Path) -> None:
    cfg = ranks.lm_config(JLMConfig, JMoEConfig, "dense", ranks.CFS[0])
    arrays = {}
    _flat(jax_init_lm(cfg, jax.random.key(ranks.SEED)), "params/", arrays)
    rng = np.random.default_rng(ranks.SEED)
    arrays["tokens"] = rng.integers(0, cfg.vocab, ranks.TOKENS).astype(
        np.int32)
    for name, (b, s) in ranks.LAYER_SHAPES.items():
        for key in ("x", "cot"):
            arrays[f"{key}/{name}"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


def _start(root: Path):
    inputs = root / "inputs.npz"
    _write_inputs(inputs)
    procs = [spawn(HERE / "_torch_mesh_ranks.py", r, WORLD, root / "store",
                   inputs, root / f"rank{r}.pkl") for r in range(WORLD)]
    procs.append(spawn(HERE / "_jax_mesh_p4.py", inputs, root / "jax.pkl"))
    return procs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    grp = SpawnedGroup(tmp_path_factory, "torch_mesh_group", _start, LIMIT_S)
    try:
        yield grp.wait()
    finally:
        grp.close()


@pytest.fixture(scope="module")
def group(root):
    def load(name):
        with open(root / name, "rb") as f:   # written by the processes
            return pickle.load(f)              # this module started
    print("seed", ranks.SEED)
    return ([load(f"rank{r}.pkl") for r in range(WORLD)], load("jax.pkl"),
            np.load(root / "inputs.npz"))


def _close(a, b, tag, tol=TOL):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=tag)


def test_ep_logits_match_dense(group):
    got, _, _ = group
    for r in got:
        _close(r[f"ep/{ranks.CFS[0]}"][0], r["dense"][0], "ep vs dense",
               tol=2e-3)


@pytest.mark.parametrize("cf", ranks.CFS)
def test_ep_logits_and_aux_match_jax_sharded_ep(group, cf):
    got, ref, _ = group
    logits, aux = ref[f"ep/{cf}"]
    for r in got:
        _close(r[f"ep/{cf}"][0], logits, f"logits cf={cf}")
        # aux is each data rank's own, as each device's in the reference
        _close(r[f"ep/{cf}"][1], aux[r["coord"]], f"aux {r['coord']}")
    assert aux[(0, 0)] != aux[(1, 0)]


def test_capacity_drops_keep_each_data_blocks_pairs(group):
    """At cf 1.25 the region's output equals the dense formulation on
    each data rank's own token block (the per-rank capacity is the
    block's), and picks are dropped."""
    got, _, data = group
    cfg = ranks.lm_config(LMConfig, MoEConfig, "dense", ranks.LAYER_CF)
    model = params_from_jax(cfg, ranks.unflatten(data, "params/"), "cpu")
    layer = model.layers[0].moe
    x = torch.from_numpy(data["x/scatter"])
    halves = x.shape[0] // ranks.MESH[0]
    dropped = 0
    for i in range(ranks.MESH[0]):
        block = x[i * halves:(i + 1) * halves]
        y, aux = moe_lib.moe_apply(layer, cfg, block)
        *_, cap, slot = moe_lib.route(layer, cfg, block.reshape(
            -1, cfg.d_model))
        dropped += int((slot >= cap).sum())
        for r in got:
            out, r_aux, _ = r["layer/scatter"]
            _close(out[i * halves:(i + 1) * halves], y.numpy(),
                   f"block {i}")
            if r["coord"][0] == i:
                _close(r_aux, aux.numpy(), f"aux block {i}")
    assert dropped > 0


@pytest.mark.parametrize("shape", ranks.LAYER_SHAPES)
def test_layer_region_and_its_gradients_match_jax(group, shape):
    got, ref, _ = group
    y, aux, grads = ref[f"layer/{shape}"]
    for r in got:
        out, r_aux, r_grads = r[f"layer/{shape}"]
        _close(out, y, f"{shape} out")
        _close(r_aux, aux[r["coord"]], f"{shape} aux")
        assert r_grads.keys() == grads.keys()
        for k, g in grads.items():
            scale = float(np.abs(g).max())
            _close(r_grads[k] / scale, g / scale, f"{shape} d{k}")


def test_lm_loss_gradients_through_region_match_jax(group):
    got, ref, _ = group
    loss, grads = ref["grads"]
    grads = named_from_tree(grads)
    for r in got:
        r_loss, r_grads = r["grads"]
        _close(r_loss, loss[r["coord"]], "loss")
        assert r_grads.keys() == grads.keys()
        for k, g in grads.items():
            _close(r_grads[k], g, f"d{k}")
        assert r["train_loss"] == r_loss


def test_lms_under_rules_match_unsharded(group):
    got, _, _ = group
    for r in got:
        for name in ("dense", "smoke"):
            (a, a_aux), (b, b_aux) = r[f"{name}_rules"], r[name]
            _close(a, b, f"{name} logits")
            _close(a_aux, b_aux, f"{name} aux/loss")


@pytest.mark.parametrize("name", ["decode", "decode_long"])
def test_decode_over_a_split_cache_matches_plain(group, name):
    """A decode step whose cache sequence is split over the model dim
    (batch over data), or over both dims: each rank attends over its own
    block and the partial softmaxes are combined across the ranks."""
    got, _, _ = group
    for r in got:
        plain, split = r[name]
        assert np.isfinite(split).all()
        _close(split, plain, f"{name} logits")


def test_prefill_into_a_split_cache_matches_plain(group):
    """A prefill under the rules writes the prompt's K/V into the cache
    whose sequence is split over the model dim, each rank its own block."""
    got, _, _ = group
    for r in got:
        plain, split = r["prefill"]
        for a, b, tag in zip(split, plain, ("logits", "k", "v")):
            _close(a, b, f"prefill {tag}")
        assert np.abs(plain[1][:, :, :16]).max() > 0


def test_parameter_shards_bitwise_equal_jax_placement(group):
    got, ref, _ = group
    placed = ref["shards"]
    for r in got:
        coord = r["coord"]
        for name, local in r["shards"].items():
            parts = name.split(".")
            if parts[0] == "layers":
                node = placed["layers"]
                for p in parts[2:]:
                    node = node[p]
                want = node[coord][int(parts[1])]
            else:
                want = placed[name][coord]
            assert local.dtype == want.dtype and local.shape == want.shape, \
                (name, coord, local.shape, want.shape)
            np.testing.assert_array_equal(local, want, err_msg=name)


def test_remesh_state_onto_smaller_mesh_bitwise(group):
    got, _, _ = group
    for r in got:
        moved = r["remesh"]
        if r["coord"][0] != 0:          # ranks 2, 3: not in (1, 2)
            assert moved is None
            continue
        before, after, layout, step = moved
        assert before.keys() == after.keys() and step == 1
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        placements, shape = layout["layers.0.attn.wq"]
        # a split over the size-1 data dim is a replica
        assert [str(p) for p in placements] == ["R", "S(1)"]
        assert tuple(shape) == (32, 16)
