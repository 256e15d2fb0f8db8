"""The port's training substrate against the JAX package's, on the CPU:
optimizers (``repro_torch.optim``), gradient compression
(``repro_torch.distributed``) and checkpointing
(``repro_torch.checkpoint``).

Inputs come from numpy seeds (printed by each test). Compression and the
checkpoint round trip are held bitwise (every float compared as its
bits, so the sign of a zero counts). Optimizer updates are float32
arithmetic in another order (the global norm reduces in another order;
XLA may contract a multiply-add), so they are held within ``OPT_TOL``:
``rtol = 2e-6`` and ``atol = 1e-7`` on new parameters and state; the
schedule within ``rtol = 1e-6`` and ``atol = 1e-6 * base_lr`` (the
cosine near zero).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import fresh_caches_one_thread
from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.distributed import compress_grads as jcompress
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.distributed import (
    compress_grads,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import state_from_jax

OPT_TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _bits(a):
    """A float array's bits (so -0.0 differs from 0.0 and NaNs compare)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def test_warmup_cosine_matches_reference():
    for base, warm, total, frac in ((3e-4, 10, 30, 0.1), (1e-2, 0, 40, 0.0),
                                    (5e-3, 7, 7, 0.25)):
        ours = optim.warmup_cosine(base, warm, total, frac)
        ref = joptim.warmup_cosine(base, warm, total, frac)
        steps = np.arange(1, 41, dtype=np.int32)
        got = np.array([float(ours(torch.tensor(s))) for s in steps])
        want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * base)


# (name, shape): 'fac' is factored by adafactor, 'unf' is not (a dim
# under 128), 'stack' is updated slice by slice under a lowered chunk
# threshold
TREE = {"a": (3, 4), "fac": (130, 140), "unf": (200, 100), "vec": (7,),
        "stack": (3, 130, 140)}


def _state_np(rng, name, shape):
    if name == "adamw":
        return {"m": rng.standard_normal(shape).astype(np.float32) * 0.1,
                "v": rng.random(shape).astype(np.float32) * 0.01}
    if name == "sgdm":
        return {"m": rng.standard_normal(shape).astype(np.float32) * 0.1}
    if len(shape) >= 2 and min(shape[-2:]) >= 128:
        return {"vr": rng.random(shape[:-1]).astype(np.float32) * 0.01,
                "vc": rng.random(shape[:-2] + shape[-1:]).astype(np.float32)
                * 0.01}
    return {"v": rng.random(shape).astype(np.float32) * 0.01}


def _jax_state(name, per_leaf, step):
    leaves = {k: v for k, v in per_leaf.items()}
    if name == "adafactor":
        f = {}
        for k, s in leaves.items():
            if k == "stack":           # one leaf per slice
                for i in range(TREE[k][0]):
                    f[f"stack{i}"] = {n: jnp.asarray(t[i])
                                      for n, t in s.items()}
            else:
                f[k] = {n: jnp.asarray(t) for n, t in s.items()}
        out = {"f": f}
    else:
        out = {key: {k: jnp.asarray(s[key]) for k, s in leaves.items()}
               for key in ("m", "v") if key in next(iter(leaves.values()))}
    out.update(step=jnp.int32(step), grad_norm=jnp.float32(0.0))
    return out


def _split_stack(tree, name):
    if name != "adafactor":
        return tree
    out = {k: v for k, v in tree.items() if k != "stack"}
    out.update({f"stack{i}": tree["stack"][i]
                for i in range(tree["stack"].shape[0])})
    return out


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_update_matches_reference(name, clip, monkeypatch):
    seed = 11
    print(f"numpy seed {seed}")
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in TREE.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 0.05
             for k, s in TREE.items()}
    per_leaf = {k: _state_np(rng, name, s) for k, s in TREE.items()}
    kw = dict(clip_norm=clip)
    lr = optim.warmup_cosine(1e-2, 3, 20)
    jlr = joptim.warmup_cosine(1e-2, 3, 20)
    if name == "adamw":
        kw["weight_decay"] = 0.1
    ours_opt = optim.BY_NAME[name](lr, **kw)
    ref_opt = joptim.BY_NAME[name](jlr, **kw)
    # the 3 x 130 x 140 stack is updated one slice at a time, as a stack
    # past 256 MiB is; the reference updates each slice as a leaf of its
    # own, which is what its chunked path computes
    monkeypatch.setattr(optimizers, "_CHUNK_BYTES", 130 * 140 * 4)
    assert optimizers._chunked(torch.zeros(TREE["stack"]))

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    state = ours_opt.init(tp)
    if name == "adafactor":
        state["f"] = {k: {n: torch.from_numpy(t.copy()) for n, t in s.items()}
                      for k, s in per_leaf.items()}
    else:
        for key in state:
            if key in ("m", "v"):
                state[key] = {k: torch.from_numpy(s[key].copy())
                              for k, s in per_leaf.items()}
    state["step"] = torch.tensor(4, dtype=torch.int32)
    new_p, new_s = ours_opt.update(tg, state, tp)
    for k in TREE:          # the arguments stay as they were
        assert np.array_equal(tp[k].numpy(), params[k])

    jp = _split_stack({k: jnp.asarray(v) for k, v in params.items()}, name)
    jg = _split_stack({k: jnp.asarray(v) for k, v in grads.items()}, name)
    jnew_p, jnew_s = ref_opt.update(jg, _jax_state(name, per_leaf, 4), jp)
    if name == "adafactor":
        jnew_p = dict(jnew_p, stack=jnp.stack(
            [jnew_p.pop(f"stack{i}") for i in range(3)]))
        slices = [jnew_s["f"].pop(f"stack{i}") for i in range(3)]
        jnew_s["f"]["stack"] = {n: jnp.stack([s[n] for s in slices])
                                for n in ("vr", "vc")}
    for k in TREE:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(jnew_p[k]),
                                   err_msg=f"param {k}", **OPT_TOL)
    ours_state = state_from_jax(jax.tree.map(np.asarray, jnew_s))
    assert int(new_s["step"]) == int(ours_state["step"]) == 5
    np.testing.assert_allclose(float(new_s["grad_norm"]),
                               float(ours_state["grad_norm"]), rtol=1e-6)
    for key in ("m", "v", "f"):
        if key not in new_s:
            continue
        assert set(new_s[key]) == set(ours_state[key]) == set(TREE)
        for k in TREE:
            a, b = new_s[key][k], ours_state[key][k]
            pairs = a.items() if key == "f" else [(key, a)]
            for n, t in pairs:
                ref = b[n] if key == "f" else b
                np.testing.assert_allclose(t.numpy(), ref.numpy(),
                                           err_msg=f"{key} {k} {n}",
                                           **OPT_TOL)


def test_adafactor_chunks_only_large_stacks():
    meta = dict(device="meta")
    assert optimizers._chunked(torch.empty(2, 128, 262145, **meta))
    assert not optimizers._chunked(torch.empty(2, 128, 262144, **meta))
    assert not optimizers._chunked(torch.empty(8192, 16384, **meta))


def test_clip_by_global_norm_promotes_and_scales():
    g = {"a": torch.full((4,), 10.0, dtype=torch.bfloat16)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm(
        {"a": jnp.full((4,), 10.0, jnp.bfloat16)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert clipped["a"].dtype == torch.float32
    assert jclipped["a"].dtype == jnp.float32
    assert np.array_equal(_bits(clipped["a"].numpy()),
                          _bits(np.asarray(jclipped["a"])))


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compress_grads_bitwise_over_three_steps(scheme):
    """Three steps of error feedback from no residual: the compressed
    gradients and the residuals equal the reference's bit for bit."""
    seed = 21
    print(f"numpy seed {seed}")
    rng = np.random.default_rng(seed)
    shapes = {"w": (40, 30), "b": (30,), "z": (5, 6)}
    res, jres = None, None
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2))
                 .astype(np.float32) for k, s in shapes.items()}
        grads["z"][0] = -0.0            # signed zeros and ties
        grads["z"][1] = 0.5
        ours, res = compress_grads(
            {k: torch.from_numpy(v.copy()) for k, v in grads.items()}, res,
            scheme=scheme, topk_frac=0.1)
        ref, jres = jcompress({k: jnp.asarray(v) for k, v in grads.items()},
                              jres, scheme=scheme, topk_frac=0.1)
        for k in shapes:
            for what, a, b in (("grad", ours[k], ref[k]),
                               ("residual", res[k], jres[k])):
                assert a.dtype == torch.float32
                assert np.array_equal(_bits(a.numpy()), _bits(b)), \
                    f"step {step} {what} {k}"


def test_quantize_int8_bitwise():
    g = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    g[:4] = [0.5 * 127, -1.5, 2.5, 0.0]
    q, s = quantize_int8(torch.from_numpy(g))
    from repro.distributed import dequantize_int8 as jdq
    from repro.distributed import quantize_int8 as jq
    jq_, js = jq(jnp.asarray(g))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq_))
    assert np.array_equal(_bits(dequantize_int8(q, s).numpy()),
                          _bits(np.asarray(jdq(jq_, js))))


def _ckpt_tree(rng):
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    return {"params": {"w": w.to(torch.bfloat16), "b": w[0].clone()},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"w": torch.from_numpy(
                        rng.standard_normal((6, 5)).astype(np.float32))},
                    "ids": torch.from_numpy(
                        rng.integers(-9, 9, 11).astype(np.int32))},
            "residuals": None}


def _tree_bits(tree):
    return [(p, _np(t).tobytes(), t.dtype, tuple(t.shape))
            for p, t in ckpt.checkpointer._leaves(tree)]


def test_checkpoint_roundtrip_bitwise_and_gc(tmp_path):
    rng = np.random.default_rng(4)
    tree = _ckpt_tree(rng)
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    jtree = {"a": jnp.arange(5), "nested": {"b": jnp.ones((2, 3))}}
    for step in (1, 2, 3, 4):
        ckpt.save(str(ours), step, tree, keep=2)
        jckpt.save(str(ref), step, jtree, keep=2)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == \
        ["step_3", "step_4"]
    assert ckpt.latest_step(str(ours)) == 4
    assert sorted(ckpt.all_steps(str(ours))) == [3, 4]
    like = {"params": {"w": torch.zeros(6, 5, dtype=torch.bfloat16),
                       "b": torch.zeros(5)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "m": {"w": torch.zeros(6, 5)},
                    "ids": torch.zeros(11, dtype=torch.int32)},
            "residuals": None}
    restored, step = ckpt.restore(str(ours), like)
    assert step == 4 and restored["residuals"] is None
    assert _tree_bits(restored) == _tree_bits(tree)
    older, step = ckpt.restore(str(ours), like, step=3)
    assert step == 3 and _tree_bits(older) == _tree_bits(tree)
    assert ckpt.restore(str(tmp_path / "none"), like) == (None, None)
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore(str(ours), {"params": like["params"]})


def test_async_writer_copies_before_the_thread(tmp_path):
    t = torch.full((4,), 7.0)
    w = ckpt.AsyncWriter(str(tmp_path), keep=2)
    w.submit(10, {"x": t})
    t.add_(1.0)                        # the next step's in-place update
    w.wait()
    restored, step = ckpt.restore(str(tmp_path), {"x": torch.zeros(4)})
    assert step == 10
    assert torch.equal(restored["x"], torch.full((4,), 7.0))
