"""The port's LM forward (``repro_torch.models``: layers, moe,
transformer) against the JAX package's, on the CPU.

Inputs come from numpy seeds; layer weights are drawn in the port and
handed to the reference as numpy arrays, whole models go the other way
through ``params_from_jax``. Float outputs cannot be bitwise across XLA
and torch, so every comparison states its tolerance: float32 cases
``atol = rtol = 1e-5`` (``TOL``); bfloat16 cases ``BF16_ATOL`` (below).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from _torch_fixtures import fresh_caches_one_thread
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import layers, moe, transformer

TOL = dict(atol=1e-5, rtol=1e-5)
# bfloat16 logits (|logit| <= ~4.4 here, where a bf16 step is 2**-5):
# four steps. Two packages round a bf16 matmul's output at different
# points, so one-step differences are expected everywhere.
BF16_ATOL = 0.125
LM_ARCHS = [a for a in configs.ARCH_IDS if configs.family_of(a) == "lm"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread(), torch.no_grad():
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ours, ref, tol=TOL, what=""):
    np.testing.assert_allclose(_np(ours), _np(ref), err_msg=what, **tol)


def _tree(module):
    """A module's parameters as the reference's nested dict of arrays."""
    out = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return out


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _smoke(arch, **over):
    ours = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    ref = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    return ours, ref


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    g = _rand(rng, 16)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    tol = TOL if dtype == "float32" else dict(atol=2 ** -6, rtol=2 ** -7)
    ours = layers.rms_norm(torch.from_numpy(g), tx)
    ref = jlayers.rms_norm(jnp.asarray(g), jx)
    assert ours.dtype == tx.dtype
    _close(ours, ref, tol, "rms_norm")
    pos = np.arange(7)[None, :] + 5
    for theta in (10000.0, 5e6):
        ours = layers.rope(tx, torch.from_numpy(pos), theta)
        ref = jlayers.rope(jx, jnp.asarray(pos), theta)
        assert ours.dtype == tx.dtype
        _close(ours, ref, tol, f"rope theta={theta}")


# (H, Hk, S, T, q_offset, window, softcap, kv_len, chunk, causal)
ATTN_CASES = {
    "grouped_decode": (4, 2, 1, 12, 7, None, None, 8, None, True),
    "grouped_decode_window_softcap": (8, 2, 1, 12, 9, 4, 20.0, 10, 4, True),
    "mqa_decode": (4, 1, 1, 6, 5, None, None, None, None, True),
    "mha_decode": (4, 4, 1, 9, 3, None, 30.0, 4, None, True),
    "repeat_kv": (4, 2, 8, 8, 0, None, None, None, None, True),
    "repeat_kv_cache": (4, 2, 4, 12, 3, None, None, 7, 16, True),
    "non_causal": (4, 2, 6, 6, 0, None, None, None, None, False),
    "chunked": (4, 1, 16, 16, 0, None, None, None, 4, True),
    "chunked_window_softcap": (4, 2, 16, 20, 2, 5, 20.0, 18, 8, True),
    "chunk_not_dividing": (4, 2, 12, 12, 0, 3, None, None, 8, True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_attention_branches(case):
    h, hk, s, t, off, window, softcap, kv_len, chunk, causal = \
        ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (_rand(rng, 2, s, h, 8), _rand(rng, 2, t, hk, 8),
               _rand(rng, 2, t, hk, 8))
    kw = dict(q_offset=off, causal=causal, window=window, softcap=softcap,
              kv_len=kv_len, chunk=chunk)
    ours = layers.gqa_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    ref = jlayers.gqa_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert ours.shape == (2, s, h, 8)
    _close(ours, ref, what=case)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(kind):
    mlp = layers.init_mlp(16, 40, kind, torch.float32, _gen(), CPU)
    assert hasattr(mlp, "w_gate") == (kind != "gelu")
    x = _rand(np.random.default_rng(2), 3, 5, 16)
    _close(layers.mlp_apply(mlp, torch.from_numpy(x), kind),
           jlayers.mlp_apply(_tree(mlp), jnp.asarray(x), kind), what=kind)


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-20b"])
def test_attention_apply_with_and_without_cache(arch):
    cfg, jcfg = _smoke(arch)
    attn = layers.init_attention(cfg, torch.float32, _gen(3), CPU)
    p = _tree(attn)
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 6, cfg.d_model)
    out, (k, v) = layers.attention_apply(attn, cfg, torch.from_numpy(x),
                                         window_arr=cfg.window)
    jout, (jk, jv) = jlayers.attention_apply(p, jcfg, jnp.asarray(x),
                                             window_arr=cfg.window)
    for a, b, name in ((out, jout, "out"), (k, jk, "k"), (v, jv, "v")):
        _close(a, b, what=f"no cache {name}")
    # a cache of 16 with 5 valid entries, then 3 tokens at position 5
    shape = (2, 16, cfg.n_kv_heads, cfg.head_dim_)
    ck, cv = _rand(rng, *shape), _rand(rng, *shape)
    ck[:, 5:], cv[:, 5:] = 0, 0
    x3 = _rand(rng, 2, 3, cfg.d_model)
    cache = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    out, (k, v) = layers.attention_apply(
        attn, cfg, torch.from_numpy(x3), window_arr=cfg.window,
        kv_cache=cache, cache_len=5)
    assert k is cache[0] and v is cache[1]            # written in place
    jout, (jk, jv) = jlayers.attention_apply(
        p, jcfg, jnp.asarray(x3), window_arr=cfg.window,
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.int32(5))
    for a, b, name in ((out, jout, "out"), (k, jk, "k"), (v, jv, "v")):
        _close(a, b, what=f"cache {name}")


# --------------------------------------------------------------------- moe

MOE_CASES = {
    # capacity 0.5: int(30 * 2 / 8 * 0.5) = 3 slots an expert for 60 picks
    "overflow": dict(capacity_factor=0.5),
    "shared_expert": dict(n_shared_experts=1),
    "default": {},
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("mlp", ["swiglu", "geglu"])
def test_moe_apply(case, mlp):
    cfg, jcfg = _smoke("moonshot-v1-16b-a3b", mlp=mlp)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **MOE_CASES[case]))
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, **MOE_CASES[case]))
    block = moe.init_moe(cfg, torch.float32, _gen(4), CPU)
    assert hasattr(block, "shared") == (case == "shared_expert")
    x = _rand(np.random.default_rng(4), 3, 10, cfg.d_model)
    tx = torch.from_numpy(x)
    out, aux = moe.moe_apply(block, cfg, tx)
    jout, jaux = jmoe.moe_apply(_tree(block), jcfg, jnp.asarray(x))
    _close(out, jout, what="out")
    _close(aux, jaux, what="aux")
    *_, cap, slot = moe.route(block, cfg, tx.reshape(30, -1))
    if case == "overflow":       # at most E * cap of the T * k picks fit
        assert cap == 3 and int((slot >= cap).sum()) >= 60 - 8 * cap


# ------------------------------------------------------- five smoke archs

def _models(arch, **over):
    cfg, jcfg = _smoke(arch, **over)
    jp = jtf.init_lm(jcfg, jax.random.key(0))
    model = transformer.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                        CPU)
    return cfg, jcfg, model, jp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int64)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_lm_and_loss(arch):
    cfg, jcfg, model, jp = _models(arch)
    toks = _tokens(cfg, 2, 32, 5)
    labels = np.roll(toks, -1, axis=1)
    logits, aux = transformer.apply_lm(model, cfg, torch.from_numpy(toks))
    jlogits, jaux = jtf.apply_lm(jp, jcfg, jnp.asarray(toks, jnp.int32))
    assert logits.shape == (2, 32, cfg.vocab)
    _close(logits, jlogits, what="logits")
    _close(aux, jaux, what="aux")
    loss, metrics = transformer.lm_loss(model, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(labels),
                                        loss_chunk=16)
    jloss, jmetrics = jtf.lm_loss(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(labels, jnp.int32),
                                  loss_chunk=16)
    _close(loss, jloss, what="loss")
    _close(metrics["xent"], jmetrics["xent"], what="xent")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_decode(arch):
    cfg, jcfg, model, jp = _models(arch)
    toks = _tokens(cfg, 2, 19, 6)
    cache = transformer.init_cache(cfg, 2, 40, device=CPU)
    jcache = jtf.init_cache(jcfg, 2, 40)
    assert cache["k"].shape == jcache["k"].shape
    # 16 prompt tokens: the smoke configs' attention chunk, so prefill
    # takes one query block; three teacher-forced decode steps follow
    logits, cache = transformer.prefill(model, cfg,
                                        torch.from_numpy(toks[:, :16]), cache)
    jlogits, jcache = jtf.prefill(jp, jcfg, jnp.asarray(toks[:, :16],
                                                        jnp.int32), jcache)
    _close(logits, jlogits, what="prefill logits")
    for j in range(16, 19):
        step = toks[:, j:j + 1]
        logits, cache = transformer.decode_step(model, cfg, cache,
                                                torch.from_numpy(step))
        jlogits, jcache = jtf.decode_step(jp, jcfg, jcache,
                                          jnp.asarray(step, jnp.int32))
        assert logits.shape == (2, 1, cfg.vocab)
        _close(logits, jlogits, what=f"decode logits at {j}")
        assert cache["len"] == int(jcache["len"]) == j + 1
        for kk in ("k", "v"):
            _close(cache[kk], jcache[kk], what=f"cache {kk} at {j}")


def _near_ties(model, cfg, toks, run):
    """Tokens (batch, position) whose bf16 router logits, in some layer of
    the port's forward ``run``, put the k-th and (k+1)-th experts within
    four bf16 steps of each other: one rounding of the router's product
    can swap such a pick."""
    inputs = []
    real = moe.moe_apply

    def record(p, c, x):
        inputs.append((p, x))
        return real(p, c, x)

    moe.moe_apply = record
    try:
        run()
    finally:
        moe.moe_apply = real
    ties = set()
    k = cfg.moe.top_k
    for p, x in inputs:
        xt = x.reshape(-1, x.shape[-1])
        top = (xt @ p.router.to(xt.dtype)).float().sort(
            dim=-1, descending=True).values
        mag = top[:, k - 1].abs().clamp_min(2.0 ** -30)
        step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        close = top[:, k - 1] - top[:, k] <= 4 * step
        ties |= {divmod(int(i), toks.shape[1]) for i in
                 torch.nonzero(close).flatten()}
    return ties


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_lm_bfloat16(arch):
    """bf16 weights and activations: every token's logits within
    ``BF16_ATOL``, except, in the MoE archs, tokens whose router has a
    near-tie at its top-k boundary in some layer (``_near_ties``: a
    swapped pick changes the token's expert mix, a different answer, not
    a rounding error); at most 2 of the 64 may differ."""
    cfg, jcfg, model, jp = _models(arch, dtype="bfloat16",
                                   param_dtype="bfloat16")
    toks = _tokens(cfg, 2, 32, 7)
    logits, _ = transformer.apply_lm(model, cfg, torch.from_numpy(toks))
    jlogits, _ = jtf.apply_lm(jp, jcfg, jnp.asarray(toks, jnp.int32))
    assert logits.dtype == torch.bfloat16
    err = np.abs(_np(logits) - _np(jlogits)).max(-1)          # (B, S)
    off = {tuple(map(int, i)) for i in np.argwhere(err > BF16_ATOL)}
    if cfg.moe is None:
        assert not off, (err.max(), sorted(off))
        return
    ties = _near_ties(model, cfg, toks, lambda: transformer.apply_lm(
        model, cfg, torch.from_numpy(toks)))
    assert len(off) <= 2 and off <= ties, (sorted(off), sorted(ties))


def test_params_from_jax_covers_every_parameter():
    cfg, jcfg = _smoke("moonshot-v1-16b-a3b")
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, n_shared_experts=1))
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_shared_experts=1))
    tree = jax.tree.map(np.asarray, jtf.init_lm(jcfg, jax.random.key(1)))
    model = transformer.params_from_jax(cfg, tree, CPU)
    ours = transformer.init_lm(cfg, _gen(), device=CPU)
    shapes = {n: p.shape for n, p in ours.named_parameters()}
    assert {n: p.shape for n, p in model.named_parameters()} == shapes
    assert np.array_equal(model.layers[1].moe.shared.w_up.numpy(),
                          tree["layers"]["moe"]["shared"]["w_up"][1])
    assert sum(p.numel() for p in ours.parameters()) == sum(
        x.size for x in jax.tree.leaves(tree))
    del tree["layers"]["attn_norm"]
    with pytest.raises(ValueError, match="attn_norm"):
        transformer.params_from_jax(cfg, tree, CPU)
