"""The port's training path (``repro_torch.train``, the backward pass of
``lm_loss``, ``launch.train``) against the JAX package's, on the CPU.

Weights go from the reference to the port through ``params_from_jax``;
batches are numpy arrays from a seed (printed) that both packages read.
Float32 arithmetic runs in another order in the two packages, so losses
are held within ``TOL`` (``atol = rtol = 1e-5``), each gradient leaf
within ``GRAD_TOL`` (max |Δ| ≤ ``2e-5`` · (1 + max |g_ref|)), updated
parameters within ``atol = rtol = 1e-5``, and the loss history of 8
trainer steps within ``rtol = 1e-5``. The port's restart is held bitwise
to its own uninterrupted run.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from _torch_fixtures import fresh_caches_one_thread
from repro import optim as joptim
from repro import train as jtrain
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.configs.base import LMConfig
from repro_torch.data import SyntheticTokens
from repro_torch.models import transformer
from repro_torch.optim import adamw, sgdm, warmup_cosine
from repro_torch.optim.optimizers import named_from_tree, state_from_jax
from repro_torch.train import (
    SimulatedFailure,
    StepWatchdog,
    Trainer,
    TrainerConfig,
    make_train_step,
    run_with_restarts,
)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 2e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _models(arch, **over):
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    jp = jtf.init_lm(jcfg, jax.random.key(0))
    return cfg, jcfg, jp, transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp), CPU)


def _tokens(vocab, b, s, seed):
    print(f"numpy seed {seed}")
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def _check_grads(ours, ref_tree, what):
    ref = named_from_tree(jax.tree.map(np.asarray, ref_tree))
    assert set(ours) == set(ref), (what, set(ours) ^ set(ref))
    for k, r in ref.items():
        g = ours[k].float().numpy()
        bound = GRAD_TOL * (1 + np.abs(r).max())
        err = np.abs(g - r).max()
        assert err <= bound, f"{what} {k}: max |Δ| {err} > {bound}"


@pytest.mark.parametrize("arch,over", [
    ("gemma2-9b", dict(remat=True)),
    ("moonshot-v1-16b-a3b", {}),
], ids=["gemma2-remat", "moonshot-moe"])
def test_lm_loss_gradients_match_reference(arch, over, monkeypatch):
    """gemma2 (softcaps, a window, tied embeddings; every block and loss
    chunk recomputed in the backward pass) and moonshot (MoE with its
    aux loss): autograd against ``jax.grad`` of the reference loss."""
    cfg, jcfg, jp, model = _models(arch, **over)
    toks, labels = _tokens(cfg.vocab, 2, 32, 5)
    calls = []
    real = transformer.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    params = dict(model.named_parameters())
    assert not any(p.requires_grad for p in params.values())
    for p in params.values():
        p.requires_grad_(True)
    loss, metrics = transformer.lm_loss(
        model, cfg, torch.from_numpy(toks), torch.from_numpy(labels),
        loss_chunk=16)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    # one recomputed block per layer under remat, one per loss chunk
    assert calls == ["_train_block"] * (cfg.n_layers if cfg.remat else 0) \
        + ["_chunk_xent"] * 2

    def ref_loss(p):
        return jtf.lm_loss(p, jcfg, jnp.asarray(toks, jnp.int32),
                           jnp.asarray(labels, jnp.int32), loss_chunk=16)

    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(ref_loss, has_aux=True))(jp)
    loss, aux = float(loss.detach()), float(metrics["aux"].detach())
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    np.testing.assert_allclose(aux, float(jmetrics["aux"]), **TOL)
    if cfg.moe is not None:
        assert aux > 0
    _check_grads(grads, jgrads, arch)


def test_microbatch_two_matches_one_and_reference():
    cfg, jcfg, jp, model = _models("gemma2-9b")
    toks, labels = _tokens(cfg.vocab, 4, 16, 6)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}

    def loss_fn(p, b):
        return transformer.lm_loss(p, cfg, b["tokens"], b["labels"],
                                   loss_chunk=16)

    opt = sgdm(0.5)
    out = {}
    for mb in (1, 2):
        m = transformer.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                        CPU)
        step = make_train_step(loss_fn, opt, microbatch=mb)
        named = dict(m.named_parameters())
        m, _, _, metrics = step(m, opt.init(named), None, batch)
        assert not any(p.requires_grad for p in m.parameters())
        out[mb] = (float(metrics["loss"]), dict(m.named_parameters()))
    np.testing.assert_allclose(out[2][0], out[1][0], **TOL)
    for k, p in out[1][1].items():
        np.testing.assert_allclose(out[2][1][k].detach().numpy(),
                                   p.detach().numpy(), err_msg=k, **TOL)

    jopt = joptim.sgdm(0.5)
    jstep = jtrain.make_train_step(
        lambda p, b: jtf.lm_loss(p, jcfg, b["tokens"], b["labels"],
                                 loss_chunk=16), jopt, microbatch=2)
    jnew, _, _, jmetrics = jstep(
        jp, jopt.init(jp), None,
        {"tokens": jnp.asarray(toks, jnp.int32),
         "labels": jnp.asarray(labels, jnp.int32)})
    np.testing.assert_allclose(out[2][0], float(jmetrics["loss"]), **TOL)
    for k, r in named_from_tree(jax.tree.map(np.asarray, jnew)).items():
        np.testing.assert_allclose(out[2][1][k].detach().numpy(), r,
                                   err_msg=k, **TOL)


def test_optimizer_state_carries_across():
    cfg, jcfg, jp, model = _models("moonshot-v1-16b-a3b")
    names = {k: tuple(p.shape) for k, p in model.named_parameters()}
    for jopt in (joptim.adamw(1e-3), joptim.adafactor(1e-3)):
        st = state_from_jax(jax.tree.map(np.asarray, jopt.init(jp)))
        for key in ("m", "v"):
            if key in st:
                assert {k: tuple(t.shape) for k, t in st[key].items()} \
                    == names
        if "f" in st:
            assert set(st["f"]) == set(names)
        assert st["step"].dtype == torch.int32


class _NumpyTokens:
    """Batch i from numpy seed (seed, i), the same arrays for both
    packages."""

    def __init__(self, vocab, batch, seq, as_torch):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.as_torch = as_torch

    def batch_at(self, step):
        toks = np.random.default_rng([41, step]).integers(
            0, self.vocab, (self.batch, self.seq + 1))
        if self.as_torch:
            t = torch.from_numpy(toks)
        else:
            t = jnp.asarray(toks, jnp.int32)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def test_trainer_loss_history_matches_reference():
    print("numpy seeds [41, step]")
    cfg, jcfg, jp, model = _models("gemma2-9b")
    tcfg = dict(total_steps=8, log_interval=1)

    ours = Trainer(
        lambda p, b: transformer.lm_loss(p, cfg, b["tokens"], b["labels"],
                                         loss_chunk=16),
        adamw(warmup_cosine(3e-3, 3, 8)), model,
        _NumpyTokens(cfg.vocab, 2, 16, True), TrainerConfig(**tcfg))
    ours.run()
    ref = jtrain.Trainer(
        lambda p, b: jtf.lm_loss(p, jcfg, b["tokens"], b["labels"],
                                 loss_chunk=16),
        joptim.adamw(joptim.warmup_cosine(3e-3, 3, 8)), jp,
        _NumpyTokens(cfg.vocab, 2, 16, False), jtrain.TrainerConfig(**tcfg))
    ref.run()
    assert [s for s, _ in ours.history] == [s for s, _ in ref.history] \
        == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in ours.history],
                               [v for _, v in ref.history], rtol=1e-5)


_CFG = LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                d_ff=64, vocab=64)
_DATA = SyntheticTokens(vocab=64, batch=4, seq_len=16, device=CPU)


def _loss(p, b):
    return transformer.lm_loss(p, _CFG, b["tokens"], b["labels"],
                               loss_chunk=16)


def _opt():
    return adamw(warmup_cosine(3e-3, 5, 30))


def _init():
    return transformer.init_lm(_CFG, torch.Generator().manual_seed(0), CPU)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_restart_after_failure_is_bit_identical(compression):
    """Twin of the reference's test (with error-feedback residuals in
    the checkpoint too): a failure at step 13 and a restart from the
    step-8 checkpoint end bitwise equal to an uninterrupted run."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        tcfg = dict(total_steps=24, ckpt_interval=8, log_interval=100,
                    compression=compression)
        ref = Trainer(_loss, _opt(), _init(), _DATA,
                      TrainerConfig(ckpt_dir=d1, **tcfg))
        p_ref = ref.run()

        fails = [13]

        def mk():
            f = fails.pop(0) if fails else None
            return Trainer(_loss, _opt(), _init(), _DATA,
                           TrainerConfig(ckpt_dir=d2, **tcfg),
                           failure_at_step=f)

        p_restart, trainer = run_with_restarts(mk)
        assert trainer.start_step == 8      # resumed from the checkpoint
        for (k, a), (_, b) in zip(p_ref.named_parameters(),
                                  p_restart.named_parameters()):
            assert torch.equal(a, b), k
        if compression != "none":
            for k, r in ref.residuals.items():
                assert torch.equal(r, trainer.residuals[k]), k
        assert torch.equal(ref.opt_state["m"]["embed"],
                           trainer.opt_state["m"]["embed"])


def test_unrecoverable_failure_raises():
    fails = [3, 3, 3, 3]

    def mk():
        return Trainer(_loss, _opt(), _init(), _DATA,
                       TrainerConfig(total_steps=10, ckpt_dir=None,
                                     log_interval=100),
                       failure_at_step=fails.pop(0))

    with pytest.raises((RuntimeError, SimulatedFailure)):
        run_with_restarts(mk, max_restarts=2)


def test_straggler_watchdog_flags_slow_steps():
    wd = StepWatchdog(factor=3.0, warmup=2)
    for step in range(1, 8):
        assert not wd.observe(step, 0.1)
    assert wd.observe(8, 1.0)               # 10x the EMA → straggler
    assert wd.events and wd.events[0][0] == 8
    # EMA not poisoned by the straggler observation
    assert abs(wd.ema - 0.1) < 1e-6


@pytest.mark.parametrize("arch", ["gemma2-9b", "dlrm-mlperf", "gin-tu"])
def test_launch_train_smoke_on_cpu(arch, capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "12",
          "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path),
          "--ckpt-interval", "5"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[train] loss")]
    assert line, out
    first, last = (float(x) for x in line[0].split()[2:5:2])
    assert np.isfinite(first) and np.isfinite(last) and last < first
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_10", "step_12", "step_5"]
