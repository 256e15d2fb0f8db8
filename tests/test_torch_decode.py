"""The port's decode serving (``repro_torch.serve.decode``: ``generate``,
``BatchServer``, the deprecated ``SSSPServer`` shim) and the LM mode of
its serving launcher, against the JAX package on the CPU.

Weights are the reference's (``params_from_jax``), prompts come from
numpy seeds, and greedy tokens must be equal, not close. The
``BatchServer`` case pins a reference behaviour that the port keeps:
the cache has one length for every slot, the longest slot's prompt plus
generated count, one past what the cache holds after a prefill. So a
served request attends over zero-filled K/V slots, and its tokens can
differ from ``generate``'s on its prompt alone (ROADMAP Queue 3).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.serve as jlaunch
import repro.serve as jserve
from _torch_fixtures import fresh_caches_one_thread
from repro.core import DeltaConfig as JDeltaConfig
from repro.graphs import generators as jgen
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch import serve as tserve
from repro_torch.core import DeltaConfig
from repro_torch.graphs import coo_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer
from repro_torch.serve import (
    BatchServer,
    Request,
    SSSPQuery,
    SSSPServer,
    generate,
)

LM_ARCHS = [a for a in configs.ARCH_IDS if configs.family_of(a) == "lm"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


def _models(arch):
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = jtf.init_lm(jcfg, jax.random.key(0))
    return cfg, jcfg, transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp), CPU), jp


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_equals_reference(arch):
    cfg, jcfg, model, jp = _models(arch)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    ours = generate(model, cfg, prompts, 6)
    ref = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompts), 6))
    assert ours.dtype == torch.int32 and ours.shape == (2, 6)
    np.testing.assert_array_equal(ours.numpy(), ref)


def _serve(server_cls, request_cls, params, cfg, prompts, max_new, **kw):
    srv = server_cls(params, cfg, **kw)
    for i, p in enumerate(prompts):
        srv.submit(request_cls(rid=i, prompt=p, max_new=max_new))
    done = srv.run_to_completion()
    assert all(r.done for r in done) and not srv.queue
    return {r.rid: list(r.generated) for r in done}, [r.rid for r in done]


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_server_mixed_lengths_keep_the_shared_length(seed):
    """yi-34b smoke, two slots, prompts of 4 and 9 tokens, 6 new tokens:
    the port serves the reference's tokens, and (seed 0) the 4-token
    request's differ from ``generate``'s on its prompt alone."""
    cfg, jcfg, model, jp = _models("yi-34b")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (4, 9)]
    kw = dict(n_slots=2, max_len=32)
    ours, order = _serve(BatchServer, Request, model, cfg, prompts, 6, **kw)
    ref, jorder = _serve(jserve.BatchServer, jserve.Request, jp, jcfg,
                         prompts, 6, **kw)
    assert ours == ref and order == jorder
    alone = [generate(model, cfg, p[None], 6)[0].tolist() for p in prompts]
    jalone = [np.asarray(jserve.generate(jp, jcfg, jnp.asarray(p[None]), 6))
              [0].tolist() for p in prompts]
    assert alone == jalone
    if seed == 0:
        assert ours[0] == [137, 235, 437, 370, 370, 370]
        assert alone[0] == [137, 235, 370, 370, 370, 370]
        assert ours[1] == alone[1]


def test_batch_server_refills_slots_and_stops_at_eos():
    """moonshot smoke (MoE: two slots decode together, so a step's
    capacity is 1 an expert and a shared pick is dropped): five requests
    through two slots, slots refilled from the queue, and a request that
    ends at ``eos_id`` before ``max_new``."""
    cfg, jcfg, model, jp = _models("moonshot-v1-16b-a3b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 5, 7, 3, 6)]
    kw = dict(n_slots=2, max_len=40, eos_id=-1)
    ref, jorder = _serve(jserve.BatchServer, jserve.Request, jp, jcfg,
                         prompts, 7, **kw)
    ours, order = _serve(BatchServer, Request, model, cfg, prompts, 7, **kw)
    assert ours == ref and order == jorder
    assert all(len(t) == 7 for t in ours.values())
    # the first request's third token as end of sequence
    kw["eos_id"] = eos = ref[0][2]
    ref, jorder = _serve(jserve.BatchServer, jserve.Request, jp, jcfg,
                         prompts, 7, **kw)
    ours, order = _serve(BatchServer, Request, model, cfg, prompts, 7, **kw)
    assert ours == ref and order == jorder
    assert ours[0][-1] == eos and len(ours[0]) == 3


def test_sssp_server_shim_equals_reference_across_an_update():
    jg = jgen.watts_strogatz(200, 6, 0.05, seed=21)
    g = coo_from_numpy(np.asarray(jg.src), np.asarray(jg.dst),
                       np.asarray(jg.w), jg.n_nodes)
    with pytest.warns(DeprecationWarning, match="SSSPServer is deprecated"):
        srv = SSSPServer(g, DeltaConfig(delta=10, pred_mode="argmin"),
                         batch_size=2, device="cpu")
    with pytest.deprecated_call():
        jsrv = jserve.SSSPServer(jg, JDeltaConfig(delta=10,
                                                  pred_mode="argmin"),
                                 batch_size=2)
    assert srv.config.delta == jsrv.config.delta == 10
    queries = [(0, None), (3, 150), (7, None)]
    ids = np.arange(10)
    neww = np.clip(np.asarray(jg.w)[ids] + 9, 1, None)
    answers = []
    for s in (srv, jsrv):
        cls = SSSPQuery if s is srv else jserve.SSSPQuery
        for i, (src, dst) in enumerate(queries):
            s.submit(cls(qid=i, source=src, target=dst))
        done = s.step()                       # two queries
        s.update(ids, neww)                   # queued, lands next step
        for i, (src, dst) in enumerate(queries):
            s.submit(cls(qid=10 + i, source=src, target=dst))
        done += s.run_to_completion()
        assert [q.qid for q in done] == [0, 1, 2, 10, 11, 12]
        assert all(q.done for q in done)
        answers.append(done)
    assert np.array_equal(np.asarray(srv.graph.w), np.asarray(jsrv.graph.w))
    for q, jq in zip(*answers):
        assert np.array_equal(q.dist, jq.dist), q.qid
        assert q.path == jq.path, q.qid
    before, after = answers[0][0].dist, answers[0][3].dist
    assert not np.array_equal(before, after)    # the update was applied
    with pytest.raises(ValueError, match="pred_mode"):
        with pytest.deprecated_call():
            SSSPServer(g, DeltaConfig(delta=10, pred_mode="none"),
                       device="cpu").submit(
                SSSPQuery(qid=0, source=0, target=3))


def test_serve_exports_and_launcher_flags_cover_the_reference():
    assert set(jserve.__all__) <= set(tserve.__all__)
    for name in tserve.__all__:
        assert hasattr(tserve, name), name

    def flags(main):
        seen = {}

        def grab(parser, *args, **kw):
            seen.update({opt: a.default for opt, a in
                         parser._option_string_actions.items()})
            raise SystemExit(0)

        mp = pytest.MonkeyPatch()
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        try:
            with pytest.raises(SystemExit):
                main()
        finally:
            mp.undo()
        return seen

    ours, ref = flags(tlaunch.main), flags(jlaunch.main)
    assert set(ref) <= set(ours), set(ref) - set(ours)
    for opt in ("--slots", "--prompt-len", "--max-new", "--max-len",
                "--requests", "--batch", "--nodes"):
        assert ours[opt] == ref[opt], opt
    assert "--device" in ours


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launcher_serves_an_lm_on_cpu(arch, capsys):
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] completed 8 requests, 128 tokens in" in out
    assert "on cpu" in out and "with 4 slots" in out


def test_launcher_lm_without_device_asks_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "gemma2-9b", "--smoke"])
    with pytest.raises(ValueError, match="lm arch"):
        tlaunch.main(["--arch", "gin-tu", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tlaunch.main([])
