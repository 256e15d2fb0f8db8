"""The port's dry-run analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

* ``collective_stats`` of a record set equals the reference's
  ``collective_stats`` on HLO text of the same shapes (the five ops and
  ``tests/test_analysis.py``'s ``_FAKE_HLO``); recorded functional
  collectives count once per issue (``wait_tensor`` counts nothing);
  an unmapped collective raises, naming the op.
* ``analyze`` gives the reference's fields, with the reference's ``V5E``
  passed in, for the reference's compiled 256² matmul's FLOPs and bytes.
* ``report_md`` renders the same text for the same report dicts.
* The recording mode counts a sharded product's **local** FLOPs on a
  fake 4×4 mesh; a small MLP's train step records its backward and the
  remat recompute; on plain tensors the record's FLOPs equal
  ``FlopCounterMode``'s around the same real step.

Tolerance: none (integer counts, the same float arithmetic).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from _torch_fixtures import fresh_caches_one_thread
from repro.analysis import collective_stats as jax_collective_stats
from repro.analysis import report_md as jax_report_md
from repro.analysis.roofline import V5E
from repro.analysis.roofline import analyze as jax_analyze
from repro_torch.analysis import report_md
from repro_torch.analysis.roofline import H100, analyze
from repro_torch.analysis.trace import (
    CollectiveRecord,
    OpRecord,
    RecordingMode,
    StepTrace,
    collective_stats,
    count_op,
    trace_step,
)


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    with fresh_caches_one_thread():
        yield


@pytest.fixture(scope="module")
def fake_group():
    """A fake 16-rank process group (no collective runs)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _trace(ops=(), collectives=()):
    return StepTrace(ops=list(ops), collectives=list(collectives),
                     argument_bytes=0, peak_temp_bytes=0, output_bytes=0,
                     in_place_bytes=0, seconds=0.0)


# (reference HLO line, op, operand bytes, result bytes)
CASES = [
    ("%ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x)",
     "all-reduce", 128 * 256 * 4, 128 * 256 * 4),
    ("%ag = bf16[64,512]{1,0} all-gather(bf16[4,512]{1,0} %y)",
     "all-gather", 4 * 512 * 2, 64 * 512 * 2),
    ("%rs = f32[32,16]{1,0} reduce-scatter(f32[512,16]{1,0} %z)",
     "reduce-scatter", 512 * 16 * 4, 32 * 16 * 4),
    ("%aa = s32[1024]{0} all-to-all(s32[1024]{0} %w)",
     "all-to-all", 1024 * 4, 1024 * 4),
    ("%cp = f32[8]{0} collective-permute(f32[8]{0} %v)",
     "collective-permute", 8 * 4, 8 * 4),
]
FAKE_HLO = ("HloModule jit_step\n"
            "  %x = f32[128,256]{1,0} parameter(0)\n"
            + "".join(f"  {line}\n" for line, *_ in CASES)
            + "  %dot = f32[128,256]{1,0} dot(f32[128,256]{1,0} %x, "
              "f32[256,256]{1,0} %m)\n")


def _records(cases):
    return [CollectiveRecord(op=op, name=op, operand_bytes=a, result_bytes=r,
                             group_size=4) for _, op, a, r in cases]


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[1] for c in CASES])
def test_collective_stats_of_each_op_matches_reference(case):
    line = CASES[case][0]
    ref = jax_collective_stats(f"HloModule m\n  {line}\n")
    assert collective_stats(_trace(collectives=_records([CASES[case]]))) \
        == ref


def test_collective_stats_of_the_fake_hlo_matches_reference():
    ours = collective_stats(_trace(
        ops=[OpRecord("aten.mm", [], [], 2 * 128 * 256 * 256, 0)],
        collectives=_records(CASES)))
    assert ours == jax_collective_stats(FAKE_HLO)
    assert ours["total"]["count"] == 5


def test_recorded_collectives_count_once_and_unmapped_raise(fake_group):
    from torch.distributed import _functional_collectives as funcol
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    group = mesh.get_group(0)
    mode = RecordingMode()
    with mode:
        x = torch.zeros((8, 64))

    def step(x):
        # under a fake mode a functional collective returns its result
        # (its wait_tensor already issued), not an async tensor
        y = funcol.all_gather_single(x, 0, group)
        z = funcol.all_reduce(y, "sum", group)
        return funcol.reduce_scatter_single(z, "sum", 0, group)

    tr = trace_step(step, x, mode=mode)
    st = collective_stats(tr)
    assert {op: s["count"] for op, s in st["by_op"].items()} == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert st["by_op"]["all-gather"]["wire_bytes"] == 32 * 64 * 4
    assert st["by_op"]["all-reduce"]["wire_bytes"] == 2 * 32 * 64 * 4
    assert st["by_op"]["reduce-scatter"]["operand_bytes"] == 32 * 64 * 4
    assert {c.group_size for c in tr.collectives} == {4}

    with pytest.raises(NotImplementedError, match="broadcast"):
        trace_step(lambda t: funcol.broadcast(t, 0, group), x, mode=mode)


def test_analyze_matches_reference_fields_with_v5e():
    @jax.jit
    def f(a, b):
        return a @ b

    a = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    compiled = f.lower(a, a).compile()
    ref = jax_analyze(compiled, arch="toy", shape="matmul", mesh_name="1",
                      n_devices=1, model_flops=2 * 256**3).to_json()
    tr = _trace(ops=[OpRecord("aten.mm", [], [], ref["flops_per_dev"],
                              ref["bytes_per_dev"])])
    ours = analyze(tr, arch="toy", shape="matmul", mesh_name="1",
                   n_devices=1, model_flops=2 * 256**3, hw=V5E).to_json()
    assert ours.keys() == ref.keys()
    for key in ref:
        if key != "memory_analysis":
            assert ours[key] == ref[key], key
    assert set(ours["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    # the port's default is the H100's data sheet
    h = analyze(tr, arch="toy", shape="matmul", mesh_name="1", n_devices=1,
                model_flops=2 * 256**3)
    assert h.compute_s == ref["flops_per_dev"] / H100["peak_flops"]


def _report(arch, shape, mesh, i):
    coll = {"by_op": {"all-reduce": {"count": i, "operand_bytes": 8 * i,
                                     "wire_bytes": 16 * i},
                      "all-gather": {"count": 2, "operand_bytes": 4,
                                     "wire_bytes": 2**31}},
            "total": {"count": i + 2, "operand_bytes": 8 * i + 4,
                      "wire_bytes": 16 * i + 2**31}}
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "compute_s": 1.5e-3 * i, "memory_s": 0.0 if i == 1 else 2e-2,
            "collective_s": 3.25e-4, "dominant": "memory",
            "hbm_bytes_per_dev": 3 * 2**30 + i, "fits_hbm": i % 2 == 0,
            "useful_ratio": 0.123 * i, "peak_fraction": 0.05,
            "collectives": coll}


def test_report_md_text_matches_reference(tmp_path):
    reports = [_report(a, s, m, i) for i, (a, s, m) in enumerate([
        ("gemma2-9b", "train_4k", "16x16"), ("gemma2-9b", "train_4k",
                                             "2x16x16"),
        ("dlrm-mlperf", "serve_p99", "16x16"),
        ("sssp-smallworld", "multi_source", "2x16x16")], start=1)]
    path = tmp_path / "r.json"
    import json
    path.write_text(json.dumps(reports))
    outs = []
    for mod in (report_md, jax_report_md):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            import sys
            argv, sys.argv = sys.argv, ["report_md", str(path)]
            try:
                mod.main()
            finally:
                sys.argv = argv
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "| gemma2-9b | train_4k |" in outs[0]


def test_sharded_product_counts_local_flops(fake_group):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    mode = RecordingMode()
    with mode:
        a = DTensor.from_local(torch.zeros((8, 16)), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        b = DTensor.from_local(torch.zeros((16, 64)), mesh,
                               [Replicate(), Shard(0)], run_check=False)
    assert a.shape == (32, 64) and b.shape == (64, 64)
    tr = trace_step(lambda a, b: a @ b, a, b, mode=mode)
    assert tr.flops == 2 * 8 * 16 * 64          # not 2 * 32 * 64 * 64
    assert count_op(tr, "aten.mm") == 1
    assert tr.argument_bytes == (8 * 16 + 16 * 64) * 4


def _mlp_params(dev_mode=None):
    g = torch.Generator().manual_seed(0)
    return {"w1": torch.randn((32, 64), generator=g),
            "w2": torch.randn((64, 16), generator=g)}


def _mlp_loss(p, x, remat):
    def body(x, w1, w2):
        return torch.relu(x @ w1) @ w2
    h = (checkpoint(body, x, p["w1"], p["w2"], use_reentrant=False)
         if remat else body(x, p["w1"], p["w2"]))
    return (h ** 2).mean()


def _train_step(p, x, remat=True):
    for t in p.values():
        t.requires_grad_(True)
    loss = _mlp_loss(p, x, remat)
    grads = torch.autograd.grad(loss, list(p.values()))
    with torch.no_grad():
        for t, g in zip(p.values(), grads):
            t.sub_(0.1 * g)
    return loss.detach()


def test_train_step_records_backward_and_remat():
    mode = RecordingMode()
    with mode:
        p = {k: torch.zeros(v.shape) for k, v in _mlp_params().items()}
        x = torch.zeros((128, 32))
    fwd = trace_step(lambda p, x: _mlp_loss(p, x, False), p, x, mode=mode)
    step = trace_step(_train_step, p, x, mode=mode)
    assert fwd.flops == 2 * 128 * 32 * 64 + 2 * 128 * 64 * 16
    assert step.flops >= 3 * fwd.flops
    # forward 2; the recompute 1 (it stops at the last tensor the
    # backward needs); backward 3 (no gradient of the input x)
    assert count_op(step, "aten.mm") == 2 + 1 + 3
    assert step.peak_temp_bytes > 0 and step.in_place_bytes == 0


def test_record_flops_equal_flop_counter_on_a_real_step():
    p = _mlp_params()
    x = torch.randn((128, 32), generator=torch.Generator().manual_seed(1))
    counter = FlopCounterMode(display=False)
    with counter:
        _train_step(p, x)
    mode = RecordingMode()
    with mode:
        fp = {k: torch.zeros(v.shape) for k, v in p.items()}
        fx = torch.zeros(x.shape)
    assert trace_step(_train_step, fp, fx, mode=mode).flops == \
        counter.get_total_flops()
