"""A run end to end on the CPU at a tiny size, the harness's look for a
chip skipped: sound, it is correct; with the timed path broken
underneath (a solve that returns its state unchanged, an answer altered
where it is produced), ``correct`` comes out false. Without a card the
command itself fails and prints no result."""
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import repro_torch.api.engine as engine
from pbcore import runner
from pbcore.spec import HERE, Spec

# the module, not the function ``repro_torch.core`` exports under its name
ds = importlib.import_module("repro_torch.core.delta_stepping")
ROOT = Path(__file__).resolve().parents[2]
INF = 2**31 - 1
CPU = torch.device("cpu")


# the benchmark's cell, and the game-map cells its configuration and
# mixes keep for later (PERF.md, Open questions)
CELLS = {"sw-sssp": ("smallworld-1m-k20-fused", "sssp-uniform"),
         "gm-sssp": ("gamemap-3000-grid", "sssp-anchor-strata"),
         "gm-p2p": ("gamemap-3000-grid", "p2p-octile-bands")}
WORKLOADS = list(CELLS)


def _run(workload: str, trace: bool = False):
    spec = Spec()
    config, traffic = CELLS[workload]
    cell = {"name": workload, "config": config, "traffic": traffic,
            "chips": 1}
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    g = cfg["graph"]
    if "n" in g:
        g["n"] = 1500
    else:
        g["height"] = g["width"] = 40
    mix = spec.traffic(cell["traffic"])
    if "bands" in mix:
        mix["bands"] = [[60, 120], [200, 260], [330, 400]]
    return runner.run(spec, cell, 11, 0.3, trace, CPU, time.perf_counter(),
                      config=cfg, mix=mix)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert all(v["value"] == 0 == v["limit"]
               for v in res["compared"].values())
    assert set(res["metrics"]) == {"setup_s", "query_ms"}   # no peak on a CPU


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read_here():
    res = _run("sw-sssp", trace=True)
    assert res["correct"] and res["attempted"] == 3
    # a CPU trace has no device operations: the device readers stay silent
    assert set(res["metrics"]) == {"plan_build_s", "host_syncs"}
    assert res["device"]["busy_s"] == 0.0 and "breakdown" in res


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_step_that_returns_its_state_unchanged_is_caught(workload,
                                                           monkeypatch):
    def unchanged(backend, source, *, n, packed, device, **kw):
        return ds.RunOut(ds.init_tent(n, source, packed, device), 0, 0,
                         False, 1)

    monkeypatch.setattr(ds, "_run_backend", unchanged)
    res = _run(workload)
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_answer_altered_where_it_is_produced_is_caught(workload,
                                                          monkeypatch):
    real = engine.Plan.solve

    def altered(self, query):
        res = real(self, query)
        if hasattr(res, "dist"):
            far = int(torch.where(res.dist < INF, res.dist, -1).argmax())
            res.dist[far] += 1
            return res
        return engine.PointToPointResult(res.distance + 1, res.path,
                                         res.telemetry)

    monkeypatch.setattr(engine.Plan, "solve", altered)
    res = _run(workload)
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would measure")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sw-sssp",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [c["name"] for c in
                                      Spec().bench["workloads"]])
def test_a_short_run_on_the_card_is_correct(cuda, workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "20261019", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
