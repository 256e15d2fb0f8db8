"""Isolation and entry-point contract of the PyTorch port.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the reference package ``repro`` (AST scan).
* ``Engine(g, cfg)`` without ``device`` asks for CUDA and raises where
  there is none, rather than running on the CPU.
* The parts not ported yet raise ``NotImplementedError`` naming their
  ROADMAP item (tuning and the deprecated solver shims, the sharded
  strategies; the batched queries, the frontier policies, dynamic
  updates and the landmark modes are ported); the launcher runs end to
  end on the CPU with --verify.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (
    Engine,
    ManyToMany,
    MultiSource,
    PointToPoint,
    SingleSource,
    UpdateBatch,
)
from repro_torch.core import DeltaConfig, DeltaSteppingSolver, delta_stepping
from repro_torch.graphs import watts_strogatz

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules_to_scan():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/core/backends.py",
                 "src/repro_torch/kernels/frontier_relax/ops.py",
                 "src/repro_torch/kernels/grid_relax/ops.py",
                 "src/repro_torch/core/grid.py",
                 "src/repro_torch/core/policies.py",
                 "src/repro_torch/dynamic/repair.py",
                 "src/repro_torch/landmarks/alt.py",
                 "src/repro_torch/landmarks/tables.py",
                 "src/repro_torch/landmarks/store.py",
                 "src/repro_torch/tune/estimator.py",
                 "src/repro_torch/api/engine.py", "chip_smoke.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_never_imports_jax_or_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_engine_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = watts_strogatz(20, 4, 0.1, seed=0)
    cfg = DeltaConfig(delta=5, strategy="fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g, cfg, device="cuda")
    res = Engine(g, cfg, device="cpu").plan().solve(SingleSource(0))
    assert res.dist.device.type == "cpu"


def test_unported_parts_raise_with_roadmap_item():
    g = watts_strogatz(20, 4, 0.1, seed=0)
    cfg = DeltaConfig(delta=5)
    with pytest.raises(NotImplementedError, match="item 2"):
        Engine(g, device="cpu")
    with pytest.raises(NotImplementedError, match="item 2"):
        Engine(g, cfg, tuning="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        Engine(g, DeltaConfig(strategy="sharded_edge"), device="cpu").plan()
    with pytest.raises(NotImplementedError, match="item 2"):
        DeltaSteppingSolver(g, cfg)
    with pytest.raises(NotImplementedError, match="item 2"):
        delta_stepping(g, 0, cfg)
    # ported: the landmark modes answer as early exit does
    plan = Engine(g, cfg, device="cpu").plan()
    assert plan.solve(PointToPoint(0, 3, mode="alt")).distance == \
        plan.solve(PointToPoint(0, 3)).distance
    for policy in ("delta", "rho", "radius"):
        plan = Engine(g, DeltaConfig(delta=5, policy=policy),
                      device="cpu").plan()
        # ported: dynamic updates, the batched queries, under every
        # policy
        plan.solve(SingleSource(0))
        assert plan.solve(UpdateBatch([0], [3])).telemetry.warm
        plan.solve(MultiSource([0, 1]))
        plan.solve(ManyToMany([0], [3]))
        with pytest.raises(ValueError, match="out of range"):
            plan.solve(SingleSource(20))
    grid = Engine(g, DeltaConfig(strategy="pallas"), free_mask=np.ones((4, 5)),
                  device="cpu").plan()
    assert grid.solve(ManyToMany([0], [3])).matrix.shape == (1, 1)


def test_delta_config_validates_like_reference():
    for bad in (dict(delta=0), dict(strategy="nope"), dict(pred_mode="x"),
                dict(n_shards=0), dict(policy="x"), dict(rho=0),
                dict(radius_k=0), dict(p2p_mode="x")):
        with pytest.raises(ValueError):
            DeltaConfig(**bad)


@pytest.mark.parametrize("strategy,pred_mode,extra", [
    pytest.param("fused", "argmin", [], id="fused-argmin"),
    pytest.param("pallas", "packed", [], id="pallas-packed"),
    pytest.param("edge", "argmin", ["--target", "321", "--p2p-mode", "alt",
                                    "--landmarks", "2"], id="edge-argmin-alt"),
])
def test_launcher_runs_on_cpu_with_verify(capsys, strategy, pred_mode, extra):
    from repro_torch.launch.sssp import main
    main(["--nodes", "400", "--degree", "6", "--strategy", strategy,
          "--pred-mode", pred_mode, "--device", "cpu", "--verify"] + extra)
    out = capsys.readouterr().out
    assert "verify vs Dijkstra: OK" in out
    if extra:
        assert "(alt, k=2 landmark tables in" in out
