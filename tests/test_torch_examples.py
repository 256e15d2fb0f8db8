"""The port's example twins (``examples/torch_*.py``) run end to end on
the CPU (``--device cpu``), each in a process of its own with a time
limit, as their originals run: every twin asserts its own answers
against Dijkstra or the other engine, and the quickstart stays clean
under ``-W error::DeprecationWarning``. ``torch_multi_source_sssp.py``
spawns its 8 gloo ranks itself (the reference's 2 x 4 layout);
``torch_train_lm.py`` trains a 2-layer, d = 64 model for 30 steps,
asserts that its loss fell and serves from the trained weights."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 120


@pytest.mark.parametrize("script,flags,expect", [
    ("torch_quickstart.py", ["-W", "error::DeprecationWarning"],
     "serving tier:"),
    ("torch_multi_source_sssp.py", [], "reduce_scatter:"),
    ("torch_sssp_gamemap.py", [], "engines agree on cpu"),
    ("torch_train_lm.py", [], "generated token ids:"),
])
def test_example_twin_runs_on_cpu(script, flags, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = (["--steps", "30", "--d-model", "64", "--layers", "2"]
            if script == "torch_train_lm.py" else [])
    out = subprocess.run(
        [sys.executable, *flags, str(ROOT / "examples" / script), "--device",
         "cpu", *args], env=env, capture_output=True, text=True,
        timeout=LIMIT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert expect in out.stdout, out.stdout
