"""Find what a cell needs by the names in ``BENCHMARK.json``.

Every piece that belongs to one configuration, traffic mix, metric,
graph generator, reference or port kernel is a file of its own:

* ``configs``: the path in the configuration's ``file`` entry;
* ``traffic/<mix>.json``: the mix's parameters (``pbcore.traffic``);
* ``metrics/<metric>.py``: ``read(ctx)`` returns the metric or None;
* ``generators/<generator>.py``: ``make(params, seed, device)``;
* ``reference/<reference>.py``: ``solve(inst, source, ...)``;
* ``kernels/<kernel>.json``: a port kernel's launch counter and symbols.

So a later cell or metric is new files and new entries, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = HERE.parent                              # the checkout


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import the file ``path`` under a name of its own."""
    name = prefix + "_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> dict:
        for c in self.bench["workloads"]:
            if c["name"] == workload:
                return c
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> list:
        """The cell's metrics of the run's kind: per-layer with a trace,
        end-to-end without. A metric with ``workloads`` belongs to the
        cells it lists; one without to every cell that reports the
        end-to-end metric it ``moves``."""
        e2e = [m for m in self.bench["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str) -> ModuleType:
        return load_module(HERE / "metrics" / f"{metric}.py", "pb_metric")

    def generator(self, name: str) -> ModuleType:
        return load_module(HERE / "generators" / f"{name}.py", "pb_gen")

    def reference(self, name: str) -> ModuleType:
        return load_module(HERE / "reference" / f"{name}.py", "pb_ref")

    def tree(self) -> ModuleType:
        return self.reference("tree")

    def kernels(self) -> dict:
        return {p.stem: json.loads(p.read_text())
                for p in sorted((HERE / "kernels").glob("*.json"))}
