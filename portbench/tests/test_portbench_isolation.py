"""The harness drives the port alone: no module of JAX or of the JAX
package (compared by whole top-level names), and the reference not even
the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from pbcore import isolation

BENCH = Path(__file__).resolve().parents[1]
SRC = BENCH.parent / "src"


@pytest.mark.parametrize("modules, found", [
    (["repro_torch", "repro_torch.api.engine", "torch"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.delta_stepping"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reprox", "flaxen", "repro_torchx"], []),
])
def test_forbidden_names_are_whole_top_level_names(modules, found):
    assert isolation.forbidden(modules) == found


def _loaded(code: str) -> set:
    prog = (f"import sys\nsys.path[:0] = [{str(BENCH)!r}, {str(SRC)!r}]\n"
            f"{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120, check=True)
    return set(out.stdout.split())


def test_the_reference_imports_neither_jax_nor_either_package():
    loaded = _loaded(
        "from pbcore.spec import Spec\ns = Spec()\n"
        "[s.reference(n) for n in ('coo_bellman_ford', 'grid_bellman_ford',"
        " 'tree')]\n"
        "[s.generator(n) for n in ('watts_strogatz', 'grid_map')]\n"
        "from pbcore import check, traffic, trace")
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_loads_the_port_and_nothing_of_jax():
    loaded = _loaded(
        "from pbcore import runner\nfrom pbcore.spec import Spec\n"
        "s = Spec()\nrunner.launch_counters(s.kernels())\n"
        "[s.reader(m['name']) for m in s.bench['per_layer'] + "
        "s.bench['end_to_end']]\n"
        "import repro_torch.api, repro_torch.core")
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not isolation.forbidden(roots)
    if path.parent.name == "reference":
        assert "repro_torch" not in roots and "pbcore" not in roots
