"""The benchmark's CPU tests: the harness's folder on the import path,
and the ``cuda`` marker for the tests that need the card (they skip,
from inside their fixture, where there is none)."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc; skips where "
        "torch.cuda.is_available() is false")
