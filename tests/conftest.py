"""Registers the ``cuda`` marker: tests that need an NVIDIA GPU (and
skip, from inside their fixture, where there is none)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc; skips where "
        "torch.cuda.is_available() is false")
