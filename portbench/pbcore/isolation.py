"""The benchmark measures the PyTorch port alone: no module of JAX, Flax
or the JAX package may be loaded in the process that reports. Names
are compared by their top-level part whole, since the port's package
name ``repro_torch`` begins with the JAX package's ``repro``."""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules``."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
