"""Graph substrate of the PyTorch port: containers and generators."""
from repro_torch.graphs.structures import (
    INF32,
    COOGraph,
    CSRGraph,
    ELLGraph,
    coo_from_numpy,
    coo_to_csr,
    csr_to_ell,
    light_heavy_split,
    union_with_reverse,
)
from repro_torch.graphs.generators import (
    grid_map,
    random_graph,
    rmat,
    square_lattice,
    watts_strogatz,
)

__all__ = [
    "INF32",
    "COOGraph",
    "CSRGraph",
    "ELLGraph",
    "coo_from_numpy",
    "coo_to_csr",
    "csr_to_ell",
    "light_heavy_split",
    "union_with_reverse",
    "watts_strogatz",
    "rmat",
    "grid_map",
    "square_lattice",
    "random_graph",
]
