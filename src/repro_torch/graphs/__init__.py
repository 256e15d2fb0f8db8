"""Graph substrate of the PyTorch port: containers, generators, the
vertex partitions of the multi-GPU strategies and the k-hop neighbour
sampler of minibatch GNN training."""
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
from repro_torch.graphs.partition import (
    ELLPartition,
    VertexPartition,
    partition_edges,
    partition_ell,
)
from repro_torch.graphs.generators import (
    grid_map,
    random_graph,
    rmat,
    square_lattice,
    watts_strogatz,
)
from repro_torch.graphs.sampler import sample_khop

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
    "ELLPartition",
    "VertexPartition",
    "partition_edges",
    "partition_ell",
    "watts_strogatz",
    "rmat",
    "grid_map",
    "square_lattice",
    "random_graph",
    "sample_khop",
]
