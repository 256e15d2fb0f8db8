"""Model zoo of the PyTorch port: the transformer LM (dense and MoE),
GNNs, DLRM and the embedding-bag substrate they share, as ``nn.Module``
parameters with plain functions over them. The sharding rules come with
the mesh slice."""
from repro_torch.models import dlrm, embedding, gnn, layers, moe, transformer

__all__ = ["dlrm", "embedding", "gnn", "layers", "moe", "transformer"]
