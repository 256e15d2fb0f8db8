"""Model zoo of the PyTorch port: the transformer LM (dense and MoE) and
its layers. The GNNs, DLRM, the embedding substrate and the sharding
rules come with later slices."""
from repro_torch.models import layers, moe, transformer

__all__ = ["layers", "moe", "transformer"]
