"""Model zoo of the PyTorch port: the transformer LM (dense and MoE),
GNNs, DLRM and the embedding-bag substrate they share, as ``nn.Module``
parameters with plain functions over them; ``constrain`` and
``sharding_rules`` lay them out over a ``DeviceMesh``
(``models/sharding.py``, ``models/param_sharding.py``)."""
from repro_torch.models import dlrm, embedding, gnn, layers, moe, transformer
from repro_torch.models.sharding import constrain, sharding_rules

__all__ = ["dlrm", "embedding", "gnn", "layers", "moe", "transformer",
           "constrain", "sharding_rules"]
