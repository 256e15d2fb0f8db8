"""Deterministic synthetic data of the PyTorch port
(``repro_torch.data.synthetic``)."""
from repro_torch.data.synthetic import (
    SyntheticClicks,
    SyntheticTokens,
    gnn_full_batch,
    molecule_batch,
)

__all__ = ["SyntheticTokens", "SyntheticClicks", "gnn_full_batch",
           "molecule_batch"]
