"""Arch config: gat-cora (family: gnn). Exact spec in gnn_archs.py."""
from repro_torch.configs.gnn_archs import GAT_CORA as CONFIG, smoke as _smoke

FAMILY = "gnn"


def smoke():
    return _smoke(CONFIG)
