"""Arch config: gin-tu (family: gnn). Exact spec in gnn_archs.py."""
from repro_torch.configs.gnn_archs import GIN_TU as CONFIG, smoke as _smoke

FAMILY = "gnn"


def smoke():
    return _smoke(CONFIG)
