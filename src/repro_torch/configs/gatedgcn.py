"""Arch config: gatedgcn (family: gnn). Exact spec in gnn_archs.py."""
from repro_torch.configs.gnn_archs import GATEDGCN as CONFIG, smoke as _smoke

FAMILY = "gnn"


def smoke():
    return _smoke(CONFIG)
