"""Arch config: sssp-gamemap (family: sssp). Exact spec in sssp_archs.py."""
from repro_torch.configs.sssp_archs import SSSP_GAMEMAP as CONFIG, smoke as _smoke

FAMILY = "sssp"


def smoke():
    return _smoke(CONFIG)
