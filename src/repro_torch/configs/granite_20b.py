"""Arch config: granite-20b (family: lm). Exact spec in lm_archs.py."""
from repro_torch.configs.lm_archs import GRANITE_20B as CONFIG, smoke as _smoke

FAMILY = "lm"


def smoke():
    return _smoke(CONFIG)
