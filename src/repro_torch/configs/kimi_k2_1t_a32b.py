"""Arch config: kimi-k2-1t-a32b (family: lm). Exact spec in lm_archs.py."""
from repro_torch.configs.lm_archs import KIMI_K2 as CONFIG, smoke as _smoke

FAMILY = "lm"


def smoke():
    return _smoke(CONFIG)
