"""Arch config: gemma2-9b (family: lm). Exact spec in lm_archs.py."""
from repro_torch.configs.lm_archs import GEMMA2_9B as CONFIG, smoke as _smoke

FAMILY = "lm"


def smoke():
    return _smoke(CONFIG)
