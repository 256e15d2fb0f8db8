"""Arch config: moonshot-v1-16b-a3b (family: lm). Exact spec in lm_archs.py."""
from repro_torch.configs.lm_archs import MOONSHOT_16B as CONFIG, smoke as _smoke

FAMILY = "lm"


def smoke():
    return _smoke(CONFIG)
