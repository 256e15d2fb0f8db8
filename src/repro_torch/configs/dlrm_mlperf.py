"""Arch config: dlrm-mlperf (family: recsys). Exact spec in recsys_archs.py."""
from repro_torch.configs.recsys_archs import DLRM_MLPERF as CONFIG, smoke as _smoke

FAMILY = "recsys"


def smoke():
    return _smoke(CONFIG)
