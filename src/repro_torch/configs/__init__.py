"""The configs registry of the PyTorch port (counterpart of
``repro.configs``): every architecture id's exact config and smoke
variant, and the (architecture x input-shape) cells. Pure data; importing
it touches no device."""
from repro_torch.configs.base import (
    DLRMConfig,
    GNNConfig,
    LMConfig,
    MoEConfig,
    ShapeSpec,
    SSSPConfig,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_cells,
    assigned_cells,
    family_of,
    get_config,
    get_shape,
    shapes_for,
)

__all__ = ["LMConfig", "MoEConfig", "GNNConfig", "DLRMConfig", "SSSPConfig",
           "ShapeSpec", "ARCH_IDS", "family_of", "get_config", "get_shape",
           "shapes_for", "assigned_cells", "all_cells"]
