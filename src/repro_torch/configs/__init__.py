"""repro_torch.configs — the paper's clustering configuration, and the
assigned LM architectures × shapes registry."""

from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs.paper_lw import CONFIG, REDUCED, ClusterConfig
from repro_torch.configs.shapes import SHAPES, all_cells, cell_runnable

__all__ = [
    "CONFIG",
    "REDUCED",
    "ClusterConfig",
    "ModelConfig",
    "SHAPES",
    "all_cells",
    "cell_runnable",
    "get_config",
    "list_archs",
]
