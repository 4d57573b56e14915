"""repro_torch.configs — the paper's clustering configuration."""

from repro_torch.configs.paper_lw import CONFIG, REDUCED, ClusterConfig

__all__ = ["CONFIG", "REDUCED", "ClusterConfig"]
