"""repro_torch.core — the Lance-Williams merge loop on the CUDA kernels."""

from repro_torch.core.api import ClusterResult, build_distance_matrix, cluster
from repro_torch.core.engine import VARIANTS, LWResult
from repro_torch.core.linkage import METHODS, coefficients, default_metric, update_row

__all__ = [
    "METHODS",
    "VARIANTS",
    "ClusterResult",
    "LWResult",
    "build_distance_matrix",
    "cluster",
    "coefficients",
    "default_metric",
    "update_row",
]
