"""repro_torch.core — the clustering engines of the port."""

from repro_torch.core.api import ClusterResult, build_distance_matrix, cluster
from repro_torch.core.distance import DistanceBudget, count_distance_queries
from repro_torch.core.engine import VARIANTS, LWResult
from repro_torch.core.landmark import LandmarkResult, landmark_cluster
from repro_torch.core.linkage import METHODS, coefficients, default_metric, update_row

__all__ = [
    "METHODS",
    "VARIANTS",
    "ClusterResult",
    "DistanceBudget",
    "LWResult",
    "LandmarkResult",
    "build_distance_matrix",
    "cluster",
    "coefficients",
    "count_distance_queries",
    "default_metric",
    "landmark_cluster",
    "update_row",
]
