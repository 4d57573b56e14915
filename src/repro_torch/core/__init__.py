"""repro_torch.core — the clustering engines of the port."""

from repro_torch.core.api import (
    BatchResult,
    ClusterResult,
    build_distance_matrix,
    cluster,
    cluster_batch,
)
from repro_torch.core.batched import (
    BatchStats,
    BucketSignature,
    bucket_signature,
    cluster_batch_merges,
)
from repro_torch.core.distance import DistanceBudget, count_distance_queries
from repro_torch.core.engine import VARIANTS, LWResult, plan_stages, resolve_compaction
from repro_torch.core.lance_williams import lance_williams, lance_williams_from_points
from repro_torch.core.landmark import LandmarkResult, landmark_cluster
from repro_torch.core.linkage import METHODS, coefficients, default_metric, update_row
from repro_torch.core.nnchain import (
    POINTS_METHODS,
    REDUCIBLE_METHODS,
    nn_chain,
    nn_chain_from_points,
)

__all__ = [
    "METHODS",
    "POINTS_METHODS",
    "REDUCIBLE_METHODS",
    "VARIANTS",
    "BatchResult",
    "BatchStats",
    "BucketSignature",
    "ClusterResult",
    "DistanceBudget",
    "LWResult",
    "LandmarkResult",
    "bucket_signature",
    "build_distance_matrix",
    "cluster",
    "cluster_batch",
    "cluster_batch_merges",
    "coefficients",
    "count_distance_queries",
    "default_metric",
    "lance_williams",
    "lance_williams_from_points",
    "landmark_cluster",
    "nn_chain",
    "nn_chain_from_points",
    "plan_stages",
    "resolve_compaction",
    "update_row",
]
