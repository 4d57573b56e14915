"""Streaming assignment: label new points without re-clustering.

Counterpart of :mod:`repro.service.assign`.  A finished
:class:`~repro_torch.core.api.ClusterResult` cut at ``k`` exports one
representative per cluster, the medoid **exemplar** or the point-mean
**centroid**, and a new point is labeled by ONE pairwise-distance call
against those ``k`` representatives on the device, followed by an argmin
there: only the labels come back to the host.

``backend="kernel"`` sends the Euclidean metrics through kernel B4
(:func:`repro_torch.kernels.ops.pairwise`); ``"auto"``/``"xla"`` (the
reference's name) through the torch Gram builder
:func:`repro_torch.core.distance.pairwise_sq_euclidean`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.api import ClusterResult
from repro_torch.core.distance import (
    pairwise_cosine,
    pairwise_rmsd_cross,
    pairwise_sq_euclidean,
)
from repro_torch.core.engine import resolve_device
from repro_torch.core.linkage import default_metric

#: Metrics the assignment path can score against representatives.
ASSIGN_METRICS: tuple[str, ...] = ("euclidean", "sqeuclidean", "cosine", "rmsd")


@dataclass(frozen=True)
class AssignIndex:
    """The per-cluster representatives of one dendrogram cut.

    ``reps[c]`` is cluster ``c``'s representative in the input space
    (``(k, d)`` points, or ``(k, atoms, 3)`` conformations for ``rmsd``),
    as numpy on the host; a query's label IS the row index of its nearest
    representative.
    """

    reps: np.ndarray
    metric: str
    kind: str                   # 'exemplar' | 'centroid'

    @property
    def k(self) -> int:
        return self.reps.shape[0]


def build_index(
    result: ClusterResult,
    k: int,
    *,
    kind: str = "exemplar",
    metric: str | None = None,
) -> AssignIndex:
    """Export the ``k``-cut of a result fit from points as an assignment
    index: ``kind='exemplar'`` the per-cluster medoid (any metric),
    ``kind='centroid'`` the per-cluster mean (``(n, d)`` points only)."""
    if result.points is None:
        raise ValueError(
            "build_index needs a ClusterResult fit from points "
            "(cluster(points, ...)); a raw distance matrix has no "
            "coordinates to assign against"
        )
    metric = metric or result.metric or default_metric(result.method)
    if metric not in ASSIGN_METRICS:
        raise ValueError(f"metric {metric!r} not in {ASSIGN_METRICS}")
    X = np.asarray(result.points)
    if kind == "exemplar":
        reps = X[result.exemplars(k)]
    elif kind == "centroid":
        reps = result.centroids(k)
    else:
        raise ValueError(f"kind must be 'exemplar' or 'centroid', got {kind!r}")
    return AssignIndex(reps=np.asarray(reps, np.float32), metric=metric, kind=kind)


def assign(index: AssignIndex, X, *, backend: str = "auto", device=None) -> np.ndarray:
    """Label each row of ``X`` with its nearest representative's cluster.

    One pairwise-distance call against ``index.k`` representatives on
    ``device`` (CUDA unless told otherwise) and its argmin there (the
    first index on ties, as ``np.argmin``).  A single query
    (``reps.ndim - 1`` dimensional) is labeled as a batch of one.
    """
    if backend not in ("auto", "xla", "kernel"):
        raise ValueError(f"backend must be 'auto', 'xla' or 'kernel', got {backend!r}")
    X = np.asarray(X, np.float32)
    if X.ndim == index.reps.ndim - 1:
        X = X[None]
    if X.shape[1:] != index.reps.shape[1:]:
        raise ValueError(
            f"query shape {X.shape} does not match representatives {index.reps.shape}"
        )
    dev = resolve_device(device)
    Xt = torch.as_tensor(X, device=dev)
    reps = torch.as_tensor(index.reps, dtype=torch.float32, device=dev)
    if index.metric in ("euclidean", "sqeuclidean"):
        # the nearest neighbor is invariant to the sqrt: always squared
        if backend == "kernel":
            from repro_torch.kernels.ops import pairwise

            D = pairwise(Xt, reps)
        else:
            D = pairwise_sq_euclidean(Xt, reps)
    elif index.metric == "cosine":
        D = pairwise_cosine(Xt, reps)
    else:                               # rmsd
        D = pairwise_rmsd_cross(Xt, reps)
    return torch.argmin(D, dim=1).cpu().numpy()
