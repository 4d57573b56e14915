"""Public clustering API of the port.

Counterpart of :mod:`repro.core.api`, for the part this port runs: the
Lance-Williams merge loop on the kernel backend.  ``cluster(...)`` takes
raw ``(n, d)`` points or a pre-built ``(n, n)`` distance matrix and returns
a :class:`ClusterResult` whose merge list equals the JAX package's
``cluster(..., algorithm="lw", backend="kernel")``.  The knobs are
documented once, in :func:`repro.core.api.cluster`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import dendrogram as dg
from repro_torch.core.distance import pairwise_euclidean, pairwise_sq_euclidean
from repro_torch.core.engine import resolve_device, symmetrize
from repro_torch.core.linkage import default_metric

#: Engines and backends of the JAX package that this port does not run yet,
#: with the ROADMAP.md item that ports each.
_NOT_PORTED_ALGORITHMS = {
    "nnchain": "A6 (NN-chain, with kernel B5)",
    "twophase": "A10 (distributed)",
    "landmark": "A8 (landmark tier and streaming assignment, with kernel B4)",
}
_NOT_PORTED_BACKENDS = {
    "serial": "A1.4 (the premasked dense serial backend)",
    "distributed": "A10 (distributed)",
}


@dataclass
class ClusterResult:
    merges: np.ndarray                 # (n_merges, 4) slot-convention merge list
    method: str
    backend: str
    algorithm: str = "lw"
    n_leaves: int | None = None        # explicit n for early-stopped runs
    # original points, when the input was points (enables centroids)
    points: np.ndarray | None = field(default=None, repr=False)
    # the (n, n) matrix the tree was built on (enables exemplars)
    distances: np.ndarray | torch.Tensor | None = field(default=None, repr=False)
    metric: str | None = None          # metric used to embed points (None: raw matrix)
    linkage_matrix: np.ndarray = field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.n_leaves is None:
            self.n_leaves = self.merges.shape[0] + 1
        self.linkage_matrix = dg.to_linkage_matrix(self.merges, n=self.n_leaves)

    @property
    def n(self) -> int:
        return int(self.n_leaves)

    @property
    def n_merges(self) -> int:
        return int(self.merges.shape[0])

    def labels(self, k: int) -> np.ndarray:
        """Flat labels for ``k`` clusters (cut the dendrogram at level k).

        An early-stopped run only holds ``n_merges`` merges, so ``k``
        must be at least ``n - n_merges`` (the stop level).
        """
        return dg.cut(self.merges, k, n=self.n)

    def heights(self) -> np.ndarray:
        return dg.merge_heights(self.merges)

    def _distance_matrix(self) -> np.ndarray:
        # exemplars are medoids of the matrix the TREE saw, so the stored
        # input passes through the same normalization as the engine's
        if self.distances is not None:
            D = torch.as_tensor(self.distances)
        elif self.points is not None:
            metric = self.metric or default_metric(self.method)
            D = build_distance_matrix(self.points, metric, device="cpu")
        else:
            raise ValueError(
                "this ClusterResult kept neither points nor distances; build it "
                "through cluster(), or call "
                "repro_torch.core.dendrogram.cut_exemplars with your own matrix"
            )
        return symmetrize(D).cpu().numpy()

    def exemplars(self, k: int) -> np.ndarray:
        """Medoid leaf index per cluster of the ``k``-cut: the leaf whose
        summed distance to the rest of its cluster is minimal."""
        _, ex = dg.cut_exemplars(self.merges, k, self._distance_matrix(), n=self.n)
        return ex

    def centroids(self, k: int) -> np.ndarray:
        """Per-cluster mean of the stored input points at the ``k``-cut."""
        if self.points is None or np.asarray(self.points).ndim != 2:
            raise ValueError(
                "centroids need the original (n, d) points — cluster points "
                "(not a distance matrix) or use exemplars(k) instead"
            )
        X = np.asarray(self.points)
        labels = self.labels(k)
        return np.stack([X[labels == c].mean(axis=0) for c in range(k)])


def build_distance_matrix(X, metric: str = "euclidean", *, device=None) -> torch.Tensor:
    """``(n, d)`` points → ``(n, n)`` float32 distances on ``device``."""
    X = np.asarray(X)
    if metric == "rmsd":
        raise NotImplementedError("the rmsd metric is not ported yet: ROADMAP.md A2")
    if X.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {X.shape}")
    if metric not in ("euclidean", "sqeuclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    Xt = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
    return pairwise_euclidean(Xt) if metric == "euclidean" else pairwise_sq_euclidean(Xt)


def _interpret_input(data, method: str, metric: str | None,
                     is_distance: bool | None = None, *, device=None):
    """A square 2-D array with ``metric is None`` is a pre-built distance
    matrix; anything else is points embedded via *metric* (default:
    :func:`repro_torch.core.linkage.default_metric`).  ``is_distance``
    settles the square case explicitly; left ``None``, a non-symmetric
    square array gets a ``UserWarning``.

    Returns ``(D, points, metric_used)``; ``points``/``metric_used`` are
    ``None`` for matrix input.  A built ``D`` lies on ``device``.
    """
    arr = np.asarray(data)
    looks_square = arr.ndim == 2 and arr.shape[0] == arr.shape[1]
    if is_distance is None:
        is_distance = metric is None and looks_square
        # valid matrix forms stay silent: symmetric, or upper-triangle-only
        plausible_matrix = is_distance and (
            arr.shape[0] <= 1
            or np.allclose(arr, arr.T, rtol=1e-5, atol=1e-6)
            or not np.any(np.tril(arr, k=-1))
        )
        if is_distance and not plausible_matrix:
            warnings.warn(
                "square (n, n) input with metric=None is interpreted as a "
                "pre-built distance matrix, but this one is not symmetric "
                "(the engine symmetrizes by averaging D and D.T). If it is "
                "actually n points in n dimensions, pass is_distance=False "
                "or an explicit metric; pass is_distance=True to silence "
                "this warning.",
                UserWarning,
                stacklevel=3,
            )
    if is_distance:
        if metric is not None:
            raise ValueError(
                f"is_distance=True conflicts with metric={metric!r}: a "
                "pre-built distance matrix needs no embedding metric"
            )
        if not looks_square:
            raise ValueError(
                f"is_distance=True requires a square (n, n) matrix, got {arr.shape}"
            )
        return arr, None, None
    if metric is None:
        metric = default_metric(method)
    return build_distance_matrix(arr, metric, device=device), arr, metric


def cluster(
    data,
    method: str = "complete",
    *,
    metric: str | None = None,
    is_distance: bool | None = None,
    algorithm: str = "auto",
    backend: str = "auto",
    variant: str = "baseline",
    stop_at_k: int = 1,
    distance_threshold: float | None = None,
    compaction: bool | str = "auto",
    keep_inputs: bool = True,
    device=None,
) -> ClusterResult:
    """Hierarchically cluster *data* with the Lance-Williams merge loop.

    ``data`` is an ``(n, n)`` distance matrix when square and ``metric is
    None``, else ``(n, d)`` points embedded via ``metric``.  ``algorithm``
    (``"lw"``/``"auto"``) and ``backend`` (``"kernel"``/``"auto"``) both
    resolve to the LW loop on the CUDA kernels here; other engines,
    backends and knobs raise ``NotImplementedError`` naming the ROADMAP.md
    item that ports them.  ``device`` defaults to CUDA and raises without
    it; ``device="cpu"`` runs the plain torch versions of the kernels.
    ``stop_at_k`` stops at ``k`` clusters; ``keep_inputs`` stores the
    input on the result (for ``exemplars``/``centroids``).
    """
    from repro_torch.kernels.ops import lance_williams_kernelized

    if algorithm in _NOT_PORTED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED_ALGORITHMS[algorithm]}"
        )
    if algorithm not in ("lw", "auto"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if backend in _NOT_PORTED_BACKENDS:
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED_BACKENDS[backend]}"
        )
    if backend not in ("kernel", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)

    D, points, used_metric = _interpret_input(data, method, metric, is_distance, device=dev)
    n = int(D.shape[0])
    res = lance_williams_kernelized(
        D, method=method, variant=variant, stop_at_k=stop_at_k,
        distance_threshold=distance_threshold, compaction=compaction, device=dev,
    )
    return ClusterResult(
        merges=res.merges[: res.n_merges].cpu().numpy(),
        method=method,
        backend="kernel",
        algorithm="lw",
        n_leaves=n,
        points=points if keep_inputs else None,
        distances=D if keep_inputs else None,
        metric=used_metric,
    )
