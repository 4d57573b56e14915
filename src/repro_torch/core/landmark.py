"""Landmark tier: sub-quadratic *approximate* agglomeration.

Counterpart of :mod:`repro.core.landmark`, which documents the tier.  In
short, it spends **O(n·k + k²)** distance evaluations for ``k ≪ n``
landmarks:

1. **Sample** ``k`` landmarks (default ``⌈√n · log₂ n⌉``) by a seeded
   numpy PCG64 permutation, so the landmark set equals the reference's.
2. **Cluster the landmarks exactly** with the NN-chain engine on the
   device: matrix-free (kernel B5) when the method has a geometric
   summary under squared-Euclidean, else on a dense ``(k, k)`` matrix.
3. **Assign** the other ``n − k`` objects to their nearest landmark with
   the streaming labeler (:mod:`repro_torch.service.assign`): one
   ``(n−k, k)`` pairwise call and an argmin on the device.
4. Optionally **refine**: reassign against the group centroids,
   ``refine`` times (Euclidean metrics only).

The attach heights and the merge assembly stay numpy on the host, as in
the reference; the merge list goes through
:func:`repro_torch.core.dendrogram.canonical_order` with an unbounded
repair budget.

**Accounting.**  Every evaluation is recorded on any open
:class:`~repro_torch.core.distance.DistanceBudget`, by tag as the
reference records it: the eager pairwise calls themselves, the attach
heights as ``n − k`` (``attach``), and the matrix-free landmark chain as
``iters × k`` (``landmark_chain``): its row builds record nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dendrogram as dg
from repro_torch.core.distance import kabsch_rmsd, pairwise_cosine, record_queries
from repro_torch.core.engine import resolve_device
from repro_torch.core.linkage import default_metric
from repro_torch.core.nnchain import (
    POINTS_METHODS,
    REDUCIBLE_METHODS,
    nn_chain,
    nn_chain_from_points,
)

__all__ = [
    "LANDMARK_METRICS",
    "LandmarkResult",
    "default_landmark_count",
    "landmark_cluster",
    "sample_landmarks",
]

#: Metrics the landmark tier serves: the ones the assignment labeler scores.
LANDMARK_METRICS: tuple[str, ...] = ("euclidean", "sqeuclidean", "cosine", "rmsd")

#: Metrics whose group *centroid* is a meaningful representative.
_CENTROID_METRICS: tuple[str, ...] = ("euclidean", "sqeuclidean")


class LandmarkResult(NamedTuple):
    """Output of :func:`landmark_cluster`: canonical ``merges`` over all
    ``n`` leaves, the sorted global indices of the ``landmarks``, and the
    landmark group of every leaf (``group_labels``; landmark ``g`` is in
    group ``g``), all numpy."""

    merges: np.ndarray
    n_merges: np.int32
    landmarks: np.ndarray
    group_labels: np.ndarray

    @property
    def k(self) -> int:
        return int(self.landmarks.shape[0])


def default_landmark_count(n: int) -> int:
    """``⌈√n · log₂ n⌉`` clamped to ``[2, n]``."""
    if n < 2:
        return n
    return max(2, min(n, int(math.ceil(math.sqrt(n) * math.log2(n)))))


def sample_landmarks(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` distinct indices from ``range(n)``, sorted ascending: a seeded
    PCG64 permutation prefix, as the reference draws it."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    lm = np.random.default_rng(seed).permutation(n)[:k]
    return np.sort(lm)


def _attach_distances(Xr: np.ndarray, reps: np.ndarray, metric: str) -> np.ndarray:
    """Per-point distance to its chosen representative (``reps`` gathered
    to ``Xr``'s order): ``len(Xr)`` evaluations, tag ``attach``."""
    if len(Xr) == 0:
        return np.zeros((0,), np.float32)
    record_queries(len(Xr), "attach")
    if metric in ("euclidean", "sqeuclidean"):
        sq = np.sum((Xr - reps) ** 2, axis=-1)
        return np.sqrt(sq) if metric == "euclidean" else sq
    if metric == "cosine":
        num = np.sum(Xr * reps, axis=-1)
        den = np.maximum(
            np.linalg.norm(Xr, axis=-1) * np.linalg.norm(reps, axis=-1), 1e-12
        )
        return np.clip(1.0 - num / den, 0.0, 2.0).astype(np.float32)
    # rmsd: optimal-superposition distance per (conformation, exemplar) pair
    return kabsch_rmsd(torch.from_numpy(Xr), torch.from_numpy(reps)).numpy()


def _assemble_merges(
    n: int,
    landmarks: np.ndarray,
    rest: np.ndarray,
    labels_rest: np.ndarray,
    attach_d: np.ndarray,
    lm_merges: np.ndarray,
) -> np.ndarray:
    """Stitch attach merges and the mapped landmark merges into one
    canonical slot-convention merge list over all ``n`` leaves: each
    group's attaches in ascending height, then the landmark chain's
    canonical sequence over the group slots."""
    k = landmarks.shape[0]
    slot_of = landmarks.astype(np.int64).copy()   # current global slot per group
    gsize = np.ones(k, np.int64)                  # members absorbed so far
    rows: list[tuple] = []

    for t in np.argsort(attach_d, kind="stable"):
        g = int(labels_rest[t])
        p = int(rest[t])
        s = int(slot_of[g])
        i, j = (s, p) if s < p else (p, s)
        gsize[g] += 1
        rows.append((i, j, float(attach_d[t]), float(gsize[g])))
        slot_of[g] = i

    # landmarks are sorted, so the subindex → group map preserves order and
    # the i < j slot convention survives it
    for li, lj, h, _ in np.asarray(lm_merges, np.float64):
        gi, gj = int(li), int(lj)
        si, sj = int(slot_of[gi]), int(slot_of[gj])
        i, j = (si, sj) if si < sj else (sj, si)
        gsize[gi] += gsize[gj]
        rows.append((i, j, float(h), float(gsize[gi])))
        slot_of[gi] = i

    merges = np.asarray(rows, np.float32).reshape(-1, 4)
    return dg.canonical_order(merges, n=n, rtol=1e30)


def _landmark_merges(Xl: np.ndarray, method: str, metric: str, dev) -> np.ndarray:
    """The landmarks' own dendrogram, canonical over subindices ``0…k−1``."""
    from repro_torch.core.api import build_distance_matrix

    k = Xl.shape[0]
    if k < 2:
        return np.zeros((0, 4), np.float32)
    if Xl.ndim == 2 and method in POINTS_METHODS and metric == "sqeuclidean":
        res = nn_chain_from_points(Xl, method, device=dev)
        # the chain builds no matrix: account it by its measured trips
        record_queries(int(res.iters) * k, "landmark_chain")
    else:
        # k² queries, recorded by the builder
        Dl = (pairwise_cosine(torch.as_tensor(Xl, device=dev)) if metric == "cosine"
              else build_distance_matrix(Xl, metric, device=dev))
        res = nn_chain(Dl, method, device=dev)
    if int(res.n_merges) != k - 1:
        raise RuntimeError(
            "landmark chain hit its iteration cap before finishing — "
            "the input likely contains NaNs"
        )
    return dg.canonical_order(res.merges.cpu().numpy(), n=k)


def landmark_cluster(
    X,
    method: str = "ward",
    *,
    metric: str | None = None,
    n_landmarks: int | None = None,
    seed: int = 0,
    refine: int = 0,
    device=None,
) -> LandmarkResult:
    """Sub-quadratic approximate agglomeration of ``n`` objects on
    ``device`` (CUDA unless told otherwise).

    ``X`` is ``(n, d)`` points (or ``(n, atoms, 3)`` conformations with
    ``metric="rmsd"``); ``method`` a reducible linkage; ``metric`` one of
    :data:`LANDMARK_METRICS` (default: scipy's per-method convention).
    ``n_landmarks`` overrides :func:`default_landmark_count`, ``seed``
    pins the sample, ``refine ≥ 1`` adds centroid-reassignment passes
    (Euclidean metrics only).  The ``(n, n)`` matrix is never formed.
    """
    from repro_torch.service.assign import AssignIndex, assign

    if method not in REDUCIBLE_METHODS:
        raise ValueError(
            f"landmark tier clusters its landmarks with the NN-chain "
            f"engine, which needs a reducible method {REDUCIBLE_METHODS}; "
            f"got {method!r}"
        )
    metric = metric or default_metric(method)
    if metric not in LANDMARK_METRICS:
        raise ValueError(
            f"landmark tier assigns through the streaming labeler, which "
            f"scores {LANDMARK_METRICS}; got metric={metric!r}"
        )
    X = np.asarray(X, np.float32)
    if metric == "rmsd":
        if X.ndim != 3 or X.shape[-1] != 3:
            raise ValueError(
                f"metric='rmsd' expects (n, atoms, 3) conformations, got {X.shape}"
            )
    elif X.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {X.shape}")
    if refine < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    if refine and metric not in _CENTROID_METRICS:
        raise ValueError(
            f"the refinement pass reassigns against group centroids, which "
            f"only exist for {_CENTROID_METRICS}; got metric={metric!r} "
            "(use refine=0)"
        )
    dev = resolve_device(device)
    n = int(X.shape[0])
    if n < 2:
        return LandmarkResult(
            merges=np.zeros((0, 4), np.float32),
            n_merges=np.int32(0),
            landmarks=np.arange(n, dtype=np.int64),
            group_labels=np.zeros(n, np.int64),
        )
    k = default_landmark_count(n) if n_landmarks is None else int(n_landmarks)
    landmarks = sample_landmarks(n, k, seed)
    Xl = X[landmarks]
    lm_canonical = _landmark_merges(Xl, method, metric, dev)

    mask = np.ones(n, bool)
    mask[landmarks] = False
    rest = np.flatnonzero(mask)
    Xr = X[rest]
    reps = Xl
    if len(rest):
        labels_rest = assign(AssignIndex(reps=reps, metric=metric, kind="landmark"), Xr,
                             device=dev)
        for _ in range(refine):
            # group centroid = mean of the landmark and its members; a
            # landmark stays pinned to its own group, so none goes empty
            sums = reps.copy()
            counts = np.ones(k, np.float32)
            np.add.at(sums, labels_rest, Xr)
            np.add.at(counts, labels_rest, 1.0)
            reps = sums / counts[:, None]
            labels_rest = assign(AssignIndex(reps=reps, metric=metric, kind="centroid"), Xr,
                                 device=dev)
    else:
        labels_rest = np.zeros((0,), np.int64)

    attach_d = _attach_distances(Xr, reps[labels_rest], metric)
    merges = _assemble_merges(n, landmarks, rest, labels_rest, attach_d, lm_canonical)

    group_labels = np.empty(n, np.int64)
    group_labels[landmarks] = np.arange(k)
    group_labels[rest] = labels_rest
    return LandmarkResult(
        merges=merges,
        n_merges=np.int32(merges.shape[0]),
        landmarks=landmarks.astype(np.int64),
        group_labels=group_labels,
    )
