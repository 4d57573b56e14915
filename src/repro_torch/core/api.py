"""Public clustering API of the port.

Counterpart of :mod:`repro.core.api`, for the parts this port runs: the
NN-chain engine (dense, and matrix-free on points) behind the default
knobs, the Lance-Williams merge loop on the serial and kernel backends,
the landmark tier, the two-phase tier, the paper's distributed LW loop
and the sharded matrix-free chain over the ranks of a
``torch.distributed`` group (``backend="distributed"``), and
:func:`cluster_batch` for many small problems at once (shape buckets on
the serial and kernel backends, or whole problems dealt to the ranks).
``cluster(...)`` takes raw ``(n, d)`` points, ``(n, atoms, 3)``
conformations (``metric="rmsd"``) or a pre-built ``(n, n)`` distance
matrix, resolves ``algorithm``/``backend``/``matrix_free`` and the
landmark knobs as the JAX package's ``cluster`` does (its device count
read as the default process group's world size), and returns a
:class:`ClusterResult`.  The knobs are documented once, in
:func:`repro.core.api.cluster`.
"""

from __future__ import annotations

import warnings
from collections.abc import Sequence
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import dendrogram as dg
from repro_torch.core.batched import BatchStats, batch_ring, bucket_n, cluster_batch_merges
from repro_torch.core.distance import pairwise_euclidean, pairwise_rmsd, pairwise_sq_euclidean
from repro_torch.core.distributed import (
    distributed_lance_williams,
    distributed_nn_chain_from_points,
    group_size,
    require_ring_mesh,
    two_phase_from_points,
)
from repro_torch.core.engine import resolve_device, symmetrize
from repro_torch.core.linkage import METHODS, default_metric
from repro_torch.core.nnchain import (
    POINTS_METHODS,
    nn_chain,
    nn_chain_from_points,
    resolve_algorithm,
    resolve_batch_algorithm,
    resolve_matrix_free,
)


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


def check_points(X, metric: str) -> np.ndarray:
    """``X`` as an array, after the checks :func:`build_distance_matrix`
    makes of its points and metric (raises ``ValueError``)."""
    X = np.asarray(X)
    if metric == "rmsd":
        if X.ndim != 3 or X.shape[-1] != 3:
            raise ValueError("rmsd metric expects (n, atoms, 3) conformations")
        return X
    if X.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {X.shape}")
    if metric not in ("euclidean", "sqeuclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    return X


def build_distance_matrix(X, metric: str = "euclidean", *, device=None) -> torch.Tensor:
    """``(n, d)`` points (``(n, atoms, 3)`` conformations for ``rmsd``) →
    ``(n, n)`` float32 distances on ``device``."""
    X = check_points(X, metric)
    if metric == "rmsd":
        return pairwise_rmsd(torch.as_tensor(X, dtype=torch.float32,
                                             device=resolve_device(device)))
    Xt = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
    return pairwise_euclidean(Xt) if metric == "euclidean" else pairwise_sq_euclidean(Xt)


def _interpret_input(data, method: str, metric: str | None,
                     is_distance: bool | None = None):
    """A square 2-D array with ``metric is None`` is a pre-built distance
    matrix; anything else is points embedded via *metric* (default:
    :func:`repro_torch.core.linkage.default_metric`).  ``is_distance``
    settles the square case explicitly; left ``None``, a non-symmetric
    square array gets a ``UserWarning``.

    Returns ``(D, points, metric_used)``: the matrix and ``None, None``
    for matrix input, ``None`` and the points and metric for points input.
    The matrix of points is not built here (the JAX package's
    ``materialize=False``): the matrix-free chain is chosen before any
    ``(n, n)`` tensor exists, and the caller builds one when it needs it.
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
    return None, arr, metric


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
    matrix_free: bool | str = "auto",
    keep_inputs: bool = True,
    n_landmarks: int | None = None,
    seed: int = 0,
    refine: int = 0,
    mesh=None,
    device=None,
) -> ClusterResult:
    """Hierarchically cluster *data*.

    ``data`` is an ``(n, n)`` distance matrix when square and ``metric is
    None``, else ``(n, d)`` points embedded via ``metric``.  The knobs
    resolve as in :func:`repro.core.api.cluster`: ``backend="auto"`` is
    ``"distributed"`` when a default process group of more than one rank
    is up (for the LW loop: an explicit ``algorithm="nnchain"``,
    ``"twophase"`` or ``"landmark"`` keeps ``"serial"``), else
    ``"serial"``; ``algorithm="auto"`` runs the NN-chain engine for
    reducible methods at ``n ≥ 256`` with default engine knobs,
    matrix-free (no ``(n, n)`` tensor) under ``matrix_free="auto"`` for
    ``(n, d)`` points of ``ward``/``average``/``weighted`` on the
    squared-Euclidean metric at
    ``n ≥ 4096``.  The chain runs the full agglomeration; ``stop_at_k``
    and ``distance_threshold`` cut its canonical merge list afterwards.
    Otherwise the LW merge loop runs: in plain torch on the serial
    backend, on the CUDA kernels on ``backend="kernel"``, or row-sharded
    over the ranks of ``mesh`` (:func:`repro_torch.core.distributed.require_ring_mesh`;
    the default group's ring when ``None``, its device the ring's) on
    ``backend="distributed"``
    (:func:`repro_torch.core.distributed.distributed_lance_williams`: every
    rank calls ``cluster`` with the same arguments and gets the serial
    backend's merges), each with every ``variant``, ``stop_at_k``,
    ``distance_threshold`` and ``compaction``.
    ``compaction`` (LW only) is the JAX package's stage schedule: pack the
    live rows into a half-size matrix each time the live count halves,
    merges unchanged bit for bit.  ``"auto"`` (the default), ``True`` and
    ``"on"`` stage whenever the plan has more than one stage (the serial
    backend halves down to 32 slots, the kernel backend down to 256);
    ``False``, ``None`` and ``"off"`` run unstaged; anything else raises
    ``ValueError``.  The chain ignores the knob, and a value other than
    ``"auto"`` or ``None`` steers ``algorithm="auto"`` to the LW loop, as
    in the JAX package.
    ``algorithm="landmark"`` runs the landmark tier
    (:func:`repro_torch.core.landmark.landmark_cluster`) on points or
    conformations, with ``n_landmarks``, ``seed`` and ``refine``; an
    explicit ``n_landmarks`` or ``refine`` makes ``"auto"`` mean it and
    contradicts any other explicit engine.  ``backend="distributed"`` with
    ``algorithm="nnchain"`` is the sharded matrix-free chain
    (:func:`repro_torch.core.distributed.distributed_nn_chain_from_points`
    over the ranks of ``mesh``): ``(n, d)`` points of a
    ``ward``/``average``/``weighted`` run under the squared-Euclidean
    convention, no matrix kept (``distances`` is ``None``); anything else
    raises the JAX package's ``ValueError``.  ``algorithm="twophase"`` is
    the approximate two-phase tier
    (:func:`repro_torch.core.distributed.two_phase_from_points`: as many
    shards as the default group has ranks, each clustered in this
    process): ``(n, d)`` points of a ``ward``/``average``/``weighted``
    run under the squared-Euclidean convention, on ``backend="serial"``
    (``"auto"``) or ``"distributed"``, no matrix kept.
    ``device`` defaults to CUDA and raises without it; ``device="cpu"``
    runs the plain torch versions of the kernels.
    ``keep_inputs`` stores the input on the result (for
    ``exemplars``/``centroids``).
    """
    from repro_torch.core.lance_williams import lance_williams
    from repro_torch.kernels.ops import lance_williams_kernelized

    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    ring = None
    if mesh is not None:
        ring = require_ring_mesh(mesh, device)
        device = ring.device
    dev = resolve_device(device)
    D, points, used_metric = _interpret_input(data, method, metric, is_distance)
    n = int((D if points is None else points).shape[0])

    if matrix_free not in (True, False, None, "auto"):
        raise ValueError(f"matrix_free must be a bool or 'auto', got {matrix_free!r}")
    if matrix_free not in (None, "auto"):
        matrix_free = bool(matrix_free)
    if matrix_free is True:
        # matrix-free belongs to the chain: never build the (n, n) matrix
        # the caller opted out of
        if algorithm == "lw":
            raise ValueError(
                "matrix_free=True requires the NN-chain engine, but "
                "algorithm='lw' pins the Lance-Williams loop (every LW "
                "backend stores the dense matrix)"
            )
        if algorithm == "auto":
            algorithm = "nnchain"
    if n_landmarks is not None or refine != 0:
        # the landmark knobs name the landmark tier, as matrix_free=True
        # names the chain
        if algorithm == "auto":
            algorithm = "landmark"
        elif algorithm != "landmark":
            raise ValueError(
                f"n_landmarks/refine belong to the landmark tier, but "
                f"algorithm={algorithm!r} pins a different engine"
            )
    if algorithm == "landmark":
        return _cluster_landmark(points, method, used_metric, backend, stop_at_k,
                                 distance_threshold, keep_inputs, n_landmarks, seed,
                                 refine, dev)
    if backend not in ("auto", "serial", "distributed", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        # an explicit nnchain/twophase request owns the backend choice: its
        # default composition is the serial chain
        backend = ("distributed" if algorithm not in ("nnchain", "twophase") and group_size() > 1
                   else "serial")
    points_capable = (points is not None and points.ndim == 2
                      and method in POINTS_METHODS and used_metric == "sqeuclidean")
    if algorithm == "twophase":
        return _cluster_two_phase(points, method, used_metric, backend, points_capable,
                                  stop_at_k, distance_threshold, keep_inputs, dev)
    algorithm = resolve_algorithm(algorithm, method=method, backend=backend, n=n,
                                  variant=variant, compaction=compaction)

    if algorithm == "nnchain":
        if backend == "distributed":
            # the sharded matrix-free chain is the only distributed chain:
            # it needs the points capability, and matrix_free=False
            # contradicts it
            if matrix_free is False or not points_capable:
                raise ValueError(
                    "backend='distributed' with algorithm='nnchain' is the sharded "
                    "matrix-free chain: it needs (n, d) points input, a method from "
                    f"{POINTS_METHODS} under the squared-Euclidean convention, and "
                    f"matrix_free left on (got method={method!r}, metric={used_metric!r}, "
                    f"matrix_free={matrix_free!r}, input shape "
                    f"{None if points is None else points.shape}) — use algorithm='lw' "
                    "for the dense row-sharded engine"
                )
            res = distributed_nn_chain_from_points(points, method,
                                                   ring or require_ring_mesh(None, dev))
        elif resolve_matrix_free(matrix_free,
                                 points_shape=None if points is None else points.shape,
                                 method=method, metric=used_metric, n=n):
            res = nn_chain_from_points(points, method, device=dev)
        else:
            if points is not None:
                D = build_distance_matrix(points, used_metric, device=dev)
            res = nn_chain(D, method, device=dev)
        if n > 1 and res.n_merges != n - 1:
            raise RuntimeError(
                "NN-chain loop stopped before finishing — the input likely "
                "contains NaNs (the chain invariant needs a total order on "
                "distances)"
            )
        merges = dg.truncate_canonical(
            dg.canonical_order(res.merges.cpu().numpy(), n=n),
            n, stop_at_k, distance_threshold,
        )
    else:
        if points is not None:
            D = build_distance_matrix(points, used_metric, device=dev)
        stops = dict(stop_at_k=stop_at_k, distance_threshold=distance_threshold,
                     compaction=compaction)
        if backend == "distributed":
            res = distributed_lance_williams(D, method, ring or require_ring_mesh(None, dev),
                                             variant, **stops)
        else:
            run_lw = lance_williams if backend == "serial" else lance_williams_kernelized
            res = run_lw(D, method=method, variant=variant, device=dev, **stops)
        merges = res.merges[: res.n_merges].cpu().numpy()
    return ClusterResult(
        merges=merges,
        method=method,
        backend=backend,
        algorithm=algorithm,
        n_leaves=n,
        points=points if keep_inputs else None,
        distances=D if keep_inputs else None,
        metric=used_metric,
    )


def _cluster_landmark(points, method, metric, backend, stop_at_k, distance_threshold,
                      keep_inputs, n_landmarks, seed, refine, dev) -> ClusterResult:
    """``cluster(..., algorithm="landmark")``: validate, run the tier, and
    truncate its canonical merges."""
    from repro_torch.core.landmark import LANDMARK_METRICS, landmark_cluster

    if points is None:
        raise ValueError(
            "algorithm='landmark' samples landmarks from coordinates "
            "and assigns the rest through the streaming labeler: it "
            "needs (n, d) points or (n, atoms, 3) conformations, not "
            "a pre-built distance matrix (which already paid the "
            "Ω(n²) evaluations this tier exists to avoid)"
        )
    if metric not in LANDMARK_METRICS:
        raise ValueError(
            f"algorithm='landmark' supports metrics {LANDMARK_METRICS} "
            f"(the assignment labeler's), got {metric!r}"
        )
    backend = "serial" if backend == "auto" else backend
    if backend != "serial":
        raise ValueError(
            f"algorithm='landmark' is single-device (the whole point "
            f"is that n·k work fits one host), got backend={backend!r}"
        )
    n = int(points.shape[0])
    res = landmark_cluster(points, method, metric=metric, n_landmarks=n_landmarks,
                           seed=seed, refine=refine, device=dev)
    # heights are already monotone-repaired and canonical: only truncate
    merges = dg.truncate_canonical(res.merges, n, stop_at_k, distance_threshold)
    return ClusterResult(
        merges=merges,
        method=method,
        backend=backend,
        algorithm="landmark",
        n_leaves=n,
        points=points if keep_inputs else None,
        distances=None,
        metric=metric,
    )


def _cluster_two_phase(points, method, metric, backend, points_capable, stop_at_k,
                       distance_threshold, keep_inputs, dev) -> ClusterResult:
    """``cluster(..., algorithm="twophase")``: validate, run the tier over
    the default group's world size of shards, and truncate its canonical
    merges."""
    if not points_capable:
        raise ValueError(
            "algorithm='twophase' shards points and agglomerates "
            "geometric summaries: it needs (n, d) points input and a "
            f"method from {POINTS_METHODS} under the squared-"
            f"Euclidean convention; got method={method!r}, "
            f"metric={metric!r}, "
            f"input shape {None if points is None else points.shape}"
        )
    if backend not in ("serial", "distributed"):
        raise ValueError(
            f"algorithm='twophase' supports backend='serial'/"
            f"'distributed', got {backend!r}"
        )
    n = int(points.shape[0])
    res = two_phase_from_points(points, method, device=dev)
    # heights are already monotone-repaired and canonical: only truncate
    merges = dg.truncate_canonical(res.merges.numpy(), n, stop_at_k, distance_threshold)
    return ClusterResult(
        merges=merges,
        method=method,
        backend=backend,
        algorithm="twophase",
        n_leaves=n,
        points=points if keep_inputs else None,
        distances=None,
        metric=metric,
    )


@dataclass
class BatchResult(Sequence):
    """Results of a :func:`cluster_batch` call: one :class:`ClusterResult`
    per problem, in input order, and the scheduler's :class:`BatchStats`."""

    results: list[ClusterResult]
    stats: BatchStats

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, idx):
        return self.results[idx]

    def labels(self, k: int) -> list[np.ndarray]:
        """Per-problem flat labels for ``k`` clusters, ``k`` clamped per
        problem to ``[1, n_b]`` and up to an early-stopped problem's stop
        level; ``k <= 0`` raises."""
        if k <= 0:
            raise ValueError(f"k must be a positive cluster count, got {k}")
        return [r.labels(max(1, min(k, r.n), r.n - r.n_merges)) for r in self.results]


def cluster_batch(
    problems: Sequence,
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
    keep_inputs: bool = False,
    mesh=None,
    device=None,
) -> BatchResult:
    """Cluster many independent problems, one batched engine call a shape
    bucket (:func:`repro_torch.core.batched.cluster_batch_merges`).

    Each problem is read as :func:`cluster` reads its ``data``; sizes may
    be ragged.  The knobs resolve as in :func:`repro.core.api.cluster_batch`:
    ``backend="auto"`` is ``"distributed"`` when a default process group of
    more than one rank is up (unless ``algorithm="nnchain"``), else
    ``"serial"`` (plain torch over each bucket); ``"kernel"`` runs the
    batch-grid CUDA kernels; ``"distributed"`` deals each bucket's whole
    problems to the ranks of ``mesh`` (the default group's ring when
    ``None``, its device the ring's), each rank running the serial engine
    on its share, and one ``all_gather`` a bucket gives every rank every
    result;
    ``algorithm="auto"`` keeps dense buckets on the LW loop and sends
    matrix-free buckets (``(n, d)`` points under the squared-Euclidean
    convention: ward, or average/weighted with ``metric="sqeuclidean"``)
    of at least :data:`~repro_torch.core.nnchain.NNCHAIN_BATCH_AUTO_MIN_N`
    to the batched NN chain, whose lists come back height-sorted.  On the
    LW loop every problem's merges equal ``cluster(problems[b], method,
    algorithm="lw", backend=<the same>, ...)`` bit for bit (the serial
    backend's for ``"distributed"``).  ``device`` defaults to CUDA;
    ``device="cpu"`` runs the kernels' plain versions.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    if backend == "auto":
        # an explicit nnchain request owns the backend choice (it is a
        # single-device engine), as in cluster()
        backend = "distributed" if algorithm != "nnchain" and group_size() > 1 else "serial"
    if backend not in ("serial", "distributed", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    ring = None
    if backend == "distributed":
        ring = batch_ring(mesh, device)
        device = ring.device
    dev = resolve_device(device)

    interps = [_interpret_input(data, method, metric, is_distance) for data in problems]
    # a matrix-free capable problem whose bucket resolves to nnchain ships
    # its points; every other problem builds its matrix here, on the device
    matrices, points_list, algos, sizes = [], [], [], []
    for D, pts, used_metric in interps:
        n_b = int((D if pts is None else pts).shape[0])
        sizes.append(n_b)
        capable = (pts is not None and pts.ndim == 2 and method in POINTS_METHODS
                   and used_metric == "sqeuclidean")
        algo_b = resolve_batch_algorithm(
            algorithm, method=method, engine=backend, bucket_n=bucket_n(max(n_b, 2)),
            variant=variant, compaction=compaction, points_capable=capable,
        )
        algos.append(algo_b)
        if algo_b == "nnchain" and capable:
            matrices.append(None)
            points_list.append(np.asarray(pts, np.float32))
        else:
            matrices.append(D if pts is None else build_distance_matrix(pts, used_metric,
                                                                         device=dev))
            points_list.append(None)

    merge_lists, stats = cluster_batch_merges(
        matrices, method, engine=backend, variant=variant, stop_at_k=stop_at_k,
        distance_threshold=distance_threshold, compaction=compaction, algorithm=algorithm,
        points=points_list, mesh=ring, device=dev,
    )
    results = [
        ClusterResult(
            merges=np.asarray(m), method=method, backend=backend, algorithm=algo,
            n_leaves=n_b, points=pts if keep_inputs else None,
            distances=mat if (keep_inputs and mat is not None) else None, metric=used_metric,
        )
        for m, mat, algo, n_b, (_, pts, used_metric)
        in zip(merge_lists, matrices, algos, sizes, interps)
    ]
    return BatchResult(results=results, stats=stats)
