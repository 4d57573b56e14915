"""Serial (single-device) Lance-Williams clustering in torch.

Counterpart of :mod:`repro.core.lance_williams`: the serial composition of
the merge loop (:mod:`repro_torch.core.engine`) — premasked dense storage,
a row-min argmin or the cached row minima of a ``variant``, and the
recurrence of :func:`repro_torch.core.linkage.update_row`, all plain torch.
It launches no hand-written kernel.  Merges equal the JAX package's
serial backend's.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import (
    LWResult,
    check_knobs,
    resolve_compaction,
    resolve_device,
    resolve_n_steps,
    run_dense,
    symmetrize,
)
from repro_torch.core.linkage import default_metric

__all__ = ["LWResult", "lance_williams", "lance_williams_from_points"]


def lance_williams(
    D,
    method: str = "complete",
    *,
    variant: str = "baseline",
    stop_at_k: int = 1,
    distance_threshold: float | None = None,
    compaction: bool | str = "auto",
    device=None,
) -> LWResult:
    """Run serial Lance-Williams clustering on an ``(n, n)`` distance matrix
    (or its upper triangle), copied to ``device`` (CUDA unless told
    otherwise); the caller's array is not modified.

    ``method``, ``variant``, ``stop_at_k`` and ``distance_threshold`` are
    the JAX package's knobs (documented once, in
    :func:`repro.core.api.cluster`).  ``compaction`` resolves as there
    (:func:`repro_torch.core.engine.resolve_compaction`): ``"auto"``, the
    default, stages the run whenever :func:`~repro_torch.core.engine.plan_stages`
    gives more than one stage; the merges are those of the unstaged run,
    bit for bit.
    """
    check_knobs(method, variant)
    dev = resolve_device(device)
    D = symmetrize(torch.as_tensor(D, dtype=torch.float32, device=dev))
    n = D.shape[0]
    n_steps = resolve_n_steps(n, stop_at_k)
    return run_dense(
        D,
        torch.ones(n, dtype=torch.bool, device=dev),
        method=method,
        n_steps=n_steps,
        variant=variant,
        distance_threshold=distance_threshold,
        compaction=resolve_compaction(compaction, n, n_steps),
    )


def lance_williams_from_points(X, method: str = "complete", metric: str = "auto",
                               **kwargs) -> LWResult:
    """Build the distance matrix from ``(n, d)`` points, then cluster.

    ``metric='auto'`` defers to :func:`repro_torch.core.linkage.default_metric`
    (squared Euclidean for the geometric methods, plain Euclidean
    otherwise, matching scipy's convention).
    """
    from repro_torch.core.api import build_distance_matrix

    if metric == "auto":
        metric = default_metric(method)
    D = build_distance_matrix(X, metric, device=kwargs.get("device"))
    return lance_williams(D, method=method, **kwargs)
