"""The public wrappers of the kernel backend: the merge loop and the
pairwise distance build.

Counterpart of :func:`repro.kernels.ops.lance_williams_kernelized` and
:func:`repro.kernels.ops.pairwise`.  The TPU wrappers padded every operand
to a 128-lane multiple and picked interpret mode off the TPU; the CUDA
kernels take the raw sizes and mask their own ragged edges, so neither is
needed here.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import (
    LWResult,
    check_knobs,
    resolve_device,
    resolve_n_steps,
    run_kernel,
    symmetrize,
)
from repro_torch.kernels.pairwise import pairwise_sq_euclidean


def lance_williams_kernelized(
    D,
    method: str = "complete",
    *,
    variant: str = "baseline",
    stop_at_k: int = 1,
    distance_threshold: float | None = None,
    compaction: bool | str = "auto",
    device=None,
) -> LWResult:
    """Serial LW with the hand-written CUDA kernels as inner loops: the
    fused step kernel for ``baseline``/``rowmin``, the row-update kernel
    for ``lazy``.

    ``D`` is an ``(n, n)`` distance matrix (or its upper triangle), copied
    to ``device`` (CUDA unless told otherwise) and symmetrized; the
    caller's array is not modified.  Merge indices equal those of the JAX
    package's kernel and serial backends; heights agree to float
    tolerance.  ``compaction="auto"`` runs without compaction: the merges
    are the same either way.
    """
    check_knobs(method, variant, compaction)
    dev = resolve_device(device)
    D = symmetrize(torch.as_tensor(D, dtype=torch.float32, device=dev))
    n = D.shape[0]
    return run_kernel(
        D,
        torch.ones(n, dtype=torch.bool, device=dev),
        method=method,
        n_steps=resolve_n_steps(n, stop_at_k),
        variant=variant,
        distance_threshold=distance_threshold,
    )


def pairwise(X: torch.Tensor, Y: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared-Euclidean distances through kernel B4, on ``X``'s
    device (the plain version for a CPU tensor).

    Cast to float32 first, as the reference is, so no other type reaches
    the kernel.  With ``Y=None`` the diagonal is whatever the Gram form
    gives, not zeroed: the reference kernel route's contract, unlike
    :func:`repro_torch.core.distance.pairwise_sq_euclidean`.  Records no
    distance queries, as the reference's jitted route does not.
    """
    X = torch.as_tensor(X, dtype=torch.float32).contiguous()
    Y = X if Y is None else torch.as_tensor(Y, dtype=torch.float32, device=X.device).contiguous()
    return pairwise_sq_euclidean(X, Y)
