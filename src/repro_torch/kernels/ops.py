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
    KERNEL_MIN_STAGE,
    LWResult,
    check_knobs,
    resolve_compaction,
    resolve_device,
    resolve_n_steps,
    run_kernel,
    symmetrize,
)
from repro_torch.kernels.pairwise import pairwise_sq_euclidean


def resolve_kernel_compaction(flag, n: int, n_steps: int) -> bool:
    """The kernel backend's compaction switch: :func:`resolve_compaction`
    over the plan that halves down to :data:`KERNEL_MIN_STAGE`.  The JAX
    package pads the plan to 128-lane multiples; the CUDA kernels take any
    ``n``, so this plan has no alignment."""
    return resolve_compaction(flag, n, n_steps, min_stage=KERNEL_MIN_STAGE)


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
    tolerance.  ``compaction`` (``True``/``"auto"``/``"on"``, or
    ``False``/``None``/``"off"``) runs the stage schedule whenever the
    kernel plan (:func:`resolve_kernel_compaction`) has more than one
    stage; the merges are those of the unstaged run, bit for bit.
    """
    check_knobs(method, variant)
    dev = resolve_device(device)
    D = symmetrize(torch.as_tensor(D, dtype=torch.float32, device=dev))
    n = D.shape[0]
    n_steps = resolve_n_steps(n, stop_at_k)
    return run_kernel(
        D,
        torch.ones(n, dtype=torch.bool, device=dev),
        method=method,
        n_steps=n_steps,
        variant=variant,
        distance_threshold=distance_threshold,
        compaction=resolve_kernel_compaction(compaction, n, n_steps),
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
