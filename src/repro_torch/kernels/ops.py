"""The public wrappers of the kernel backend: the merge loop, its batched
form over a shape bucket, and the pairwise distance build.

Counterpart of :func:`repro.kernels.ops.lance_williams_kernelized`,
:func:`repro.kernels.ops.lance_williams_kernelized_batch` and
:func:`repro.kernels.ops.pairwise`.  The TPU wrappers padded every operand
to a 128-lane multiple and picked interpret mode off the TPU; the CUDA
kernels take the raw sizes and mask their own ragged edges, so neither is
needed here.  The TPU package batches its kernels through ``vmap``; here
each kernel of the batched loop has an explicit lane axis.
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
from repro_torch.core.batch_engine import run_kernel_batch
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


def lance_williams_kernelized_batch(
    Db,
    n_real,
    *,
    method: str = "complete",
    n_steps: int,
    variant: str = "baseline",
    distance_threshold: float | None = None,
    compaction: bool | str = "auto",
    device=None,
) -> LWResult:
    """Batched serial LW with the batch-grid CUDA kernels as inner loops:
    ``B`` stacked problems merge in lockstep
    (:func:`repro_torch.core.batch_engine.run_kernel_batch`).

    ``Db`` is ``(B, n, n)`` stacked matrices, copied to ``device`` (CUDA
    unless told otherwise) and symmetrized lane by lane; lane ``b``'s slots
    ``>= n_real[b]`` are dead from the start.  Returns ``(B, n_steps, 4)``
    merges and ``(B,)`` merge counts, on the device: lane ``b``'s rows
    past its count are not its merges (the scheduler slices them off).
    Each lane's merges equal :func:`lance_williams_kernelized` on its own
    matrix bit for bit.  ``compaction`` resolves on the bucket's size
    (:func:`resolve_kernel_compaction`).
    """
    check_knobs(method, variant)
    dev = resolve_device(device)
    Db = torch.as_tensor(Db, dtype=torch.float32, device=dev)
    if Db.ndim != 3 or Db.shape[1] != Db.shape[2]:
        raise ValueError(f"expected a (B, n, n) bucket of distance matrices, got "
                         f"{tuple(Db.shape)}")
    n = Db.shape[-1]
    n_real = torch.as_tensor(n_real, dtype=torch.int64, device=dev)
    if n_real.shape != Db.shape[:1]:
        raise ValueError(f"n_real must be ({Db.shape[0]},) to match the bucket, got "
                         f"{tuple(n_real.shape)}")
    return run_kernel_batch(
        symmetrize(Db), torch.arange(n, device=dev) < n_real[:, None],
        method=method, n_steps=n_steps, variant=variant,
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
