"""The kernel-backend entry point of the merge loop.

Counterpart of :func:`repro.kernels.ops.lance_williams_kernelized`.  The
TPU wrappers padded every matrix to a 128-lane multiple and picked
interpret mode off the TPU; the CUDA kernels take the raw ``n`` and mask
their own ragged edge, so neither is needed here.
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
