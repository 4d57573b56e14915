"""The kernel-backend entry point of the merge loop.

Counterpart of :func:`repro.kernels.ops.lance_williams_kernelized`.  The
TPU wrappers padded every matrix to a 128-lane multiple and picked
interpret mode off the TPU; the CUDA kernels take the raw ``n`` and mask
their own ragged edge, so neither is needed here.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import (
    VARIANTS,
    LWResult,
    resolve_device,
    resolve_n_steps,
    run_kernel,
    symmetrize,
)
from repro_torch.core.linkage import METHODS


def _check(method: str, variant: str, distance_threshold, compaction) -> None:
    """Validate the engine knobs; those the port does not run yet raise
    ``NotImplementedError`` naming the ROADMAP.md item."""
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    if variant != "baseline":
        raise NotImplementedError(
            f"variant={variant!r} (cached row minima) is not ported yet: "
            "ROADMAP.md A1.2, rowmin/lazy with kernel B3"
        )
    if distance_threshold is not None:
        raise NotImplementedError(
            "distance_threshold (a device-side loop exit) is not ported yet: ROADMAP.md A1.1"
        )
    if compaction is True:
        raise NotImplementedError("compaction is not ported yet: ROADMAP.md A1.3")
    if compaction is not False and compaction != "auto":
        raise ValueError(f"compaction must be 'auto', False or True, got {compaction!r}")


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
    """Serial LW with the hand-written CUDA kernels as inner loops.

    ``D`` is an ``(n, n)`` distance matrix (or its upper triangle), copied
    to ``device`` (CUDA unless told otherwise) and symmetrized; the
    caller's array is not modified.  Merge indices equal those of the JAX
    package's kernel and serial backends; heights agree to float
    tolerance.  ``compaction="auto"`` runs without compaction: the merges
    are the same either way.
    """
    _check(method, variant, distance_threshold, compaction)
    dev = resolve_device(device)
    D = symmetrize(torch.as_tensor(D, dtype=torch.float32, device=dev))
    n = D.shape[0]
    return run_kernel(
        D,
        torch.ones(n, dtype=torch.bool, device=dev),
        method=method,
        n_steps=resolve_n_steps(n, stop_at_k),
    )
