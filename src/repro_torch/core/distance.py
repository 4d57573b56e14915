"""Distance-matrix builders for points input, in torch.

Counterpart of the Euclidean builders of :mod:`repro.core.distance`
(Gram form ``‖x‖² + ‖y‖² − 2·x·yᵀ``).  The JAX package computes them in
jnp, outside any Pallas kernel, so the product here is ``torch.matmul``.
"""

from __future__ import annotations

import torch


def pairwise_sq_euclidean(X: torch.Tensor, Y: torch.Tensor | None = None) -> torch.Tensor:
    """``D[a, b] = ‖X[a] − Y[b]‖²`` via the Gram trick, on ``X``'s device."""
    self_dist = Y is None
    X = torch.as_tensor(X, dtype=torch.float32)
    Y = X if Y is None else torch.as_tensor(Y, dtype=torch.float32, device=X.device)
    xx = torch.sum(X * X, dim=-1)
    yy = torch.sum(Y * Y, dim=-1)
    # TF32 keeps ~10 mantissa bits: its cancellation error in ‖x‖²+‖y‖²−2x·y
    # is far above the 1e-4 height tolerance and can reorder merges, so the
    # product runs in full fp32 whatever the caller's setting is.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        G = X @ Y.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    D = xx[:, None] + yy[None, :] - 2.0 * G
    D = torch.clamp_min(D, 0.0)  # clamp the tiny negatives from cancellation
    if self_dist:                # exact zeros on the diagonal
        D.fill_diagonal_(0.0)
    return D


def pairwise_euclidean(X: torch.Tensor, Y: torch.Tensor | None = None) -> torch.Tensor:
    return torch.sqrt(pairwise_sq_euclidean(X, Y))
