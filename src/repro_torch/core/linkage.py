"""Lance-Williams linkage coefficient table (paper Table 1), in torch.

Counterpart of :mod:`repro.core.linkage`.  The distance between a newly
merged cluster ``i ∪ j`` and any other cluster ``k`` is::

    D(k, i∪j) = a_i * D(k,i) + a_j * D(k,j) + b * D(i,j) + g * |D(k,i) - D(k,j)|

with coefficients ``(a_i, a_j, b, g)`` that depend on the linkage method
and, for the size-weighted methods, on the cluster sizes.  ``centroid``,
``median`` and ``ward`` assume squared Euclidean distances.

The CUDA step kernel (``csrc/lw_step.cu``) evaluates exactly these
operations in exactly this order, each rounded on its own, so that it
agrees bit for bit with the plain torch step built on :func:`update_row`.
"""

from __future__ import annotations

import torch

#: Canonical method names, ordered as in the paper's Table 1 (+ median).
METHODS: tuple[str, ...] = (
    "single",
    "complete",
    "average",
    "weighted",
    "centroid",
    "median",
    "ward",
)

#: Methods whose recurrences are exact in **squared** Euclidean distances.
GEOMETRIC_METHODS: tuple[str, ...] = ("centroid", "median", "ward")


def default_metric(method: str) -> str:
    """Squared Euclidean for the geometric methods, else Euclidean (scipy's
    convention for points input)."""
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}; pick from {METHODS}")
    return "sqeuclidean" if method in GEOMETRIC_METHODS else "euclidean"


def coefficients(method: str, n_i, n_j, n_k):
    """Return ``(a_i, a_j, b, g)`` for *method*, broadcast against ``n_k``.

    ``n_i``/``n_j`` are scalar cluster sizes (numbers or 0-d tensors),
    ``n_k`` a scalar or ``(n,)`` tensor of spectator sizes.  All
    arithmetic is float32 on ``n_k``'s device.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}; pick from {METHODS}")

    n_k = torch.as_tensor(n_k, dtype=torch.float32)
    n_i = torch.as_tensor(n_i, dtype=torch.float32, device=n_k.device)
    n_j = torch.as_tensor(n_j, dtype=torch.float32, device=n_k.device)
    zero = torch.zeros_like(n_k)
    half = torch.full_like(n_k, 0.5)

    if method == "single":
        return half, half, zero, zero - 0.5
    if method == "complete":
        return half, half, zero, zero + 0.5
    if method == "average":
        tot = n_i + n_j
        return (n_i / tot) + zero, (n_j / tot) + zero, zero, zero
    if method == "weighted":
        return half, half, zero, zero
    if method == "centroid":
        tot = n_i + n_j
        return (
            (n_i / tot) + zero,
            (n_j / tot) + zero,
            (-(n_i * n_j) / (tot * tot)) + zero,
            zero,
        )
    if method == "median":
        return half, half, zero - 0.25, zero
    # ward — the only method whose coefficients vary with the spectator size.
    tot = n_i + n_j + n_k
    return (n_i + n_k) / tot, (n_j + n_k) / tot, -n_k / tot, zero


def update_row(method: str, d_ki, d_kj, d_ij, n_i, n_j, n_k):
    """Apply the Lance-Williams recurrence to a whole row at once:
    ``D(k, i∪j)`` for every spectator ``k``."""
    a_i, a_j, b, g = coefficients(method, n_i, n_j, n_k)
    return a_i * d_ki + a_j * d_kj + b * d_ij + g * torch.abs(d_ki - d_kj)
