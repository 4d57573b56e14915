# Copy of src/repro/core/naive.py (numpy only). The port keeps its own copy because
# importing anything under repro.* imports jax.
"""Reference oracles for Lance-Williams clustering (pure numpy, no JAX).

Two independent oracles back the test suite:

* :func:`naive_lw` — a line-by-line numpy mirror of the masked-matrix
  algorithm (same slot semantics, same row-major tie-breaking).  Used to
  validate the JAX serial engine, the distributed engine and the Pallas
  kernels step-for-step.

* :func:`definition_oracle` — computes each merge **from the linkage
  definition itself** (e.g. complete linkage = max over all cross-cluster
  point pairs of the *original* matrix), with no LW recurrence at all.
  Agreement proves the recurrence implementation, not just its porting.
"""

from __future__ import annotations

import numpy as np

_DEF_METHODS = ("single", "complete", "average", "centroid", "ward")


def _coeffs(method: str, n_i: float, n_j: float, n_k: np.ndarray):
    one = np.ones_like(n_k, dtype=np.float64)
    if method == "single":
        return 0.5 * one, 0.5 * one, 0.0 * one, -0.5 * one
    if method == "complete":
        return 0.5 * one, 0.5 * one, 0.0 * one, 0.5 * one
    if method == "average":
        t = n_i + n_j
        return (n_i / t) * one, (n_j / t) * one, 0.0 * one, 0.0 * one
    if method == "weighted":
        return 0.5 * one, 0.5 * one, 0.0 * one, 0.0 * one
    if method == "centroid":
        t = n_i + n_j
        return (n_i / t) * one, (n_j / t) * one, (-(n_i * n_j) / t**2) * one, 0.0 * one
    if method == "median":
        return 0.5 * one, 0.5 * one, -0.25 * one, 0.0 * one
    if method == "ward":
        t = n_i + n_j + n_k
        return (n_i + n_k) / t, (n_j + n_k) / t, -n_k / t, 0.0 * one
    raise ValueError(method)


def naive_lw(D: np.ndarray, method: str = "complete") -> np.ndarray:
    """Numpy mirror of the serial engine.  Returns ``(n-1, 4)`` merges."""
    D = np.array(D, dtype=np.float64)
    n = D.shape[0]
    D = np.triu(D, 1) if not np.any(np.tril(D, -1)) else D
    D = 0.5 * (D + D.T)
    np.fill_diagonal(D, 0.0)
    alive = np.ones(n, bool)
    sizes = np.ones(n)
    merges = np.zeros((n - 1, 4))
    for t in range(n - 1):
        Dm = np.where(alive[:, None] & alive[None, :] & ~np.eye(n, dtype=bool), D, np.inf)
        flat = int(np.argmin(Dm))           # row-major first minimum, as in JAX
        r, c = divmod(flat, n)
        i, j = min(r, c), max(r, c)
        dmin = Dm[r, c]
        a_i, a_j, b, g = _coeffs(method, sizes[i], sizes[j], sizes)
        new = a_i * D[:, i] + a_j * D[:, j] + b * dmin + g * np.abs(D[:, i] - D[:, j])
        keep = alive.copy()
        keep[[i, j]] = False
        new = np.where(keep, new, 0.0)
        D[i, :] = new
        D[:, i] = new
        D[i, i] = 0.0
        alive[j] = False
        merges[t] = (i, j, dmin, sizes[i] + sizes[j])
        sizes[i] += sizes[j]
        sizes[j] = 0.0
    return merges


def definition_oracle(
    D: np.ndarray, method: str = "complete", X: np.ndarray | None = None
) -> np.ndarray:
    """Brute-force agglomeration straight from each linkage's *definition*.

    ``single``/``complete``/``average`` need only the original matrix ``D``;
    ``centroid``/``ward`` need the original points ``X`` (and assume ``D``
    holds **squared** Euclidean distances).  Returns ``(n-1, 4)`` merges in
    the same slot convention as :func:`naive_lw`.
    """
    if method not in _DEF_METHODS:
        raise ValueError(f"definition oracle supports {_DEF_METHODS}, not {method}")
    D0 = np.array(D, dtype=np.float64)
    n = D0.shape[0]
    D0 = np.triu(D0, 1) if not np.any(np.tril(D0, -1)) else D0
    D0 = 0.5 * (D0 + D0.T)
    members: list[list[int] | None] = [[a] for a in range(n)]
    merges = np.zeros((n - 1, 4))

    def cluster_dist(A: list[int], B: list[int]) -> float:
        block = D0[np.ix_(A, B)]
        if method == "single":
            return float(block.min())
        if method == "complete":
            return float(block.max())
        if method == "average":
            return float(block.mean())
        assert X is not None, "centroid/ward need the original points"
        ca, cb = X[A].mean(0), X[B].mean(0)
        sq = float(((ca - cb) ** 2).sum())
        if method == "centroid":
            return sq
        # ward merge cost (in squared-distance units, matching the recurrence
        # seeded with squared Euclidean): (2·na·nb/(na+nb)) · ‖ca − cb‖²
        na, nb = len(A), len(B)
        return 2.0 * na * nb / (na + nb) * sq

    for t in range(n - 1):
        best, bi, bj = np.inf, -1, -1
        for i in range(n):
            if members[i] is None:
                continue
            for j in range(i + 1, n):
                if members[j] is None:
                    continue
                d = cluster_dist(members[i], members[j])
                if d < best:
                    best, bi, bj = d, i, j
        merges[t] = (bi, bj, best, len(members[bi]) + len(members[bj]))
        members[bi] = members[bi] + members[bj]
        members[bj] = None
    return merges
