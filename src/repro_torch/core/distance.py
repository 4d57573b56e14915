"""Distance builders for points and conformations, in torch.

Counterpart of :mod:`repro.core.distance`:

* ``pairwise_sq_euclidean`` / ``pairwise_euclidean`` / ``pairwise_cosine``
  — Gram form ``‖x‖² + ‖y‖² − 2·x·yᵀ``, the product in full float32;
* ``kabsch_rmsd`` — optimal-superposition RMSD, batched over leading
  dimensions (3×3 SVDs);
* ``pairwise_rmsd_cross`` / ``pairwise_rmsd`` — the pair grid of it, in
  chunks of at most :data:`RMSD_CHUNK_PAIRS` pairs, so that the
  ``(pairs, 3, 3)`` covariance batch stays bounded.

The JAX package computes all of these in jnp, outside any Pallas kernel,
so they stay plain torch here; the Pallas ``pairwise`` kernel's
counterpart is :mod:`repro_torch.kernels.pairwise`.

**Distance-query accounting**, as in the JAX package:
:func:`count_distance_queries` opens a thread-local
:class:`DistanceBudget`, and each builder above records the pairs its
call evaluates under the reference's tags (``sq_euclidean``, ``cosine``,
``rmsd``).  The reference records only eager calls; its compiled loops
are accounted by their orchestrator (the landmark chain as ``iters × k``,
tag ``landmark_chain``).  The port's chain builds its row eagerly on
every trip, so the row build records nothing, and neither does the
kernel route :func:`repro_torch.kernels.ops.pairwise` (the reference's
is jitted): the budget by tag equals the JAX package's.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

#: Pairs of one chunk of the rmsd pair grid: 2^20 pairs hold 36 MiB of
#: covariances.
RMSD_CHUNK_PAIRS = 1 << 20


class DistanceBudget:
    """Tally of pairwise distance evaluations inside one accounting scope.

    ``queries`` is the total; ``by_tag`` breaks it down by call site
    (``sq_euclidean``, ``cosine``, ``rmsd``, plus the orchestrator tags
    like ``landmark_chain`` and ``attach``).  Budgets nest: every open
    scope on the thread sees every record.
    """

    def __init__(self) -> None:
        self.queries = 0
        self.by_tag: dict[str, int] = {}

    def record(self, n_pairs: int, tag: str = "pairwise") -> None:
        n = int(n_pairs)
        if n < 0:
            raise ValueError(f"cannot record {n} distance queries")
        self.queries += n
        self.by_tag[tag] = self.by_tag.get(tag, 0) + n

    def __repr__(self) -> str:  # helpful in failed-assert output
        tags = ", ".join(f"{k}={v}" for k, v in sorted(self.by_tag.items()))
        return f"DistanceBudget(queries={self.queries}, {{{tags}}})"


_BUDGETS = threading.local()


def _budget_stack() -> list:
    stack = getattr(_BUDGETS, "stack", None)
    if stack is None:
        stack = _BUDGETS.stack = []
    return stack


@contextmanager
def count_distance_queries():
    """Open a :class:`DistanceBudget` scope on this thread::

        with count_distance_queries() as budget:
            cluster(X, "ward", algorithm="landmark")
        assert budget.queries <= 3 * (n * k + k * k)
    """
    budget = DistanceBudget()
    stack = _budget_stack()
    stack.append(budget)
    try:
        yield budget
    finally:
        stack.remove(budget)


def record_queries(n_pairs: int, tag: str = "pairwise") -> None:
    """Record ``n_pairs`` distance evaluations on every open budget (a
    no-op when none is open)."""
    for budget in _budget_stack():
        budget.record(n_pairs, tag)


@contextmanager
def full_fp32_matmul():
    """Run matrix products in full float32 whatever the caller's setting:
    TF32 keeps ~10 mantissa bits, and its cancellation error in
    ``‖x‖² + ‖y‖² − 2·x·y`` is far above the 1e-4 height tolerance and can
    reorder merges."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _operands(X, Y):
    X = torch.as_tensor(X, dtype=torch.float32)
    Y = X if Y is None else torch.as_tensor(Y, dtype=torch.float32, device=X.device)
    return X, Y


def pairwise_sq_euclidean(X: torch.Tensor, Y: torch.Tensor | None = None) -> torch.Tensor:
    """``D[a, b] = ‖X[a] − Y[b]‖²`` via the Gram trick, on ``X``'s device:
    kernel B4's plain version, with exact zeros on the diagonal when
    ``Y`` is ``None``."""
    from repro_torch.kernels.pairwise import pairwise_sq_euclidean_plain

    self_dist = Y is None
    X, Y = _operands(X, Y)
    record_queries(X.shape[0] * Y.shape[0], "sq_euclidean")
    D = pairwise_sq_euclidean_plain(X, Y)
    if self_dist:
        D.fill_diagonal_(0.0)
    return D


def pairwise_euclidean(X: torch.Tensor, Y: torch.Tensor | None = None) -> torch.Tensor:
    return torch.sqrt(pairwise_sq_euclidean(X, Y))


def pairwise_cosine(X: torch.Tensor, Y: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine *distance* ``1 − cos_sim`` (for embedding dedup)."""
    X, Y = _operands(X, Y)
    record_queries(X.shape[0] * Y.shape[0], "cosine")
    Xn = X / torch.clamp_min(torch.linalg.vector_norm(X, dim=-1, keepdim=True), 1e-12)
    Yn = Y / torch.clamp_min(torch.linalg.vector_norm(Y, dim=-1, keepdim=True), 1e-12)
    with full_fp32_matmul():
        G = Xn @ Yn.T
    return torch.clamp(1.0 - G, 0.0, 2.0)


def _center(P: torch.Tensor) -> torch.Tensor:
    return P - torch.mean(P, dim=-2, keepdim=True)


def _rmsd_from_covariance(H: torch.Tensor, sq_a: torch.Tensor, sq_b: torch.Tensor,
                          atoms: int) -> torch.Tensor:
    """``rmsd² = (‖A‖² + ‖B‖² − 2·(σ₁ + σ₂ ± σ₃)) / atoms`` for a batch of
    centered cross-covariances ``H = Aᵀ B`` ``(..., 3, 3)``; σ₃'s sign is
    the reference's ``sign(det(V Uᵀ))``, so reflections are not allowed.
    Since ``det(H) = det(U)·σ₁σ₂σ₃·det(Vᵀ)``, that sign is ``sign(det(H))``
    wherever σ₃ > 0 (and where σ₃ = 0 it multiplies 0): only the singular
    values are computed, which on the CPU takes 40% of a full SVD's time."""
    S = torch.linalg.svdvals(H)
    d = torch.sign(torch.linalg.det(H))
    corr = S[..., 0] + S[..., 1] + d * S[..., 2]
    msd = (sq_a + sq_b - 2.0 * corr) / atoms
    return torch.sqrt(torch.clamp_min(msd, 0.0))


def kabsch_rmsd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Minimum RMSD between ``(..., atoms, 3)`` conformations, batched over
    the (broadcast) leading dimensions.

    Kabsch: with centered A, B and cross-covariance ``H = Aᵀ B`` (3×3),
    ``rmsd² = (‖A‖² + ‖B‖² − 2·(σ₁ + σ₂ ± σ₃)) / atoms``.
    """
    A = _center(torch.as_tensor(A, dtype=torch.float32))
    B = _center(torch.as_tensor(B, dtype=torch.float32, device=A.device))
    with full_fp32_matmul():
        H = A.transpose(-1, -2) @ B
    return _rmsd_from_covariance(H, (A * A).sum((-2, -1)), (B * B).sum((-2, -1)),
                                 A.shape[-2])


def _rmsd_grid(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(n, atoms, 3) × (m, atoms, 3) → (n, m)`` RMSD of centered
    conformations, a block of rows of the pair grid at a time."""
    n, atoms, _ = A.shape
    m = B.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=A.device)
    sq_a, sq_b = (A * A).sum((-2, -1)), (B * B).sum((-2, -1))
    rows = max(1, RMSD_CHUNK_PAIRS // max(m, 1))
    for r0 in range(0, n, rows):
        a = A[r0:r0 + rows]
        with full_fp32_matmul():
            H = torch.einsum("iap,jaq->ijpq", a, B)          # (rows, m, 3, 3)
        out[r0:r0 + rows] = _rmsd_from_covariance(H, sq_a[r0:r0 + rows, None], sq_b[None],
                                                  atoms)
    return out


def pairwise_rmsd_cross(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``(n, atoms, 3) × (m, atoms, 3) → (n, m)`` cross RMSD, on ``A``'s
    device: the streaming labeler scores new conformations against the
    ``k`` cluster exemplars with it."""
    A = torch.as_tensor(A, dtype=torch.float32)
    B = torch.as_tensor(B, dtype=torch.float32, device=A.device)
    record_queries(A.shape[0] * B.shape[0], "rmsd")
    return _rmsd_grid(_center(A), _center(B))


def pairwise_rmsd(confs: torch.Tensor) -> torch.Tensor:
    """``(n, atoms, 3)`` conformations → ``(n, n)`` optimal-superposition
    RMSD on their device: the paper's distance-matrix build for protein
    structures.  Symmetrized (SVD round-off) with a zero diagonal."""
    confs = _center(torch.as_tensor(confs, dtype=torch.float32))
    record_queries(confs.shape[0] ** 2, "rmsd")
    D = _rmsd_grid(confs, confs)
    D = 0.5 * (D + D.T)
    D.fill_diagonal_(0.0)
    return D
