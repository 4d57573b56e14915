"""Analytic work counts of the port's kernels and programs.

The counterpart of :mod:`repro.roofline.hlo_cost`.  The JAX package
counts the work of a compiled program from its optimized HLO text; the
port compiles no HLO, so each kernel entry's work is counted here in
closed form from the shapes (and, where the work depends on the data, the
counts that this run's data needs): the bytes it must move, each input
read once and each output written once, and the operations it must do.
These are the formulas of ``chip_smoke.py``'s bound column (PERF.md §6),
one count for each entry, whatever implements it: the CUDA kernel, its
plain torch twin or a library call.

Every entry returns a :class:`Cost`.  ``live``, ``stale`` and ``changed``
of a batch entry are per lane (anything ``torch.as_tensor`` takes) and
the entry sums its lanes.  Collective bytes follow the reference's ring
model (:func:`wire_bytes`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Cost:
    """Operations, device-memory bytes and collective wire bytes of some
    work; ``+`` adds two, ``*`` by a number scales one."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes, self.coll_bytes + o.coll_bytes)

    def __mul__(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m, self.coll_bytes * m)

    __rmul__ = __mul__


def wire_bytes(op: str, out_bytes: int, g: int) -> float:
    """Bytes a rank puts on the wire for one collective of ``op`` whose
    output holds ``out_bytes`` over a ring of ``g`` ranks (the reference's
    ring model, ``_wire_bytes`` of ``repro/roofline/hlo_cost.py``)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return out_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


def _lanes(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


# --- B1: the masked first minimum ---------------------------------------------


def masked_argmin(n: int, live) -> Cost:
    """B1's single entry on an ``n``-slot matrix with ``live`` live slots:
    read the live submatrix and the liveness, write one value and one
    index; one compare a live cell."""
    return Cost(flops=live * live, bytes=4 * live * live + n + 12)


def masked_argmin_batch(n: int, live) -> Cost:
    """B1's batch form: :func:`masked_argmin` summed over the lanes."""
    L = _lanes(live)
    return Cost(flops=float((L * L).sum()), bytes=float((4 * L * L + n + 12).sum()))


# --- B2: the fused LW step ----------------------------------------------------


def lw_step(n: int, live) -> Cost:
    """B2's step with ``live`` slots live after the merge: read the live
    submatrix, write row and column i, read the sizes and the liveness,
    write each row's (min, first column); a compare and a select a live
    cell, about a dozen operations for the recurrence of each lane."""
    return Cost(flops=2 * live * live + 12 * n, bytes=4 * live * live + 8 * live + 17 * n)


def lw_merge_batch(n: int, live) -> Cost:
    """B2's batch form and its merge entry (the main path), which do the
    step's work: :func:`lw_step` summed over the lanes."""
    L = _lanes(live)
    return Cost(flops=float((2 * L ** 2 + 12 * n).sum()),
                bytes=float((4 * L ** 2 + 8 * L + 17 * n).sum()))


# --- B3: the LW row update ----------------------------------------------------


def lw_update(method: str, n: int, live: int) -> Cost:
    """B3's per-row entry for ``method`` with ``live`` kept lanes of
    ``n``: the bool mask read and the row written on every lane; rows i
    and j (and, for ward, the sizes) read on the kept lanes only; and of
    the merge scalars only those the method's coefficients use (D(i,j)
    always, n_i and n_j for the size-weighted methods).  About ten
    operations a kept lane."""
    per_kept = 12 if method == "ward" else 8
    scalars = 12 if method in ("average", "centroid", "ward") else 4
    return Cost(flops=10 * live, bytes=5 * n + per_kept * live + scalars)


def _lazy_bytes(n: int, stale, changed):
    return 33 * n + 12 * changed + stale * (4 * n + 12)


def lazy_merge(n: int, live, stale, changed) -> Cost:
    """B3's resident lazy merge (the merge and the rescan) with ``stale``
    rows to rescan and ``changed`` cache entries rewritten by its update
    (the columns whose cached minimum the invalidation lowers, and row i):
    rows i and j, alive, sizes and both caches read once (25 n), row and
    column i written (8 n), both caches written for each changed entry
    and each stale row (12 each), and each stale row read (4 n).  Where a
    kernel lists its stale rows is its own choice, and not counted."""
    return Cost(flops=12 * live + 2 * stale * n, bytes=_lazy_bytes(n, stale, changed))


def lazy_merge_batch(n: int, live, stale, changed) -> Cost:
    """B3's batch form: :func:`lazy_merge` summed over the lanes."""
    L, s, c = _lanes(live), _lanes(stale), _lanes(changed)
    return Cost(flops=float((12 * L + 2 * s * n).sum()), bytes=float(_lazy_bytes(n, s, c).sum()))


# --- B4 and B5: squared Euclidean distances -----------------------------------


def pairwise_sq_euclidean(n: int, m: int, d: int) -> Cost:
    """B4's ``(n, d) × (m, d) → (n, m)``: read X and Y once, write the
    matrix; a multiply and an add per element of the product (the norms
    and the epilogue are O(n m + (n + m) d) more)."""
    return Cost(flops=2 * n * m * d, bytes=4 * (n * d + m * d + n * m))


def row_sq_euclidean(m: int, d: int) -> Cost:
    """B5's row entry: read Y and x once, write the row; a subtract, a
    multiply and an add an element."""
    return Cost(flops=3 * m * d, bytes=4 * (m * d + m + d))


def chain_vote(m: int, d: int) -> Cost:
    """B5's vote entry on a rank's ``(m, d)`` block: read the block, the
    sizes, alive and the tip once, write the triple; a subtract, a
    multiply and an add an element and the summary distance a row."""
    return Cost(flops=3 * m * d + 5 * m, bytes=4 * (m * d + m + d) + m + 12)


def chain_trip(m: int, d: int) -> Cost:
    """B5's trip entry, one trip of the matrix-free chain over ``(m, d)``
    summaries: the summaries read once, ward's one per-slot scalar (the
    sizes; u for average and weighted), the liveness bitmask, and O(d) for
    the tip and a merge's two rows read and one written."""
    return Cost(flops=3 * m * d + 8 * m, bytes=4 * m * d + 4 * m + m / 8 + 16 * d)


# --- the baselines ------------------------------------------------------------


def lloyd_step(n: int, k: int, d: int) -> Cost:
    """One Lloyd iteration of k-means on ``(n, d)`` points and ``k``
    centroids: the points read once, the centroids read and written; the
    Gram product (2 n k d), its epilogue and the argmin (4 n k) and the
    per-cluster sums (n d)."""
    return Cost(flops=2 * n * k * d + 4 * n * k + n * d, bytes=4 * n * d + 8 * k * d)


# --- programs -----------------------------------------------------------------


def lw_merge_loop(n: int, n_steps: int, stages=None) -> Cost:
    """A Lance-Williams merge loop of ``n`` slots and ``n_steps`` merges
    over the stage schedule ``stages`` (``((size, steps), ...)``, as
    :func:`repro_torch.core.engine.plan_stages` gives it; unstaged when
    ``None``): one seed a stage on the stage's live slots, then each merge
    a step (:func:`lw_step`) at the stage's size and the live width it
    leaves, ``n - k - 1`` after merge ``k``."""
    total, done = Cost(), 0
    for size, steps in stages or ((n, n_steps),):
        total = total + masked_argmin(size, n - done)
        total = total + lw_merge_batch(size, n - done - 1 - torch.arange(steps))
        done += steps
    return total


def nn_chain(n: int, trips: int, d: int = 0, method: str = "ward") -> Cost:
    """An NN chain of ``n`` items that makes ``trips`` trips: on ``(n, d)``
    points (``d > 0``) each trip is B5's (:func:`chain_trip`); on a matrix
    each trip reads the tip's row and the liveness (5 n bytes, n compares)
    and each of the ``n - 1`` merges updates a row (:func:`lw_update` of
    ``method`` over every slot)."""
    if d:
        return trips * chain_trip(n, d)
    return trips * Cost(flops=n, bytes=5 * n) + max(n - 1, 0) * lw_update(method, n, n)
