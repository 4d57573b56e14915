# Copy of src/repro/core/dendrogram.py (numpy only). The port keeps its own copy because
# importing anything under repro.* imports jax.
"""Dendrogram utilities: merge list → tree / labels / linkage matrix.

The engines emit a ``(n-1, 4)`` *merge list* in slot convention —
``(i, j, dist, new_size)`` with ``i < j``, slot ``i`` keeping the union —
which is exactly the paper's "output the current tree level" step.  This
module is the host-side post-processing: conversion to a scipy-style
linkage matrix, flat cluster extraction at any level ``k`` (the paper's
"look k levels down the tree"), and tree invariant checks used by the
property tests.  Pure numpy; nothing here is performance-critical.
"""

from __future__ import annotations

import numpy as np


def _leaf_count(merges: np.ndarray, n: int | None) -> int:
    """Number of leaves.  ``n`` must be given for early-stopped runs,
    whose merge lists are shorter than ``n - 1``."""
    m = merges.shape[0]
    if n is None:
        return m + 1
    if not m <= n - 1:
        raise ValueError(f"{m} merges is too many for n={n} leaves")
    return n


def to_linkage_matrix(merges: np.ndarray, n: int | None = None) -> np.ndarray:
    """Convert slot-convention merges to a scipy-style linkage matrix ``Z``.

    Row ``t`` of ``Z`` is ``(id_a, id_b, dist, size)`` where ids ``< n`` are
    leaves and id ``n + t`` names the cluster created at step ``t``.  For
    an early-stopped run pass the leaf count ``n`` explicitly; ``Z`` then
    has one row per performed merge (a truncated forest).

    Vectorized (the reference walks the merges in a Python loop): the id
    in slot ``s`` before merge ``t`` is ``n + t'`` for the last merge
    ``t' < t`` that kept its union in slot ``s``, or ``s`` itself when there
    is none.  One stable sort of the kept slots orders the writes by
    ``(slot, step)``, and one ``searchsorted`` finds each read's last
    earlier write; ``Z`` equals the loop's bit for bit.
    """
    merges = np.asarray(merges)
    n = _leaf_count(merges, n)
    m = merges.shape[0]
    Z = np.zeros((m, 4))
    if m == 0:
        return Z
    ij = np.rint(merges[:, :2]).astype(np.int64)
    order = np.argsort(ij[:, 0], kind="stable")        # writes by (slot, step)
    keys = ij[order, 0] * (m + 1) + order
    reads = ij * (m + 1) + np.arange(m)[:, None]         # slot s before merge t
    last = np.searchsorted(keys, reads, side="left") - 1
    hit = last >= 0
    hit[hit] = ij[order[last[hit]], 0] == ij[hit]
    ids = np.where(hit, n + order[np.maximum(last, 0)], ij)
    Z[:, 0] = ids.min(axis=1)
    Z[:, 1] = ids.max(axis=1)
    Z[:, 2] = merges[:, 2]
    Z[:, 3] = merges[:, 3]
    return Z


def cut(merges: np.ndarray, k: int, n: int | None = None) -> np.ndarray:
    """Flat labels for ``k`` clusters — apply the first ``n-k`` merges.

    Labels are contiguous ints in ``[0, k)`` ordered by first appearance.
    For an early-stopped run pass ``n`` explicitly; ``k`` can then reach
    down only to the stop level ``n - len(merges)``.
    """
    merges = np.asarray(merges)
    n = _leaf_count(merges, n)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if n - k > merges.shape[0]:
        raise ValueError(
            f"cannot cut at k={k}: this run stopped early after "
            f"{merges.shape[0]} merges (k >= {n - merges.shape[0]} required)"
        )
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for t in range(n - k):
        i, j = int(round(merges[t, 0])), int(round(merges[t, 1]))
        parent[find(j)] = find(i)

    roots = np.array([find(a) for a in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    # re-index by first appearance for determinism
    order = {}
    out = np.empty(n, np.int64)
    for a, lab in enumerate(labels):
        if lab not in order:
            order[lab] = len(order)
        out[a] = order[lab]
    return out


def cut_exemplars(
    merges: np.ndarray, k: int, D: np.ndarray, n: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Cut at ``k`` clusters and pick one *exemplar* (medoid) per cluster.

    ``D`` is the ``(n, n)`` distance matrix the tree was built from.
    Returns ``(labels, exemplars)`` where ``exemplars[c]`` is the leaf of
    cluster ``c`` minimizing the summed distance to the cluster's other
    members (ties go to the lowest leaf index).  The exemplars are the
    per-cluster representatives the streaming-assignment service exports
    (:mod:`repro.service.assign`): a new point is labeled by one
    pairwise-distance call against ``k`` exemplars instead of a full
    re-cluster.
    """
    D = np.asarray(D)
    labels = cut(merges, k, n=n)
    if D.shape != (labels.size, labels.size):
        raise ValueError(
            f"distance matrix {D.shape} does not match n={labels.size} leaves"
        )
    exemplars = np.empty(k, np.int64)
    for c in range(k):
        members = np.flatnonzero(labels == c)
        sub = D[np.ix_(members, members)]
        exemplars[c] = members[int(np.argmin(sub.sum(axis=1)))]
    return labels, exemplars


def canonical_order(
    merges: np.ndarray,
    n: int | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-7,
) -> np.ndarray:
    """Rewrite a merge list into canonical (non-decreasing height) order.

    The NN-chain engine (:mod:`repro.core.nnchain`) emits merges in
    *chain* order; a **stable** sort by height produces exactly the
    sequence the LW loop emits for the same (tie-free) input — same
    slot pairs (a cluster's slot is the minimum leaf index of its
    members in both engines), heights to float tolerance — because for
    reducible methods a child merge never has a greater height than its
    parent, so the stable sort keeps every dependent pair in dependency
    order.

    Reducibility is exact in real arithmetic but only *approximate* in
    float32: duplicated/quantized points can give a parent merge a
    height one ulp **below** its child's (observed: parent 0.99999976
    under child 1.0 on 4× duplicated points), and a naive sort would
    then order the parent first and corrupt the tree.  So heights are
    first **dependency-clamped**: scanning in emission order, a merge
    whose height falls below the clusters it consumes by at most the
    ``rtol``/``atol`` float-noise budget is lifted to that height
    (within the engines' documented height tolerance); a drop *beyond*
    the budget is a genuine inversion (non-reducible input) and is left
    for :func:`validate_merges` to reject after the sort.  Already
    height-sorted input (every LW engine's output) passes through
    unchanged.
    """
    merges = np.array(merges, copy=True)         # input dtype preserved
    n = _leaf_count(merges, n)
    heights = merges[:, 2]
    real = heights.dtype.type                    # the budget's arithmetic, in the input's type
    # Python scalars in the loop (exact: every value is one of the input's
    # floats); the budget is computed in the input's type, as numpy would
    hs = heights.tolist()
    floor = [0.0] * n                    # height of the slot's current cluster
    for t, (i, j) in enumerate(np.rint(merges[:, :2]).astype(np.int64).tolist()):
        need = max(floor[i], floor[j])
        if hs[t] < need and real(hs[t]) >= real(need) - (atol + rtol * abs(real(need))):
            hs[t] = need         # float noise, not a real inversion
        floor[i] = hs[t]
    heights[:] = hs
    order = np.argsort(heights, kind="stable")
    out = merges[order]
    validate_merges(out, n=n)
    return out


def truncate_canonical(
    merges: np.ndarray,
    n: int,
    stop_at_k: int = 1,
    distance_threshold: float | None = None,
) -> np.ndarray:
    """Apply the LW loop's early-stop semantics to a *canonical* (height-
    sorted) full merge list: keep the first ``n − stop_at_k`` rows, then
    drop everything from the first merge above the threshold on.

    This is the post-hoc half of the NN-chain early-stop contract
    (``cluster``'s docstring): the chain engine always runs the full
    O(n²) agglomeration, and every consumer — the single-problem
    ``cluster`` path, the batched scheduler, the service batcher — cuts
    the :func:`canonical_order` output through this one function so the
    prefix matches what the LW loop's genuine early exit records.  The
    row count comes from the same
    :func:`repro.core.engine.resolve_n_steps` the LW loop trips on —
    one source of truth for the prefix contract.
    """
    from repro_torch.core.engine import resolve_n_steps

    merges = np.asarray(merges)[: resolve_n_steps(n, stop_at_k)]
    if distance_threshold is not None:
        above = merges[:, 2] > distance_threshold
        if above.any():
            merges = merges[: int(np.argmax(above))]
    return merges


def merge_leafsets(merges: np.ndarray, n: int | None = None) -> list[frozenset]:
    """Leaf members of the cluster each merge creates, in merge order.

    The clusters of a dendrogram form a laminar family, so each merge's
    leafset is unique — the list doubles as a canonical identity for
    order-insensitive comparison (:func:`merges_equivalent`).
    """
    merges = np.asarray(merges)
    n = _leaf_count(merges, n)
    members: list[set] = [{a} for a in range(n)]
    out: list[frozenset] = []
    for t in range(merges.shape[0]):
        i, j = int(round(merges[t, 0])), int(round(merges[t, 1]))
        members[i] = members[i] | members[j]
        out.append(frozenset(members[i]))
    return out


def merges_equivalent(
    a: np.ndarray,
    b: np.ndarray,
    n: int | None = None,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-5,
) -> bool:
    """True iff two merge lists describe the same dendrogram.

    Order-insensitive: each list is reduced to its set of created
    clusters (leafsets) with attached heights; the lists are equivalent
    when the cluster sets coincide and per-cluster heights agree to
    tolerance.  This is the cross-engine contract the NN-chain goldens
    assert (``tests/test_nnchain.py``, ``benchmarks/bench_nnchain.py``) —
    robust to both merge reordering and float-level height differences.
    """
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    ha = dict(zip(merge_leafsets(a, n), a[:, 2]))
    hb = dict(zip(merge_leafsets(b, n), b[:, 2]))
    if set(ha) != set(hb):
        return False
    va = np.array([ha[k] for k in sorted(ha, key=sorted)])
    vb = np.array([hb[k] for k in sorted(hb, key=sorted)])
    return bool(np.allclose(va, vb, rtol=rtol, atol=atol))


def merge_set_agreement(
    a: np.ndarray, b: np.ndarray, n: int | None = None
) -> float:
    """Fraction of created clusters two merge lists share, in ``[0, 1]``.

    Each list is reduced to its set of created leafsets
    (:func:`merge_leafsets`, heights ignored); the score is
    ``|A ∩ B| / max(|A|, |B|)`` — 1.0 iff the trees have identical
    structure.  This is the measured quality gate for the approximate
    tiers (:func:`repro.core.distributed.two_phase_from_points`): the
    two-phase dendrogram's agreement with the exact engine's is
    *reported* in ``benchmarks/bench_distributed.py`` / EXPERIMENTS.md
    rather than assumed.  Compare full runs of the same ``n`` — truncated
    prefixes score against whatever the other list built.
    """
    sa = set(merge_leafsets(a, n))
    sb = set(merge_leafsets(b, n))
    denom = max(len(sa), len(sb))
    return len(sa & sb) / denom if denom else 1.0


def _contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dense ``(ka, kb)`` contingency table of two label vectors."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        raise ValueError(
            f"label vectors must have equal length, got {a.shape} vs {b.shape}"
        )
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = int(ai.max(initial=-1)) + 1, int(bi.max(initial=-1)) + 1
    table = np.zeros((ka, kb), np.int64)
    np.add.at(table, (ai, bi), 1)
    return table


def adjusted_rand_index(a: np.ndarray, b: np.ndarray) -> float:
    """Adjusted Rand index between two flat labelings, in ``[-1, 1]``.

    Pair-counting agreement corrected for chance: 1.0 iff the labelings
    induce the same partition (invariant to label permutation), and
    ≈ 0 in expectation for two *independent* random labelings — which
    is exactly why the approximate-tier quality harness reports it
    alongside :func:`label_agreement` (a high raw agreement on a
    lopsided labeling can be chance; a high ARI cannot).  Pure numpy,
    O(n + ka·kb).
    """
    table = _contingency(a, b)
    n = table.sum()
    if n < 2:
        return 1.0

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(table.astype(np.float64)).sum()
    sum_a = comb2(table.sum(axis=1).astype(np.float64)).sum()
    sum_b = comb2(table.sum(axis=0).astype(np.float64)).sum()
    total = comb2(float(n))
    expected = sum_a * sum_b / total
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:       # both labelings trivial (all one cluster
        return 1.0                  # or all singletons): identical partitions
    return float((sum_ij - expected) / (max_index - expected))


def label_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of items whose labels agree under a greedy cluster match.

    Clusters of ``a`` are matched to clusters of ``b`` greedily by
    descending overlap (each cluster used at most once — deterministic:
    ties break on lowest cluster ids); the score is the matched overlap
    mass over ``n``, in ``[0, 1]``.  Invariant to label permutation and
    1.0 iff the partitions are identical.  This is the "did the
    approximate tier put the points in the same clusters" number the
    landmark gate asserts; report :func:`adjusted_rand_index` next to it
    for the chance-corrected view.
    """
    table = _contingency(a, b)
    n = table.sum()
    if n == 0:
        return 1.0
    flat = [
        (-int(table[i, j]), i, j)
        for i in range(table.shape[0])
        for j in range(table.shape[1])
        if table[i, j] > 0
    ]
    flat.sort()
    used_a: set[int] = set()
    used_b: set[int] = set()
    matched = 0
    for neg, i, j in flat:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        matched += -neg
    return matched / float(n)


def cut_label_agreement(
    merges_a: np.ndarray,
    merges_b: np.ndarray,
    k: int,
    n: int | None = None,
) -> float:
    """:func:`label_agreement` between the ``k``-cuts of two dendrograms.

    Cuts both merge lists at ``k`` clusters over the same ``n`` leaves
    and scores the flat partitions.  This is the *measured* quality gate
    of the approximate tiers (landmark, two-phase): the score against
    the exact engine's dendrogram is reported in
    ``benchmarks/bench_landmark.py`` / EXPERIMENTS.md §Perf-10 and
    asserted ≥ its floor in CI — never assumed.  Complements
    :func:`merge_set_agreement` (tree structure) with a
    partition-at-the-cut view, which is what the serving path (labels,
    exemplars, streaming assignment) actually exposes.
    """
    return label_agreement(cut(merges_a, k, n=n), cut(merges_b, k, n=n))


def merge_heights(merges: np.ndarray) -> np.ndarray:
    return np.asarray(merges)[:, 2]


def is_monotone(merges: np.ndarray, atol: float = 1e-5) -> bool:
    """True iff merge heights are non-decreasing.

    Guaranteed for single/complete/average/weighted/ward (reducible
    linkages); centroid/median may legally produce inversions.
    """
    h = merge_heights(merges)
    return bool(np.all(np.diff(h) >= -atol * np.maximum(1.0, np.abs(h[:-1]))))


def validate_merges(merges: np.ndarray, n: int | None = None) -> None:
    """Structural invariants every engine must satisfy (property tests).

    * each step merges two distinct live slots, ``i < j``
    * slot ``j`` never reappears after being tombstoned
    * sizes sum correctly (the final merge of a *full* run has size ``n``)
    """
    merges = np.asarray(merges)
    n = _leaf_count(merges, n)
    alive = [True] * n
    sizes = [1.0] * n
    # Python scalars in the loop: the slots rounded as round() rounds, the
    # recorded sizes exact as doubles
    rows = merges.reshape(-1, 4) if merges.size == 0 else merges
    slots = np.rint(rows[:, :2]).astype(np.int64).tolist()
    for t, ((i, j), recorded) in enumerate(zip(slots, rows[:, 3].astype(np.float64).tolist())):
        if not (0 <= i < j < n):
            raise AssertionError(f"step {t}: bad slot pair ({i}, {j})")
        if not (alive[i] and alive[j]):
            raise AssertionError(f"step {t}: merging dead slot ({i}, {j})")
        sizes[i] += sizes[j]
        if abs(sizes[i] - recorded) > 1e-3:
            raise AssertionError(
                f"step {t}: recorded size {merges[t, 3]} != {sizes[i]}"
            )
        alive[j] = False
    if n > 1 and merges.shape[0] == n - 1:   # full run: one cluster remains
        if abs(sizes[int(round(merges[-1, 0]))] - n) > 1e-3:
            raise AssertionError("final cluster does not contain all items")
