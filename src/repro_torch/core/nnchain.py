"""Nearest-neighbor-chain merge engine, in torch.

Counterpart of :mod:`repro.core.nnchain` for the serial chain: grow a
chain ``a → NN(a) → NN(NN(a)) → …`` until its top two clusters are mutual
nearest neighbors, merge them, and continue from the surviving chain.
Exact for the reducible methods (:data:`REDUCIBLE_METHODS`), in O(n²)
total work.  Merges come out in **chain order**; ``cluster()`` passes
them through :func:`repro_torch.core.dendrogram.canonical_order`.

Two compositions, one trip logic (ties to the previous element, then the
first index of the minimum; a NaN row stops the run):

* **dense** (:func:`nn_chain`) — the ``(n, n)`` matrix; a merge rewrites
  row *and* column ``i`` in place (the reference writes only row ``i``
  plus a version vector, because a column update copies the whole matrix
  on XLA:CPU; the values read back are the same).
* **points / matrix-free** (:func:`nn_chain_from_points`) — an O(n·d)
  geometric summary ``(w, u, size)`` per slot.  No ``(n, n)`` tensor
  exists.

:func:`nn_chain_from_summaries` runs the points composition from whole
clusters (sizes other than 1, scatter terms ``u``): phase 2 of the
two-phase tier (:func:`repro_torch.core.distributed.two_phase_from_points`).

The reference runs the chain as one ``lax.while_loop``.  The matrix-free
chain keeps its whole state on the device: each trip is one call of
:func:`repro_torch.kernels.pairwise.chain_trip` (one launch of kernel B5
on the card, its plain twin on the CPU), and on the card chunks of
:data:`CHAIN_GRAPH_TRIPS` trips replay as a CUDA graph with one read-back
of the counts a chunk (:func:`_resident_chain`).

The dense chain is driven from the host (:func:`_chain_loop`): the chain
stack is a Python list, each trip runs the row and its masked minimum on
the device and reads back one small tensor: the nearest neighbor of the
tip, which is the previous chain element when that one attains the
minimum (a merge) and otherwise the first index of the minimum (a push).
Merge records, sizes, liveness and the cluster representation stay on
the device.  The same loop over :func:`_points_nnchain_ops` is the
matrix-free chain's host-driven form, one row build a trip.

The batched chains (:func:`nn_chain_batched`,
:func:`nn_chain_batched_from_points`) run ``B`` lanes of a shape bucket in
lockstep, as the JAX package's ``vmap`` of the chain loop does: every
trip is one trip of every lane, plain torch over ``(B, n, n)`` matrices or
``(B, n, d)`` summaries (the reference's batched points chain builds its
row with jnp, not the Pallas kernel), each lane with its own chain stack
and done flag on the device; the flags are read back once every
:data:`CHAIN_GRAPH_TRIPS` trips.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device, symmetrize
from repro_torch.core.linkage import METHODS, update_row

#: Linkage methods satisfying the reducibility inequality — the ones the
#: NN-chain algorithm is exact for.  ``centroid``/``median`` can *invert*,
#: which breaks the chain invariant, so they stay on the LW loop.
REDUCIBLE_METHODS: tuple[str, ...] = (
    "single", "complete", "average", "weighted", "ward",
)

#: Methods the matrix-free points mode supports: their LW distance is an
#: exact function of the O(d) geometric summary on squared-Euclidean
#: input.  ``ward``'s default metric is already sqeuclidean; ``average``
#: and ``weighted`` need an explicit ``metric="sqeuclidean"``.
POINTS_METHODS: tuple[str, ...] = ("ward", "average", "weighted")

#: Smallest n for which ``algorithm="auto"`` prefers the NN-chain engine
#: over the dense LW loop (the JAX package's threshold).
NNCHAIN_AUTO_MIN_N = 256

#: Smallest n for which ``matrix_free="auto"`` drops the dense matrix on
#: capable inputs (the JAX package's threshold).
MATRIX_FREE_AUTO_MIN_N = 4096

#: Smallest *bucket* n for which batched ``algorithm="auto"`` sends a
#: matrix-free points bucket to the batched chain (the JAX package's
#: threshold; dense buckets stay on the LW loop).
NNCHAIN_BATCH_AUTO_MIN_N = 64

#: Trips of the matrix-free chain a captured CUDA graph replays; the loop
#: reads the counts back once a replay.
CHAIN_GRAPH_TRIPS = 256


class ChainResult(NamedTuple):
    """Output of a chain run.

    merges: ``(n_steps, 4)`` float32 rows ``(i, j, dist, new_size)`` in
        chain order, on the run's device.
    n_merges: merges recorded (``n − 1`` for a clean run).
    iters: chain-loop trips; each builds exactly one candidate row.  A
        clean run needs at most ``2(n−1)``; the cap is ``4n + 8``.
    """

    merges: torch.Tensor
    n_merges: int
    iters: int


# ---------------------------------------------------------------------------
# knob resolution (the `cluster` API defers here)
# ---------------------------------------------------------------------------


def resolve_algorithm(
    flag: str,
    *,
    method: str,
    backend: str,
    n: int,
    variant: str = "baseline",
    compaction=None,
) -> str:
    """Canonical ``algorithm=`` switch for a ``cluster`` call, as in the
    JAX package: ``"nnchain"`` needs a reducible method and a serial or
    distributed backend; ``"auto"`` picks nnchain only on the default-knob
    serial path (reducible method, ``n ≥`` :data:`NNCHAIN_AUTO_MIN_N`,
    baseline variant, untouched compaction)."""
    if flag == "lw":
        return "lw"
    if flag == "nnchain":
        if method not in REDUCIBLE_METHODS:
            raise ValueError(
                f"algorithm='nnchain' needs a reducible method "
                f"{REDUCIBLE_METHODS}, got {method!r} (centroid/median can "
                "produce inversions that break the chain invariant; use "
                "algorithm='lw')"
            )
        if backend not in ("auto", "serial", "distributed"):
            raise ValueError(
                f"algorithm='nnchain' has serial and distributed "
                f"compositions; backend={backend!r} keeps the LW merge "
                "loop (pass backend='serial'/'distributed' or "
                "algorithm='lw')"
            )
        return "nnchain"
    if flag != "auto":
        raise ValueError(
            f"algorithm must be 'auto', 'lw' or 'nnchain', got {flag!r}"
        )
    if (
        method in REDUCIBLE_METHODS
        and backend == "serial"
        and n >= NNCHAIN_AUTO_MIN_N
        and variant == "baseline"
        and compaction in (None, "auto")
    ):
        return "nnchain"
    return "lw"


def resolve_batch_algorithm(
    flag: str,
    *,
    method: str,
    engine: str,
    bucket_n: int,
    variant: str = "baseline",
    compaction="auto",
    points_capable: bool = False,
) -> str:
    """Canonical ``algorithm=`` switch for one batched bucket, as in the JAX
    package: ``"nnchain"`` needs a reducible method and the serial engine;
    ``"auto"`` picks the chain only for a matrix-free bucket
    (``points_capable``: ``(n, d)`` points under a :data:`POINTS_METHODS`
    squared-Euclidean convention) of at least
    :data:`NNCHAIN_BATCH_AUTO_MIN_N` on the default-knob serial path."""
    if flag == "lw":
        return "lw"
    if flag == "nnchain":
        if method not in REDUCIBLE_METHODS:
            raise ValueError(
                f"algorithm='nnchain' needs a reducible method "
                f"{REDUCIBLE_METHODS}, got {method!r} (centroid/median can "
                "produce inversions that break the chain invariant; use "
                "algorithm='lw')"
            )
        if engine not in ("auto", "serial"):
            raise ValueError(
                f"batched algorithm='nnchain' is the vmapped single-device "
                f"chain; engine={engine!r} keeps the LW merge loop (pass "
                "engine='serial' or algorithm='lw')"
            )
        return "nnchain"
    if flag != "auto":
        raise ValueError(
            f"algorithm must be 'auto', 'lw' or 'nnchain', got {flag!r}"
        )
    if (
        points_capable
        and method in POINTS_METHODS
        and engine == "serial"
        and bucket_n >= NNCHAIN_BATCH_AUTO_MIN_N
        and variant == "baseline"
        and compaction in (None, False, "auto")
    ):
        return "nnchain"
    return "lw"


def resolve_matrix_free(
    flag,
    *,
    points_shape: tuple | None,
    method: str,
    metric: str | None,
    n: int,
) -> bool:
    """Canonical ``matrix_free=`` switch for the nnchain path: ``True``
    demands the points mode (raises when the input or method cannot
    support it), ``False`` pins the dense matrix, ``"auto"`` goes
    matrix-free for ``(n, d)`` points under a :data:`POINTS_METHODS`
    method and the squared-Euclidean metric at ``n ≥``
    :data:`MATRIX_FREE_AUTO_MIN_N`."""
    capable = (
        points_shape is not None
        and len(points_shape) == 2
        and method in POINTS_METHODS
        and metric == "sqeuclidean"
    )
    if flag in (False, None):
        return False
    if flag is True:
        if not capable:
            raise ValueError(
                "matrix_free=True needs (n, d) points input and a method "
                f"whose LW distance is a geometric-summary function "
                f"({POINTS_METHODS}, squared-Euclidean metric); got "
                f"method={method!r}, metric={metric!r}, "
                f"input shape {points_shape}"
            )
        return True
    if flag != "auto":
        raise ValueError(
            f"matrix_free must be a bool or 'auto', got {flag!r}"
        )
    return capable and n >= MATRIX_FREE_AUTO_MIN_N


# ---------------------------------------------------------------------------
# the ONE chain loop
# ---------------------------------------------------------------------------


class NNState(NamedTuple):
    """The device side of the chain loop's carry, updated in place.

    ``rep`` is the cluster representation: ``(D,)`` for the dense
    composition, ``(W, u)`` geometric summaries for points mode.
    ``alive`` is the ``(n,)`` bool liveness, ``sizes`` the ``(n,)``
    float32 cluster sizes.  The chain stack, the trip and merge counts
    live on the host, in :func:`_chain_loop`.
    """

    rep: tuple
    alive: torch.Tensor
    sizes: torch.Tensor


class NNChainOps(NamedTuple):
    """The two primitives a chain-loop composition supplies.

    row:   ``(state, top) -> (n,)`` raw distances from slot ``top`` to
           every slot, one O(n) (dense) / O(n·d) (points) pass on the
           device.  The loop masks dead slots and ``top`` itself.
    merge: ``(state, i, j, dmin, top, row_top) -> None``: commit the merge
           of slots ``i < j`` into ``state.rep`` in place, leaving
           ``alive``/``sizes`` to the loop.  ``row_top`` is this trip's
           raw row of ``top``; ``dmin`` the merge height, a 0-d tensor.
    """

    row: Callable[[NNState, int], torch.Tensor]
    merge: Callable[..., None]


def _chain_loop(ops: NNChainOps, state: NNState, n_steps: int) -> ChainResult:
    """Run the NN-chain loop until ``n_steps`` merges are recorded.

    Each trip either extends the chain by the tip's nearest neighbor or
    merges the top two elements when they are mutual nearest neighbors.
    Ties go to the previous chain element (an equality at the tip IS
    reciprocity, and it rules out tie cycles), otherwise to the first
    index of the minimum.  An empty chain restarts at the first live
    slot.  A row whose minimum is NaN has no candidate: the loop stops
    there, short of ``n_steps`` merges.
    """
    alive, sizes = state.alive, state.sizes
    n = alive.shape[0]
    dev = alive.device
    merges = torch.zeros((max(n_steps, 0), 4), dtype=torch.float32, device=dev)
    if n_steps <= 0:
        return ChainResult(merges=merges, n_merges=0, iters=0)
    live = alive.cpu().numpy().copy()      # host mirror, kept in step with `alive`
    ks = torch.arange(n, device=dev)
    chain: list[int] = []
    pairs: list[tuple[int, int]] = []      # merged slots, written to `merges` at the end
    iters = 0
    while len(pairs) < n_steps and iters < 4 * n + 8:
        if not chain:
            chain.append(int(np.argmax(live)))             # first live slot
        top = chain[-1]
        row_raw = ops.row(state, top)
        row = torch.where(alive, row_raw, torch.inf)
        row[top] = torch.inf
        m = row.min()
        c = torch.where(row == m, ks, n).min()             # first index of the minimum
        if len(chain) >= 2:                                # the previous element wins ties
            c = torch.where(row[chain[-2]] == m, chain[-2], c)
        c = c.item()                                       # the one read-back of the trip
        iters += 1
        if len(chain) >= 2 and c == chain[-2]:             # mutual nearest neighbors
            i, j = min(top, c), max(top, c)
            new_size = sizes[i] + sizes[j]
            ops.merge(state, i, j, m, top, row_raw)
            merges[len(pairs), 2:] = torch.stack((m, new_size))
            sizes[i] = new_size
            sizes[j] = 0.0
            alive[j] = False
            live[j] = False
            pairs.append((i, j))
            del chain[-2:]
        elif c == n:                                       # NaN row: no candidate
            break
        else:
            chain.append(c)
    if pairs:
        merges[: len(pairs), :2] = torch.tensor(pairs, dtype=torch.float32, device=dev)
    return ChainResult(merges=merges, n_merges=len(pairs), iters=iters)


def _init_state(rep: tuple, n: int, device, sizes=None) -> NNState:
    """Fresh carry: every slot live, of size 1 (leaves) or of ``sizes``
    (whole clusters, kept, not copied)."""
    if sizes is None:
        sizes = torch.ones(n, dtype=torch.float32, device=device)
    return NNState(rep=rep, alive=torch.ones(n, dtype=torch.bool, device=device), sizes=sizes)


# ---------------------------------------------------------------------------
# dense composition
# ---------------------------------------------------------------------------


def _dense_nnchain_ops(method: str) -> NNChainOps:
    """Dense primitives: a row is a view of ``D``; a merge writes the
    recurrence into row and column ``i`` in place, dead cells 0."""

    def row(s: NNState, top: int) -> torch.Tensor:
        return s.rep[0][top]

    def merge(s: NNState, i, j, dmin, top, row_top) -> None:
        (D,) = s.rep
        # {i, j} == {top, c}: top's row was read this trip
        row_c = D[j if top == i else i]
        d_ki, d_kj = (row_top, row_c) if top == i else (row_c, row_top)
        new = update_row(method, d_ki, d_kj, dmin, s.sizes[i], s.sizes[j], s.sizes)
        new = new.masked_fill(~s.alive, 0.0)       # dead cells inert
        new[i] = 0.0
        new[j] = 0.0
        D[i] = new
        D[:, i] = new

    return NNChainOps(row=row, merge=merge)


def nn_chain(D, method: str = "complete", *, device=None) -> ChainResult:
    """Full agglomeration of an ``(n, n)`` distance matrix (or its upper
    triangle) via NN-chain, on ``device`` (CUDA unless told otherwise).

    The caller's matrix is not modified.  Merges are in chain order; the
    canonicalized list matches the LW engine's on tie-free input.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    if method not in REDUCIBLE_METHODS:
        raise ValueError(
            f"nn_chain is exact only for reducible methods "
            f"{REDUCIBLE_METHODS}, got {method!r}"
        )
    dev = resolve_device(device)
    D = torch.as_tensor(D, dtype=torch.float32, device=dev)
    if D.ndim != 2 or D.shape[0] != D.shape[1]:
        raise ValueError(f"distance matrix must be square, got {tuple(D.shape)}")
    n = D.shape[0]
    state = _init_state((symmetrize(D),), n, dev)
    return _chain_loop(_dense_nnchain_ops(method), state, n - 1)


# ---------------------------------------------------------------------------
# matrix-free points composition
# ---------------------------------------------------------------------------


def summary_distance(method, sq, u_k, u_top, n_k, n_top):
    """LW distance from geometric summaries, given ``sq = ‖w_top − w_k‖²``
    (the reference's operation order)."""
    if method == "ward":
        return 2.0 * n_top * n_k / (n_top + n_k) * sq
    return sq + u_k + u_top                     # average / weighted


def summary_merge(method, w_i, w_j, u_i, u_j, n_i, n_j):
    """Merge two geometric summaries; returns ``(w_new, u_new)``."""
    tot = n_i + n_j
    if method != "ward":                    # ward's u stays 0: no gap needed
        gap = torch.sum((w_i - w_j) ** 2)
    if method == "weighted":                # WPGMA midpoint recursion
        w_new = 0.5 * (w_i + w_j)
        u_new = 0.5 * (u_i + u_j) + 0.25 * gap
    elif method == "average":               # size-weighted centroid + scatter
        w_new = (n_i * w_i + n_j * w_j) / tot
        u_new = (n_i * u_i + n_j * u_j) / tot + (n_i * n_j) / (tot * tot) * gap
    else:                                   # ward: centroid only, u ≡ 0
        w_new = (n_i * w_i + n_j * w_j) / tot
        u_new = torch.zeros((), dtype=torch.float32, device=w_i.device)
    return w_new, u_new


def _points_nnchain_ops(method: str, row_sq=None) -> NNChainOps:
    """Geometric-summary primitives: the O(n·d) squared-norm row goes
    through ``row_sq`` (default: the row kernel's dispatch, which takes
    the plain version for CPU tensors), the rest is O(n) epilogue; a
    merge rewrites summary ``i`` (O(d))."""
    if row_sq is None:
        from repro_torch.kernels.pairwise import row_sq_euclidean as row_sq

    def row(s: NNState, top: int) -> torch.Tensor:
        W, u = s.rep
        sq = row_sq(W[top], W)
        return summary_distance(method, sq, u, u[top], s.sizes, s.sizes[top])

    def merge(s: NNState, i, j, dmin, top, row_top) -> None:
        W, u = s.rep
        w_new, u_new = summary_merge(method, W[i], W[j], u[i], u[j], s.sizes[i], s.sizes[j])
        W[i] = w_new
        u[i] = u_new

    return NNChainOps(row=row, merge=merge)


def _chain_done(b) -> bool:
    """The one read-back: whether the run has its merges, hit the trip cap
    or stopped at a NaN row."""
    _, n_merges, iters, stopped = b.count.tolist()
    return n_merges >= b.n_steps or iters >= b.cap or bool(stopped)


def _resident_chain(method: str, state: NNState, n_steps: int) -> ChainResult:
    """The matrix-free chain on :class:`~repro_torch.kernels.pairwise.ChainBuffers`
    around ``state`` (updated in place), until ``n_steps`` merges.

    On the card the trips replay from a CUDA graph of
    :data:`CHAIN_GRAPH_TRIPS`; a run needs at least ``n_steps`` trips, so
    the first ``⌈n_steps / k⌉`` replays go without a read-back, and each
    later one reads the counts back once.  Trips past the end do nothing.
    On the CPU the plain twin runs trip by trip.  ``iters`` is the trips
    made, exactly, as the host-driven loop counts them.
    """
    from repro_torch.kernels.pairwise import TripGraph, chain_buffers, chain_trip

    W, u = state.rep
    if n_steps <= 0:
        return ChainResult(merges=torch.zeros((0, 4), dtype=torch.float32, device=W.device),
                           n_merges=0, iters=0)
    b = chain_buffers(W, u, state.alive, state.sizes, n_steps)
    if W.device.type == "cuda":
        graph = TripGraph(method, b, CHAIN_GRAPH_TRIPS)
        for _ in range(-(-n_steps // CHAIN_GRAPH_TRIPS)):
            graph.replay()
        while not _chain_done(b):
            graph.replay()
    else:
        while not _chain_done(b):
            chain_trip(method, b)
    _, n_merges, iters, _ = b.count.tolist()
    return ChainResult(merges=b.merges, n_merges=n_merges, iters=iters)


def nn_chain_from_points(X, method: str = "ward", *, device=None) -> ChainResult:
    """Matrix-free full agglomeration of ``(n, d)`` points on ``device``
    (CUDA unless told otherwise): O(n·d + n) memory, no ``(n, n)`` tensor.

    Exact (to float tolerance) against the dense engines on the squared
    Euclidean matrix for :data:`POINTS_METHODS`.  Merges are in chain
    order; ``iters`` counts the trips made (on the card, each one launch
    of the trip kernel).
    """
    if method not in POINTS_METHODS:
        raise ValueError(
            f"matrix-free points mode supports {POINTS_METHODS} (their LW "
            f"distance is a geometric-summary function), got {method!r} — "
            "build the distance matrix and use nn_chain instead"
        )
    dev = resolve_device(device)
    W = torch.as_tensor(X, dtype=torch.float32, device=dev)
    if W.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {tuple(W.shape)}")
    n = W.shape[0]
    W = W.contiguous().clone()              # merges rewrite summaries in place
    state = _init_state((W, torch.zeros(n, dtype=torch.float32, device=dev)), n, dev)
    return _resident_chain(method, state, n - 1)


def nn_chain_from_summaries(W, u, sizes, method: str = "ward", *, device=None) -> ChainResult:
    """Agglomerate ``k`` pre-accumulated geometric summaries on ``device``
    (CUDA unless told otherwise).

    Each slot is a whole cluster: ``W[k]`` its summary point (centroid or
    WPGMA midpoint), ``u[k]`` its scatter term, ``sizes[k]`` its member
    count.  The chain runs the recursions of :func:`nn_chain_from_points`
    (which is this call with unit sizes and ``u = 0``) on the same
    resident trip (:func:`_resident_chain`).  Phase 2 of the two-phase
    tier (:func:`repro_torch.core.distributed.two_phase_from_points`).
    Merges are in chain order over summary slots; recorded sizes are
    summed member counts.  The caller's tensors are not modified.
    """
    if method not in POINTS_METHODS:
        raise ValueError(
            f"summary agglomeration supports {POINTS_METHODS} (their LW "
            f"distance is a geometric-summary function), got {method!r}"
        )
    dev = resolve_device(device)
    W = torch.as_tensor(W, dtype=torch.float32, device=dev)
    if W.ndim != 2:
        raise ValueError(f"expected (k, d) summary points, got {tuple(W.shape)}")
    k = W.shape[0]
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    sizes = torch.as_tensor(sizes, dtype=torch.float32, device=dev)
    if u.shape != (k,) or sizes.shape != (k,):
        raise ValueError(
            f"u and sizes must be ({k},) to match the summaries, got "
            f"{tuple(u.shape)} and {tuple(sizes.shape)}"
        )
    # the trip rewrites the summaries in place, and the buffers keep their tensors
    state = _init_state((W.contiguous().clone(), u.clone()), k, dev, sizes=sizes.clone())
    return _resident_chain(method, state, k - 1)


# ---------------------------------------------------------------------------
# batched compositions: B lanes of a shape bucket in lockstep
# ---------------------------------------------------------------------------


def _batch_chain_loop(row, merge, alive, sizes, n_real) -> ChainResult:
    """The chain loop of every lane of a bucket at once, until each lane
    has its ``min(max(n_real − 1, 0), n − 1)`` merges (or hits the cap of
    ``4n + 8`` trips, or stops at a NaN row).

    Each trip is :func:`~repro_torch.kernels.pairwise.chain_trip_plain`'s
    over the lane axis: ``row(top)`` gives each lane's ``(B, n)`` raw row
    of its tip, ``merge(i, j, m, n_i, n_j, mask)`` commits the merges of
    the lanes in ``mask`` into the representation in place.  A lane that is
    done changes nothing.  The done flags are read back once every
    :data:`CHAIN_GRAPH_TRIPS` trips, after the first ``⌈(n − 1) / k⌉``
    chunks (no lane finishes sooner).  ``n_merges`` and ``iters`` come back
    as ``(B,)`` int64 tensors on the CPU.
    """
    B, n = alive.shape
    dev = alive.device
    steps = max(n - 1, 0)
    merges = torch.zeros((B, steps, 4), dtype=torch.float32, device=dev)
    n_merges = torch.zeros(B, dtype=torch.int64, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    target = torch.as_tensor(np.minimum(np.maximum(np.asarray(n_real) - 1, 0), steps),
                             dtype=torch.int64, device=dev)
    lanes, ks = torch.arange(B, device=dev), torch.arange(n, device=dev)
    chain = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
    chain[:, 0] = torch.argmax(alive.to(torch.uint8), dim=1)     # the first live slot
    length = torch.ones(B, dtype=torch.int64, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    cap = 4 * n + 8

    def running():
        return (n_merges < target) & (iters < cap) & ~stopped

    def trip():
        nonlocal length, stopped
        active = running()
        top = chain.gather(1, (length - 1).clamp_min(0)[:, None])[:, 0]
        prev = chain.gather(1, (length - 2).clamp_min(0)[:, None])[:, 0]
        rowm = torch.where(alive & (ks != top[:, None]), row(top), torch.inf)
        m = rowm.amin(dim=1)
        c = torch.where(rowm == m[:, None], ks, n).amin(dim=1)   # first index of the minimum
        prev_hit = (length >= 2) & (rowm.gather(1, prev[:, None])[:, 0] == m)
        c = torch.where(prev_hit, prev, c)                        # the previous element wins ties
        do = active & prev_hit
        push = active & ~prev_hit & (c < n)
        i, j = torch.minimum(top, c), torch.maximum(top, c).clamp_max(n - 1)
        n_i, n_j = sizes[lanes, i], sizes[lanes, j]
        merge(i, j, m, n_i, n_j, do)
        new_size = n_i + n_j
        at = n_merges.clamp_max(steps - 1)
        rec = torch.stack((i.to(torch.float32), j.to(torch.float32), m, new_size), dim=1)
        merges[lanes, at] = torch.where(do[:, None], rec, merges[lanes, at])
        sizes[lanes, j] = torch.where(do, 0.0, n_j)
        sizes[lanes, i] = torch.where(do, new_size, sizes[lanes, i])
        alive[lanes, j] = alive[lanes, j] & ~do
        slot = length.clamp(0, n)                                 # a push writes the next slot
        chain[lanes, slot] = torch.where(push, c, chain[lanes, slot])
        length = torch.where(do, length - 2, torch.where(push, length + 1, length))
        restart = do & (length == 0)                              # an emptied chain restarts
        chain[:, 0] = torch.where(restart, torch.argmax(alive.to(torch.uint8), dim=1),
                                  chain[:, 0])
        length = torch.where(restart, 1, length)
        n_merges.add_(do)
        iters.add_(active)
        stopped = stopped | (active & ~(do | push))               # a NaN row

    if steps:
        for _ in range(-(-steps // CHAIN_GRAPH_TRIPS)):
            for _ in range(CHAIN_GRAPH_TRIPS):
                trip()
        while bool(running().any()):                              # the one read-back of a chunk
            for _ in range(CHAIN_GRAPH_TRIPS):
                trip()
    return ChainResult(merges=merges, n_merges=n_merges.cpu(), iters=iters.cpu())


def _check_bucket_n_real(n_real, B: int) -> np.ndarray:
    n_real = np.asarray(n_real, dtype=np.int64)
    if n_real.shape != (B,):
        raise ValueError(f"n_real must be ({B},) to match the bucket, got {n_real.shape}")
    return n_real


def nn_chain_batched(Db, n_real, method: str = "complete", *, device=None) -> ChainResult:
    """Batched NN-chain over a ``(B, n, n)`` shape bucket, on ``device``
    (CUDA unless told otherwise).

    Lane ``b`` agglomerates ``Db[b, :n_real[b], :n_real[b]]``; rows and
    columns past ``n_real[b]`` are padding.  Returns stacked chain-order
    merge buffers ``(B, n − 1, 4)``: lane ``b``'s are its first
    ``n_merges[b]`` rows; pass them through
    :func:`repro_torch.core.dendrogram.canonical_order` before cutting.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    if method not in REDUCIBLE_METHODS:
        raise ValueError(
            f"nn_chain is exact only for reducible methods "
            f"{REDUCIBLE_METHODS}, got {method!r}"
        )
    dev = resolve_device(device)
    Db = torch.as_tensor(Db, dtype=torch.float32, device=dev)
    if Db.ndim != 3 or Db.shape[1] != Db.shape[2]:
        raise ValueError(f"expected a (B, n, n) bucket of distance matrices, got "
                         f"{tuple(Db.shape)}")
    B, n = Db.shape[0], Db.shape[1]
    n_real = _check_bucket_n_real(n_real, B)
    alive = torch.arange(n, device=dev) < torch.as_tensor(n_real, device=dev)[:, None]
    D = torch.where(alive[:, :, None] & alive[:, None, :], symmetrize(Db), 0.0)
    lanes = torch.arange(B, device=dev)
    sizes = alive.to(torch.float32)

    def row(top):
        return D[lanes, top]

    def merge(i, j, m, n_i, n_j, do):
        new = update_row(method, D[lanes, i], D[lanes, j], m[:, None], n_i[:, None],
                         n_j[:, None], sizes).masked_fill(~alive, 0.0)
        new[lanes, i] = 0.0
        new[lanes, j] = 0.0
        keep = do[:, None]
        D[lanes, i] = torch.where(keep, new, D[lanes, i])
        D[lanes, :, i] = torch.where(keep, new, D[lanes, :, i])

    return _batch_chain_loop(row, merge, alive, sizes, n_real)


def nn_chain_batched_from_points(Xb, n_real, method: str = "ward", *,
                                 device=None) -> ChainResult:
    """Batched matrix-free agglomeration of a ``(B, n, d)`` points bucket on
    ``device`` (CUDA unless told otherwise): lane ``b`` clusters ``Xb[b,
    :n_real[b]]`` under the squared-Euclidean convention of
    :func:`nn_chain_from_points` (:data:`POINTS_METHODS` only); no ``(n,
    n)`` matrix exists in any lane.  Merges are in chain order, as
    :func:`nn_chain_batched` returns them."""
    if method not in POINTS_METHODS:
        raise ValueError(
            f"matrix-free points mode supports {POINTS_METHODS} (their LW "
            f"distance is a geometric-summary function), got {method!r} — "
            "build the distance matrices and use nn_chain_batched instead"
        )
    dev = resolve_device(device)
    W = torch.as_tensor(Xb, dtype=torch.float32, device=dev)
    if W.ndim != 3:
        raise ValueError(f"expected a (B, n, d) points bucket, got {tuple(W.shape)}")
    W = W.contiguous().clone()              # merges rewrite summaries in place
    B, n = W.shape[0], W.shape[1]
    n_real = _check_bucket_n_real(n_real, B)
    alive = torch.arange(n, device=dev) < torch.as_tensor(n_real, device=dev)[:, None]
    u = torch.zeros((B, n), dtype=torch.float32, device=dev)
    lanes = torch.arange(B, device=dev)
    sizes = alive.to(torch.float32)

    def row(top):
        t = W - W[lanes, top][:, None, :]
        return summary_distance(method, (t * t).sum(-1), u, u[lanes, top][:, None], sizes,
                                sizes[lanes, top][:, None])

    def merge(i, j, m, n_i, n_j, do):
        w_i, w_j, u_i, u_j = W[lanes, i], W[lanes, j], u[lanes, i], u[lanes, j]
        tot = n_i + n_j
        gap = ((w_i - w_j) ** 2).sum(-1)
        if method == "weighted":                # WPGMA midpoint recursion
            w_new = 0.5 * (w_i + w_j)
            u_new = 0.5 * (u_i + u_j) + 0.25 * gap
        else:                                   # size-weighted centroid (+ scatter)
            w_new = (n_i[:, None] * w_i + n_j[:, None] * w_j) / tot[:, None]
            u_new = ((n_i * u_i + n_j * u_j) / tot + (n_i * n_j) / (tot * tot) * gap
                     if method == "average" else torch.zeros_like(u_i))   # ward: u stays 0
        W[lanes, i] = torch.where(do[:, None], w_new, w_i)
        u[lanes, i] = torch.where(do, u_new, u_i)

    return _batch_chain_loop(row, merge, alive, sizes, n_real)
