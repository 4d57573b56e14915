"""The Lance-Williams merge loop, in torch.

Counterpart of :mod:`repro.core.engine`: find the global minimum, apply
the recurrence, tombstone the absorbed slot, record the merge — once per
merge.  The step is assembled from primitives (:class:`StepOps`); two
compositions of them run the loop on one device:

* **serial** (:func:`dense_ops`, :func:`run_dense`): plain torch over the
  *premasked* matrix.  Dead rows, dead columns and the diagonal hold
  ``+inf``, written once up front and then as slots die, so the argmin
  is a plain row-min with no mask.  It launches no hand-written kernel.
* **kernel** (:func:`kernel_ops`, :func:`run_kernel`): the *garbage*
  representation.  Dead cells keep inert values and liveness is applied
  at argmin time.  ``baseline`` and ``rowmin`` are the min-scan seed and
  one launch of the fused merge kernel a merge, on device-resident
  buffers (the fused kernel recomputes every row minimum, so ``rowmin``'s
  cache would be dead carry: both run cache-free and are identical by
  construction, as in the JAX engine).  ``lazy`` keeps the cached row
  minima over the masked view: on a CUDA device two launches of the
  row-update kernel's merge entry a merge (the update with the caches'
  invalidation, then the rescan of the stale rows) on device-resident
  buffers; on the CPU the host-driven loop, one row update a merge.

The argmin ``variant`` picks the candidate search: a full row-min every
merge (``baseline``), or per-row ``(min, first argmin)`` caches that the
merged column can only lower, with the rows whose cached argmin pointed
into the merged slots rescanned (``rowmin``, ``lazy``).  The JAX engine
rescans those rows in a full masked pass (``rowmin``) or ``K`` at a time
in a ``while_loop`` (``lazy``); each rescan reads the same matrix, so
rescanning all of them in one gather gives the same caches, and that is
what both do here.  Merges are index-identical to the JAX package's for
every backend and variant, with heights equal to float tolerance.

The JAX loop traces into one compiled program.  Here the loop is a
Python ``for`` over a fixed trip count, and the candidate, the merged
slots and the sizes stay on the device.  The baseline steps read nothing
back, so the host only enqueues launches and the device runs ahead; on
the kernel backend on a CUDA device a merge is one launch (``lazy``: two)
on fixed device buffers, so :data:`THRESHOLD_CHECK_TRIPS` merges are
captured once as a CUDA graph and replayed.  The host-driven cached
variants (serial, and kernel ``lazy`` on the CPU) read back the rows to
rescan, once a merge; a ``distance_threshold`` run reads back the
recorded heights once every :data:`THRESHOLD_CHECK_TRIPS` merges.  ``D``
and the merge record are updated in place.

**Compaction.**  Every composition above (both backends, all three
variants, on the CPU and on a CUDA device) runs the JAX engine's stage
schedule when asked to (:func:`plan_stages`, :func:`resolve_compaction`;
the kernel backend's plan floor is :data:`KERNEL_MIN_STAGE`).  Once the
live count has provably halved, one gather packs the live rows and
columns into the half-size matrix, ascending, so first-minimum
tie-breaking and the merges are unchanged bit for bit; the next stage
seeds again and runs at the smaller size, and its merges are rewritten
to original slot ids (:func:`compact_dense`, :func:`staged_merge_loop`,
:func:`remap_merges`).  A boundary stays on the device: the permutation
is a sort of the liveness, the gather two ``index_select`` s, the remap a
gather over the stage's rows of the record; the host reads nothing back
and decides from host ints alone (the plan, and ``n_merges`` after a
threshold check).  On the kernel backend each stage builds its own
resident buffers and, with at least :data:`THRESHOLD_CHECK_TRIPS` merges,
captures its own CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core.linkage import METHODS, update_row

#: Argmin-op variants of the JAX engine, all ported.
VARIANTS: tuple[str, ...] = ("baseline", "rowmin", "lazy")

#: Merges a ``distance_threshold`` run takes between two reads of the
#: recorded heights: at most this many trips run past the stop and are
#: trimmed.  Also the merges of the kernel backend's captured CUDA graph.
THRESHOLD_CHECK_TRIPS = 128

#: Rows gathered at once when row minima are rebuilt, which bounds the
#: rescan's temporaries to this many rows.
RESCAN_ROWS = 1024

#: Smallest matrix a serial compaction stage may shrink to (the JAX
#: engine's ``MIN_STAGE_N``): the plan keeps the tail of the run at this
#: size instead of halving further.
MIN_STAGE_N = 32

#: Smallest matrix a kernel-backend compaction stage may shrink to.  The
#: JAX kernel plan's floor is 128 lanes, aligned; the CUDA kernels take any
#: ``n``, so this plan has no alignment, and its floor is twice that: on an
#: H100 (chip_smoke.py's stage floor sweep at n = 1968) a floor of 128 adds
#: a stage of 246 slots whose merges after its one graph replay are
#: launched one by one while the card idles (+5-6 ms on a 20 ms loop),
#: and floors of 256 and 512 cost nothing measurable.  Below ~2048 slots a
#: merge is latency-bound, so a smaller stage saves the card nothing.
KERNEL_MIN_STAGE = 256

_INF = float("inf")


def check_knobs(method: str, variant: str) -> None:
    """Validate the linkage method and argmin variant of both LW backends
    (the compaction flag is checked by :func:`resolve_compaction`)."""
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")


def plan_stages(n: int, n_steps: int, *, min_stage: int = MIN_STAGE_N,
                align: int = 1) -> tuple[tuple[int, int], ...]:
    """Static compaction schedule ``((size, steps), ...)``, as the JAX
    engine plans it.

    Stage 0 runs at full size ``n``; each later stage runs on the
    ``size // 2`` matrix that one gather produces.  A boundary is legal
    once the live count provably fits the half-size matrix: after ``size -
    size // 2`` merges, since every trip tombstones one slot.  Halving
    stops when the remaining merges fit the current size, when the half
    would drop below ``min_stage``, or when it would break ``align``.
    """
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    stages: list[tuple[int, int]] = []
    size, remaining = n, max(n_steps, 0)
    while True:
        boundary = size - size // 2        # merges that guarantee live <= half
        half = size // 2
        if remaining <= boundary or half < max(min_stage, 2) or half % align:
            stages.append((size, remaining))
            return tuple(stages)
        stages.append((size, boundary))
        remaining -= boundary
        size = half


def resolve_compaction(flag, n: int, n_steps: int, *, min_stage: int = MIN_STAGE_N,
                       align: int = 1) -> bool:
    """The compaction switch of a run, as the JAX engine resolves it:
    ``False``, ``None`` and ``"off"`` are off; ``True``, ``"auto"`` and
    ``"on"`` stage whenever :func:`plan_stages` gives more than one stage
    (so a degenerate plan, at a small ``n`` or an aggressive ``stop_at_k``,
    runs the unstaged loop); anything else raises ``ValueError``."""
    if flag in (False, None, "off"):
        return False
    if flag not in (True, "auto", "on"):
        raise ValueError(f"compaction must be a bool or 'auto', got {flag!r}")
    return len(plan_stages(n, n_steps, min_stage=min_stage, align=align)) > 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for and missing — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "none is available; pass device='cpu' to run the plain torch "
            "versions of the kernels on the CPU"
        )
    return dev


class LWResult(NamedTuple):
    """Output of a Lance-Williams run.

    merges: ``(n_steps, 4)`` float32 rows ``(i, j, dist, new_size)``, ``i < j``
        the slots merged at that step (slot ``i`` keeps the union).
    n_merges: merges recorded.  Equals ``n_steps`` unless
        ``distance_threshold`` stopped the run early; rows past
        ``n_merges`` are zero.
    """

    merges: torch.Tensor
    n_merges: int


class LWState(NamedTuple):
    """Carry of the merge loop.

    ``D`` is the ``(S, S)`` matrix of the current compaction stage (``S =
    n`` unstaged) in the backend's representation (premasked or garbage),
    ``alive`` the ``(S,)`` bool liveness, ``sizes`` the ``(S,)`` float32
    cluster sizes; a stage boundary replaces all three with the gathered
    ones.  ``cand`` is the next merge candidate ``(r, c, dmin)`` as 0-d
    device tensors (int64, int64, float32), computed at the tail of each
    step.  ``merges`` is the one record of the whole run and ``n_merges``
    its host-int count, which a stage continues from: with a fixed trip
    count it is known without asking the device.  ``cache`` is ``()`` for
    the serial cache-free ops (and at a stage's start, before its seed),
    the per-row ``(rmin, rarg)`` (float32, int64) for the host-driven
    cached variants, and the resident kernel ops' buffers,
    :class:`~repro_torch.kernels.lw_step.MergeBuffers` or
    :class:`~repro_torch.kernels.lw_update.LazyBuffers` (``cand`` then
    views their candidate), built anew each stage.
    """

    D: torch.Tensor
    alive: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    n_merges: int
    cand: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    cache: tuple


class StepOps(NamedTuple):
    """The primitives a step is assembled from.

    seed:    fill ``cand`` (and ``cache``) from the initial state.
    fetch:   ``(state, ij) -> (d_ki, d_kj)``, copies of rows ``i`` and ``j``.
    merge:   ``state -> state``: a whole merge on the device (a resident
             merge entry), which records it at the device's own merge
             count.
    replay:  ``state -> state``: :data:`THRESHOLD_CHECK_TRIPS` merges
             replayed from a captured CUDA graph, or ``None``.
    update:  ``(d_ki, d_kj, d_ij, n_i, n_j, sizes, keep) -> new``: the
             recurrence over a whole row, dropped lanes filled with the
             representation's tombstone (``+inf`` premasked, 0 garbage).
    write:   ``(state, ij, new) -> D``: commit the merged row in place.
    refresh: ``(state, ij, new, keep) -> state``: the next ``cand`` (and
             ``cache``) after the write.

    A step runs ``merge`` when it is set, else fetch → update → write →
    refresh.  The ops are built for one matrix size; a staged run builds
    them for each stage's size and seeds once a stage.
    """

    seed: Callable[[LWState], LWState]
    fetch: Callable[[LWState, torch.Tensor], tuple[torch.Tensor, torch.Tensor]] | None = None
    merge: Callable[[LWState], LWState] | None = None
    replay: Callable[[LWState], LWState] | None = None
    update: Callable[..., torch.Tensor] | None = None
    write: Callable[[LWState, torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    refresh: Callable[..., LWState] | None = None


def symmetrize(D: torch.Tensor) -> torch.Tensor:
    """The single input-normalization path: accepts a full symmetric matrix
    or just its upper triangle, averages ``D`` with its transpose and zeroes
    the diagonal.  Always returns a new tensor."""
    D = torch.as_tensor(D, dtype=torch.float32)
    n = D.shape[-1]
    if D.ndim < 2 or D.shape[-2] != n:
        raise ValueError(f"distance matrix must be square, got {tuple(D.shape)}")
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    upper = torch.triu(D, diagonal=1)
    has_lower = torch.any(torch.tril(D, diagonal=-1) != 0, dim=(-2, -1), keepdim=True)
    full_sym = torch.where(has_lower, D, upper + upper.transpose(-2, -1))
    return torch.where(eye, 0.0, 0.5 * (full_sym + full_sym.transpose(-2, -1)))


def premask(D: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Apply the liveness/diagonal mask once, up front, in place: dead rows,
    dead columns and the diagonal of ``D`` (``(..., n, n)``, with ``alive``
    ``(..., n)``) become ``+inf`` (the serial backend's premasked
    representation)."""
    D.diagonal(dim1=-2, dim2=-1).fill_(_INF)
    dead = ~alive
    return D.masked_fill_(dead[..., :, None], _INF).masked_fill_(dead[..., None, :], _INF)


def resolve_n_steps(n: int, stop_at_k: int) -> int:
    """Merge count for a run over ``n`` items stopping at ``k`` clusters."""
    if stop_at_k < 1:
        raise ValueError(f"stop_at_k must be >= 1, got {stop_at_k}")
    return max(n - stop_at_k, 0)


def make_step(ops: StepOps) -> Callable[..., LWState]:
    """Assemble the paper's merge step from primitives: candidate →
    recurrence → commit → tombstone → record → next candidate.

    ``t`` is the merge-record index (``state.n_merges`` when omitted; a
    ``merge`` keeps its own count on the device, which starts at
    ``state.n_merges``).  The step writes ``D`` and ``merges`` in place and
    returns the new state.
    """
    if ops.merge is not None:
        return lambda s, t=None: ops.merge(s)

    def step(s: LWState, t: int | None = None) -> LWState:
        r, c, dmin = s.cand
        ij = torch.stack((torch.minimum(r, c), torch.maximum(r, c)))  # i keeps the union
        d_ki, d_kj = ops.fetch(s, ij)
        n_ij = s.sizes.index_select(0, ij)
        new_size = n_ij.sum()
        j_only = ij[1:]
        alive = s.alive.index_fill(0, j_only, False)
        sizes = s.sizes.index_fill(0, j_only, 0.0).index_put_((ij[:1],), new_size.reshape(1))
        s.merges[s.n_merges if t is None else t] = torch.cat(
            (ij.to(torch.float32), dmin.reshape(1), new_size.reshape(1))
        )
        keep = s.alive.index_fill(0, ij, False)      # live spectators of the merge
        new = ops.update(d_ki, d_kj, dmin.reshape(1), n_ij[:1], n_ij[1:], s.sizes, keep)
        D = ops.write(s, ij, new)
        return ops.refresh(LWState(D, alive, sizes, s.merges, s.n_merges + 1, s.cand, s.cache),
                           ij, new, keep)

    return step


def run_merge_loop(ops: StepOps, state: LWState, n_steps: int,
                   distance_threshold: float | None = None, *, start: int = 0) -> LWState:
    """Seed the candidate, then run merge trips ``[start, n_steps)``.

    Without a threshold the trip count is fixed: ``stop_at_k`` shrinks it
    on the host, and no trip waits for the device.  With one the run ends
    before the first merge whose height exceeds ``float32(threshold)``, as
    the JAX engine's ``while_loop`` does.  Here the trips run in chunks of
    :data:`THRESHOLD_CHECK_TRIPS` from ``start``; after each chunk its
    recorded heights are read back once, and at the first height above the
    threshold (or NaN) the run stops, the merges past it are zeroed and
    ``n_merges`` counts those before it.  Where the ops replay a captured
    graph, each whole chunk is one replay and the trips left over are
    launched one by one.

    ``start`` is the merge this call resumes at (a compaction stage
    boundary); ``state.n_merges`` equals it.
    """
    if n_steps <= start:   # stop_at_k >= n: nothing to merge
        return state
    step = make_step(ops)
    state = ops.seed(state)

    def trips(state: LWState, start: int, stop: int) -> LWState:
        if ops.replay is not None:
            while stop - start >= THRESHOLD_CHECK_TRIPS:
                state = ops.replay(state)
                start += THRESHOLD_CHECK_TRIPS
        for t in range(start, stop):
            state = step(state, t)
        return state

    if distance_threshold is None:
        return trips(state, start, n_steps)
    # compared in float32, as the reference casts the threshold
    thr = torch.tensor(float(distance_threshold), dtype=torch.float32)
    for a in range(start, n_steps, THRESHOLD_CHECK_TRIPS):
        b = min(a + THRESHOLD_CHECK_TRIPS, n_steps)
        state = trips(state, a, b)
        over = torch.nonzero(~(state.merges[a:b, 2].cpu() <= thr))
        if over.numel():
            n_merges = a + int(over[0, 0])
            state.merges[n_merges:] = 0.0
            return state._replace(n_merges=n_merges)
    return state


# ---------------------------------------------------------------------------
# compaction: the live-slot gather between stages, and the staged loop
# ---------------------------------------------------------------------------


def _live_perm(alive: torch.Tensor, half: int):
    """The compaction permutation of ``alive`` ``(..., n)``: the live slots
    packed ascending, which keeps their relative order (the order
    first-minimum tie-breaking keys on, so the merges are unchanged).
    Returns ``(live, p)``: the new liveness and the gather index (dead tail
    slots point at slot ``n - 1``; their cells are masked)."""
    n = alive.shape[-1]
    ks = torch.arange(n, device=alive.device)
    perm = torch.sort(torch.where(alive, ks, n)).values[..., :half]
    return perm < n, perm.clamp_max(n - 1)


def compact_dense(D: torch.Tensor, alive: torch.Tensor, sizes: torch.Tensor,
                  remap: torch.Tensor, half: int, *, premasked: bool = True):
    """One gather pass: the live rows and columns of ``D`` packed into a new
    ``(half, half)`` matrix, :data:`RESCAN_ROWS` rows at a time (so the
    pass holds ``D``, the new matrix and one block of rows).

    Returns ``(D', alive', sizes', remap')``, ``remap'[s]`` the original
    slot of compacted slot ``s`` (ascending over the live slots, so ``i <
    j`` keeps its meaning).  Live cells are copied untouched.  With
    ``premasked`` (the serial backend) the dead tail and the diagonal are
    set to ``+inf``; without (the kernel backend's garbage representation)
    the dead tail holds copies of cells of ``D``, inert as every dead cell
    is to the kernels, which mask by ``alive``.
    """
    live, p = _live_perm(alive, half)
    Dn = torch.empty((half, half), dtype=D.dtype, device=D.device)
    for a in range(0, half, RESCAN_ROWS):
        rows = p[a:a + RESCAN_ROWS]
        torch.index_select(D.index_select(0, rows), 1, p, out=Dn[a:a + rows.numel()])
    if premasked:
        premask(Dn, live)
    return (Dn, live, torch.where(live, sizes.index_select(0, p), 0.0),
            remap.index_select(0, p))


def remap_merges(merges: torch.Tensor, n_merges: int, remap: torch.Tensor,
                 start: int, steps: int) -> torch.Tensor:
    """Rewrite one stage's recorded merges from compacted slots to original
    ids, in place.  Only rows below ``n_merges`` are rewritten: rows past a
    threshold stop keep their zeros."""
    stop = min(start + steps, n_merges)
    if stop > start:
        ij = merges[start:stop, :2]
        ij.copy_(remap.index_select(0, ij.reshape(-1).to(torch.int64)).reshape(ij.shape))
    return merges


def staged_merge_loop(stages, state: LWState, remap: torch.Tensor,
                      distance_threshold: float | None, *,
                      ops_for: Callable[[int], StepOps], compact: Callable) -> LWState:
    """The staged loop of every composition: per stage, after the first,
    ``compact(state, remap, size)`` packs the live slots; then
    :func:`run_merge_loop` seeds and runs the stage's trips with
    ``ops_for(size)``, and the stage's merges are rewritten to original
    slot ids.  A threshold stop inside a stage ends the run.  A
    single-stage plan is the unstaged loop: no gather, no remap.

    The old stage's ops (its captured graph) and buffers are dropped only
    after its last trip is enqueued, and its matrix after the gather; the
    stream orders the frees after the work that reads them.
    """
    start = 0
    for si, (size, steps) in enumerate(stages):
        if si > 0:
            if state.n_merges < start:    # stopped by the threshold
                break
            D, alive, sizes, remap = compact(state, remap, size)
            state = LWState(D, alive, sizes, state.merges, state.n_merges, state.cand, ())
        state = run_merge_loop(ops_for(size), state, start + steps, distance_threshold,
                               start=start)
        if si > 0:
            remap_merges(state.merges, state.n_merges, remap, start, steps)
        start += steps
    return state


def _init_state(D: torch.Tensor, alive: torch.Tensor, n_steps: int) -> LWState:
    zero = torch.zeros((), dtype=torch.int64, device=D.device)
    return LWState(
        D=D,
        alive=alive,
        sizes=alive.to(torch.float32),
        merges=torch.zeros((n_steps, 4), dtype=torch.float32, device=D.device),
        n_merges=0,
        cand=(zero, zero, torch.zeros((), dtype=torch.float32, device=D.device)),
        cache=(),
    )


def _fetch_rows(s: LWState, ij: torch.Tensor):
    rows = s.D.index_select(0, ij)   # D is symmetric: rows i, j are columns i, j
    return rows[0], rows[1]


# ---------------------------------------------------------------------------
# argmin ops over the matrix and over cached row minima
# ---------------------------------------------------------------------------


def _first_where(mask: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Smallest index with ``mask`` true (``n`` when none), as a 0-d tensor:
    the first minimum whatever order the device reduces in."""
    return torch.where(mask, ks, ks.numel()).amin()


def _row_major_first_min(D: torch.Tensor, ks: torch.Tensor):
    """``(r, c, min)`` of a premasked matrix with ``jnp.argmin``'s row-major
    first-minimum tie-breaking, from a row-min pass and two index searches."""
    rowmin = D.amin(dim=1)
    m = rowmin.amin()
    r = _first_where(rowmin == m, ks)
    c = _first_where(D.index_select(0, r.reshape(1))[0] == m, ks)
    return r, c, m


def _masked_row_mins(D: torch.Tensor, alive: torch.Tensor, rows: torch.Tensor,
                     ks: torch.Tensor):
    """Per-row ``(min, first-column argmin)`` of ``rows`` of the masked view
    of ``D`` (dead rows, dead columns and the diagonal at ``+inf``; a fully
    masked row gives ``(inf, 0)``), gathered :data:`RESCAN_ROWS` at a time.
    The mask is a no-op on a premasked matrix."""
    n = ks.numel()
    rmins, rargs = [], []
    for part in rows.split(RESCAN_ROWS):
        valid = (alive[None, :] & (ks[None, :] != part[:, None])
                 & alive.index_select(0, part)[:, None])
        sub = torch.where(valid, D.index_select(0, part), _INF)
        rm = sub.amin(dim=1)
        rmins.append(rm)
        rargs.append(torch.where(sub == rm[:, None], ks, n).amin(dim=1))
    return torch.cat(rmins), torch.cat(rargs)


def _cached_cand(alive, rmin, rarg, ks):
    """Global row-major first minimum from exact ``(rmin, rarg)`` caches."""
    rvals = torch.where(alive, rmin, _INF)
    m = rvals.amin()
    r = _first_where(rvals == m, ks)
    return r, rarg.index_select(0, r.reshape(1)).reshape(()), m


def _cache_invalidate(cache: tuple, ij: torch.Tensor, col: torch.Tensor,
                      ks: torch.Tensor, alive: torch.Tensor):
    """The rowmin/lazy cache-maintenance algebra of the JAX engine.

    The rewritten column ``i`` (``col``, masked) can only *lower* a cached
    row minimum in place, exactly, with first-column tie-breaking: on an
    equal value the smaller column wins.  Rows whose cached argmin pointed
    into the merged slots, and row ``i`` itself, are stale and must rescan.
    Returns ``(rmin, rarg, stale)``.
    """
    rmin, rarg = cache
    i, j = ij[0], ij[1]
    lower = (col < rmin) | ((col == rmin) & (i < rarg))
    lower &= (ks != i) & (ks != j)
    rmin = torch.where(lower, col, rmin)
    rarg = torch.where(lower, i, rarg)
    stale = ((rarg == i) | (rarg == j) | (ks == i)) & ~lower & alive
    return rmin, rarg, stale


def _drain_cache(D, alive, rmin, rarg, stale, ks):
    """Rescan the stale rows against ``D``, all in one gather.  Reading
    which rows they are is the one read-back of a merge."""
    rows = stale.nonzero().squeeze(1)
    if rows.numel():
        rm, ra = _masked_row_mins(D, alive, rows, ks)
        rmin, rarg = rmin.index_copy(0, rows, rm), rarg.index_copy(0, rows, ra)
    return rmin, rarg


def _cached_argmin(ks: torch.Tensor):
    """``seed`` and ``refresh`` of the cached row-minima variants, over the
    masked view of either representation."""

    def seed(s: LWState) -> LWState:
        rmin, rarg = _masked_row_mins(s.D, s.alive, ks, ks)
        return s._replace(cache=(rmin, rarg), cand=_cached_cand(s.alive, rmin, rarg, ks))

    def refresh(s: LWState, ij, new, keep) -> LWState:
        # column i of the masked view after the write: ``new`` on the live
        # spectators, +inf elsewhere (the garbage write leaves 0 there)
        col = torch.where(keep, new, _INF)
        rmin, rarg, stale = _cache_invalidate(s.cache, ij, col, ks, s.alive)
        rmin, rarg = _drain_cache(s.D, s.alive, rmin, rarg, stale, ks)
        return s._replace(cache=(rmin, rarg), cand=_cached_cand(s.alive, rmin, rarg, ks))

    return seed, refresh


# ---------------------------------------------------------------------------
# serial backend: plain torch over the premasked matrix
# ---------------------------------------------------------------------------


def dense_ops(method: str, n: int, variant: str, device) -> StepOps:
    """Primitives over the premasked representation, in plain torch.

    ``update`` fills dropped lanes with ``+inf``; ``write`` commits row and
    column ``i`` and tombstones row and column ``j`` in place.  ``baseline``
    finds each candidate with a row-min pass over the matrix; ``rowmin``
    and ``lazy`` keep the cached row minima.
    """
    ks = torch.arange(n, device=device)

    def update(d_ki, d_kj, d_ij, n_i, n_j, sizes, keep):
        return torch.where(keep, update_row(method, d_ki, d_kj, d_ij, n_i, n_j, sizes), _INF)

    def write(s: LWState, ij, new):
        i, j = ij[:1], ij[1:]
        s.D.index_copy_(0, i, new[None, :]).index_copy_(1, i, new[:, None])
        return s.D.index_fill_(0, j, _INF).index_fill_(1, j, _INF)

    if variant == "baseline":

        def seed(s: LWState) -> LWState:
            return s._replace(cand=_row_major_first_min(s.D, ks))

        def refresh(s: LWState, ij, new, keep) -> LWState:
            return seed(s)

    elif variant in ("rowmin", "lazy"):
        seed, refresh = _cached_argmin(ks)
    else:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    return StepOps(seed=seed, fetch=_fetch_rows, update=update, write=write, refresh=refresh)


def run_dense(D: torch.Tensor, alive: torch.Tensor, *, method: str, n_steps: int,
              variant: str = "baseline", distance_threshold: float | None = None,
              compaction: bool = False) -> LWResult:
    """The merge loop over the serial primitives.  ``D`` is premasked and
    then updated in place; slots with ``alive=False`` are dead from the
    start.  With ``compaction`` the run follows :func:`plan_stages`, each
    later stage on a premasked gather of the live slots; the merges are
    those of the unstaged run, bit for bit."""
    n = D.shape[-1]
    dev = D.device
    out = staged_merge_loop(
        plan_stages(n, n_steps) if compaction else ((n, n_steps),),
        _init_state(premask(D, alive), alive, n_steps),
        torch.arange(n, device=dev), distance_threshold,
        ops_for=lambda size: dense_ops(method, size, variant, dev),
        compact=lambda s, remap, size: compact_dense(s.D, s.alive, s.sizes, remap, size),
    )
    return LWResult(merges=out.merges, n_merges=out.n_merges)


# ---------------------------------------------------------------------------
# kernel backend: the hand-written CUDA kernels over the garbage matrix
# ---------------------------------------------------------------------------


def _resident_ops(method: str, seed, buffers, kind, merge_fn, graph=None) -> StepOps:
    """``seed``, ``merge`` and ``replay`` over a resident merge entry
    ``merge_fn(method, b)`` on buffers of type ``kind``, which
    ``buffers(state)`` allocates once, before the first merge, around the
    state and its candidate: a merge reads nothing back and allocates
    nothing.  ``graph`` (:class:`~repro_torch.kernels.lw_step.MergeGraph`'s
    signature, on a CUDA device) captures :data:`THRESHOLD_CHECK_TRIPS`
    merges at the first ``replay``; without it the ops have no ``replay``.
    The batch engine's buffers (a leading lane axis) go through the same
    ops, a merge then being one lockstep merge of every lane."""

    def resident(s: LWState) -> LWState:
        if isinstance(s.cache, kind):
            return s
        b = buffers(s)
        return s._replace(cand=(b.cand[..., 0], b.cand[..., 1], b.dmin.reshape(b.cand.shape[:-1])),
                          cache=b)

    def merge(s: LWState) -> LWState:
        s = resident(s)
        merge_fn(method, s.cache)
        return s._replace(n_merges=s.n_merges + 1)

    captured = []

    def replay(s: LWState) -> LWState:
        s = resident(s)
        if not captured:
            captured.append(graph(method, s.cache, THRESHOLD_CHECK_TRIPS))
        captured[0].replay()
        return s._replace(n_merges=s.n_merges + captured[0].merges)

    return StepOps(seed=lambda s: resident(seed(s)), merge=merge,
                   replay=None if graph is None else replay)


def _fused_ops(method: str, n: int, masked_argmin, lw_merge, graph=None) -> StepOps:
    """The fused ``baseline``/``rowmin`` primitives over a min-scan and a
    merge function with the signatures of :mod:`repro_torch.kernels.minscan`
    and :func:`repro_torch.kernels.lw_step.lw_merge`.

    The state lives in :class:`~repro_torch.kernels.lw_step.MergeBuffers`
    (:func:`_resident_ops`).  Each merge's tail picks the next candidate
    from the per-row minima, the first row that attains the minimum and
    then its first column: the row-major first minimum the min-scan kernel
    gives.
    """
    from repro_torch.kernels.lw_step import MergeBuffers, merge_buffers

    def seed(s: LWState) -> LWState:
        v, flat = masked_argmin(s.D, s.alive)
        return s._replace(cand=(torch.div(flat, n, rounding_mode="floor"), flat % n, v))

    def buffers(s: LWState) -> MergeBuffers:
        return merge_buffers(s.D, s.alive, s.sizes, s.merges, s.cand, s.n_merges)

    return _resident_ops(method, seed, buffers, MergeBuffers, lw_merge, graph)


def _lazy_resident_ops(method: str, n: int, lazy_merge, graph=None) -> StepOps:
    """The ``lazy`` primitives over a resident merge function with the
    signature of :func:`repro_torch.kernels.lw_update.lazy_merge`, on
    :class:`~repro_torch.kernels.lw_update.LazyBuffers`
    (:func:`_resident_ops`): the seed is every row's masked minimum and the
    candidate from them, once a run; each merge keeps the caches exact."""
    from repro_torch.kernels.lw_update import LazyBuffers, lazy_buffers

    def seed(s: LWState) -> LWState:
        ks = torch.arange(n, device=s.D.device)
        rmin, rarg = _masked_row_mins(s.D, s.alive, ks, ks)
        return s._replace(cache=(rmin, rarg), cand=_cached_cand(s.alive, rmin, rarg, ks))

    def buffers(s: LWState) -> LazyBuffers:
        return lazy_buffers(s.D, s.alive, s.sizes, s.merges, s.cand, s.cache, s.n_merges)

    return _resident_ops(method, seed, buffers, LazyBuffers, lazy_merge, graph)


def _lazy_ops(method: str, n: int, lw_update, device) -> StepOps:
    """The host-driven ``lazy`` primitives over a row-update function with
    the signature of :mod:`repro_torch.kernels.lw_update`: one update a
    merge, row and column ``i`` written in place (``j`` stays as garbage),
    and the cached row minima over the masked view."""

    def write(s: LWState, ij, new):
        i = ij[:1]      # new[i] == 0 keeps the diagonal
        return s.D.index_copy_(0, i, new[None, :]).index_copy_(1, i, new[:, None])

    seed, refresh = _cached_argmin(torch.arange(n, device=device))
    return StepOps(seed=seed, fetch=_fetch_rows, update=functools.partial(lw_update, method),
                   write=write, refresh=refresh)


def kernel_ops(method: str, n: int, variant: str = "baseline", device=None) -> StepOps:
    """Primitives on the CUDA kernels (their plain torch versions for CPU
    tensors): the min-scan seed and the fused merge for ``baseline`` and
    ``rowmin``; for ``lazy`` the row update's resident merge entry on a
    CUDA device, the host-driven row update elsewhere.  On a CUDA device
    the merges replay from a captured CUDA graph."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    from repro_torch.kernels.lw_step import MergeGraph

    on_card = device is not None and torch.device(device).type == "cuda"
    if variant == "lazy":
        from repro_torch.kernels.lw_update import lazy_merge, lw_update

        if on_card:
            return _lazy_resident_ops(method, n, lazy_merge,
                                      functools.partial(MergeGraph, merge=lazy_merge))
        return _lazy_ops(method, n, lw_update, device)
    from repro_torch.kernels.lw_step import lw_merge
    from repro_torch.kernels.minscan import masked_argmin

    return _fused_ops(method, n, masked_argmin, lw_merge, MergeGraph if on_card else None)


def run_kernel(D: torch.Tensor, alive: torch.Tensor, *, method: str, n_steps: int,
               variant: str = "baseline", distance_threshold: float | None = None,
               compaction: bool = False) -> LWResult:
    """The merge loop over the kernel primitives.  ``D`` is updated in place;
    slots with ``alive=False`` are dead from the start.  With
    ``compaction`` the run follows :func:`plan_stages` down to
    :data:`KERNEL_MIN_STAGE`, each later stage on a gather of the live
    slots that keeps the garbage representation; each stage seeds again
    (one min-scan launch for ``baseline``/``rowmin``, the masked row
    minima for ``lazy``) and builds its own buffers and graph.  The merges
    are those of the unstaged run, bit for bit."""
    n = D.shape[-1]
    dev = D.device
    out = staged_merge_loop(
        plan_stages(n, n_steps, min_stage=KERNEL_MIN_STAGE) if compaction else ((n, n_steps),),
        _init_state(D, alive, n_steps),
        torch.arange(n, device=dev), distance_threshold,
        ops_for=lambda size: kernel_ops(method, size, variant, dev),
        compact=lambda s, remap, size: compact_dense(s.D, s.alive, s.sizes, remap, size,
                                                     premasked=False),
    )
    return LWResult(merges=out.merges, n_merges=out.n_merges)
