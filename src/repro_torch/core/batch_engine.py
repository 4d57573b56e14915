"""The Lance-Williams merge loop over a shape bucket: ``B`` problems in
lockstep.

Counterpart of the JAX package's ``vmap`` of the merge loop
(``repro.core.batched._vmap_engine`` and
``repro.kernels.ops.lance_williams_kernelized_batch``).  A bucket is a
``(B, n, n)`` stack of problems padded to one size; lane ``b``'s slots past
its ``n_real`` are dead from the start, and a padded lane has none.  Every
lockstep merge makes one merge of every lane, in the loop state of
:mod:`repro_torch.core.engine` with a leading lane axis (``D`` ``(B, S,
S)``, ``alive`` and ``sizes`` ``(B, S)``, ``merges`` ``(B, n_steps, 4)``,
``cand`` three ``(B,)`` tensors); ``LWState.n_merges`` counts the lockstep
merges.  Two compositions:

* **serial** (:func:`run_dense_batch`): plain torch over the premasked
  bucket, each primitive of :func:`repro_torch.core.engine.dense_ops` over
  the lane axis.  It launches no hand-written kernel.  A lane that ran out
  of live pairs merges garbage (slot 0 with itself, at ``+inf``) in its own
  slices, as the reference's lanes do; those rows are past its prefix.
* **kernel** (:class:`KernelBatchLoop`, :func:`run_kernel_batch`): the
  batch-grid forms of the kernels on device-resident ``(B, …)`` buffers,
  static for a bucket shape: B1's batch seed once a stage, then one launch
  of B2's batch merge a lockstep merge (``lazy``: one launch of B3's batch
  merge, the update and the rescan), replayed from a CUDA graph of
  :data:`~repro_torch.core.engine.THRESHOLD_CHECK_TRIPS` merges captured
  once a stage when the loop is built; on the CPU their plain twins.  A
  lane that made its merges (or is padding) is a no-op in the kernels,
  keyed on its merge limit.

Lane ``b`` makes ``min(max(n_real[b] − (n − n_steps), 0), n_steps)``
merges: its own under the stop level ``n − n_steps`` that the bucket's
trip count implies.  Its merges are those of the single-problem run on its
own matrix bit for bit: padded slots are dead and sit after the live ones,
so the row-major first minimum and the arithmetic are the same.
Compaction boundaries are bucket-wide (the plan runs on the bucket's
size): one gather re-packs every lane, ascending, and a lane that ran
short packs its survivors.  A ``distance_threshold`` is checked every
``THRESHOLD_CHECK_TRIPS`` lockstep merges with one read-back: each lane's
count is the index of its first height above the threshold (NaN counts
as above), and the bucket stops once every lane has stopped.  Without a
threshold the loop reads nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (
    _INF,
    RESCAN_ROWS,
    THRESHOLD_CHECK_TRIPS,
    LWResult,
    LWState,
    StepOps,
    _cache_invalidate,
    _live_perm,
    check_knobs,
    premask,
    stage_plan,
)
from repro_torch.core.linkage import update_row

# ---------------------------------------------------------------------------
# argmin primitives over the lane axis
# ---------------------------------------------------------------------------


def _masked_pair_mins(D, alive, lanes, rows):
    """``(min, first-column argmin)`` of rows ``rows`` of lanes ``lanes``
    (two ``(k,)`` tensors) over each lane's masked view (dead rows, dead
    columns and the diagonal at ``+inf``; a fully masked row gives ``(inf,
    0)``), gathered :data:`RESCAN_ROWS` rows at a time."""
    n = alive.shape[1]
    ks = torch.arange(n, device=D.device)
    rmins, rargs = [], []
    for ls, rs in zip(lanes.split(RESCAN_ROWS), rows.split(RESCAN_ROWS)):
        a = alive.index_select(0, ls)
        valid = a & (ks != rs[:, None]) & a.gather(1, rs[:, None])
        sub = torch.where(valid, D[ls, rs], _INF)
        rm = sub.amin(dim=1)
        rmins.append(rm)
        rargs.append(torch.where(sub == rm[:, None], ks, n).amin(dim=1))
    return torch.cat(rmins), torch.cat(rargs)


def masked_row_mins_batch(D: torch.Tensor, alive: torch.Tensor):
    """Every row's masked ``(min, first-column argmin)`` of every lane, as
    ``(B, n)`` tensors."""
    B, n = alive.shape
    lanes = torch.arange(B, device=D.device).repeat_interleave(n)
    rmin, rarg = _masked_pair_mins(D, alive, lanes, torch.arange(n, device=D.device).repeat(B))
    return rmin.view(B, n), rarg.view(B, n)


def cached_cand_batch(alive, rmin, rarg):
    """Each lane's row-major first minimum from exact ``(rmin, rarg)``
    caches: ``(r, c, min)``, three ``(B,)`` tensors."""
    B, n = alive.shape
    ks = torch.arange(n, device=rmin.device)
    rvals = torch.where(alive, rmin, _INF)
    m = rvals.amin(dim=1)
    r = torch.where(rvals == m[:, None], ks, n).amin(dim=1)
    return r, rarg[torch.arange(B, device=rmin.device), r], m


def _row_major_first_min_batch(D: torch.Tensor, ks: torch.Tensor):
    """Each lane's ``(r, c, min)`` of a premasked stack with row-major
    first-minimum tie-breaking: a row-min pass and two index searches."""
    n = ks.numel()
    rowmin = D.amin(dim=2)
    m = rowmin.amin(dim=1)
    r = torch.where(rowmin == m[:, None], ks, n).amin(dim=1)
    row = D[torch.arange(D.shape[0], device=D.device), r]
    return r, torch.where(row == m[:, None], ks, n).amin(dim=1), m


# ---------------------------------------------------------------------------
# serial composition: plain torch over the premasked bucket
# ---------------------------------------------------------------------------


def dense_batch_ops(method: str, n: int, variant: str, device) -> StepOps:
    """The serial primitives of :func:`repro_torch.core.engine.dense_ops`
    over the lane axis, for a stage of ``n`` slots: ``seed`` and ``merge``
    (one lockstep merge).  ``baseline`` finds each candidate with a row-min
    pass; ``rowmin`` and ``lazy`` keep the cached row minima and rescan the
    stale rows of every lane in one gather (one read-back a merge)."""
    ks = torch.arange(n, device=device)
    cached = variant in ("rowmin", "lazy")

    def seed(s: LWState) -> LWState:
        if not cached:
            return s._replace(cand=_row_major_first_min_batch(s.D, ks))
        rmin, rarg = masked_row_mins_batch(s.D, s.alive)
        return s._replace(cache=(rmin, rarg), cand=cached_cand_batch(s.alive, rmin, rarg))

    def merge(s: LWState) -> LWState:
        r, c, m = s.cand
        lanes = torch.arange(s.D.shape[0], device=device)
        i, j = torch.minimum(r, c), torch.maximum(r, c)      # i keeps the union
        n_i, n_j = s.sizes[lanes, i], s.sizes[lanes, j]
        new_size = n_i + n_j
        s.merges[:, s.n_merges] = torch.stack((i.to(torch.float32), j.to(torch.float32), m,
                                               new_size), dim=1)
        keep = s.alive & (ks != i[:, None]) & (ks != j[:, None])
        new = torch.where(keep, update_row(method, s.D[lanes, i], s.D[lanes, j], m[:, None],
                                           n_i[:, None], n_j[:, None], s.sizes), _INF)
        s.D[lanes, i] = new
        s.D[lanes, :, i] = new
        s.D[lanes, j] = _INF
        s.D[lanes, :, j] = _INF
        s.alive[lanes, j] = False
        s.sizes[lanes, j] = 0.0
        s.sizes[lanes, i] = new_size
        s = s._replace(n_merges=s.n_merges + 1)
        if not cached:
            return s._replace(cand=_row_major_first_min_batch(s.D, ks))
        col = torch.where(keep, new, _INF)
        rmin, rarg, stale = _cache_invalidate(s.cache, torch.stack((i[:, None], j[:, None])),
                                              col, ks, s.alive)
        pairs = stale.nonzero()                  # the one read-back of a merge
        if pairs.numel():
            rm, ra = _masked_pair_mins(s.D, s.alive, pairs[:, 0], pairs[:, 1])
            rmin = rmin.index_put((pairs[:, 0], pairs[:, 1]), rm)
            rarg = rarg.index_put((pairs[:, 0], pairs[:, 1]), ra)
        return s._replace(cache=(rmin, rarg), cand=cached_cand_batch(s.alive, rmin, rarg))

    return StepOps(seed=seed, merge=merge)


# ---------------------------------------------------------------------------
# compaction over the lane axis, and the staged lockstep loop
# ---------------------------------------------------------------------------


def compact_batch(D, alive, sizes, remap, half: int, *, premasked: bool = True, out=None):
    """:func:`repro_torch.core.engine.compact_dense` for every lane in one
    pass: each lane's live rows and columns packed, ascending, into a ``(B,
    half, half)`` stack, a few rows of every lane at a time.  Returns ``(D',
    alive', sizes', remap')``; with ``out = (D', alive', sizes')`` the first
    three are written into those tensors (a static stage's buffers)."""
    B, n = alive.shape
    live, p = _live_perm(alive, half)
    Dn = torch.empty((B, half, half), dtype=D.dtype, device=D.device) if out is None else out[0]
    step = max(1, RESCAN_ROWS // B)
    for a in range(0, half, step):
        rows = p[:, a:a + step]
        block = D.gather(1, rows[:, :, None].expand(-1, -1, n))
        Dn[:, a:a + rows.shape[1]] = block.gather(2, p[:, None, :].expand(-1, rows.shape[1], -1))
    if premasked:
        premask(Dn, live)
    new_sizes = torch.where(live, sizes.gather(1, p), 0.0)
    if out is not None:
        live, new_sizes = out[1].copy_(live), out[2].copy_(new_sizes)
    return Dn, live, new_sizes, remap.gather(1, p)


def _remap_rows(merges, remap, start: int, stop: int) -> None:
    """Rewrite lockstep merges ``[start, stop)`` of every lane from a
    stage's compacted slots to original ids, in place."""
    if stop > start:
        ij = merges[:, start:stop, :2]
        ij.copy_(remap.gather(1, ij.reshape(ij.shape[0], -1).to(torch.int64)).reshape(ij.shape))


def _trips(ops: StepOps, state: LWState, start: int, stop: int) -> LWState:
    if ops.replay is not None:
        while stop - start >= THRESHOLD_CHECK_TRIPS:
            state = ops.replay(state)
            start += THRESHOLD_CHECK_TRIPS
    for _ in range(start, stop):
        state = ops.merge(state)
    return state


def run_batch_loop(stages, state: LWState, limit: torch.Tensor,
                   distance_threshold: float | None, *, ops_for, compact) -> LWResult:
    """The staged lockstep loop of both compositions: per stage, after the
    first, ``compact(state, remap, size)`` re-packs every lane; then
    ``ops_for(size)`` seeds and runs the stage's lockstep merges, and the
    stage's records are rewritten to original slot ids.  Returns the
    ``(B, n_steps, 4)`` records and each lane's merge count, ``(B,)`` on
    the device: ``limit``, or with a threshold the index of the lane's
    first height above it.  Rows past a lane's count are not its merges."""
    B, n = state.alive.shape
    n_steps = state.merges.shape[1]
    remap = torch.arange(n, device=limit.device).expand(B, n)
    counts = limit.clone()
    thr = None if distance_threshold is None else float(np.float32(distance_threshold))
    start, stopped = 0, False
    for si, (size, steps) in enumerate(stages):
        if stopped or steps <= 0:
            break
        if si > 0:
            D, alive, sizes, remap = compact(state, remap, size)
            state = LWState(D, alive, sizes, state.merges, state.n_merges, state.cand, ())
        ops = ops_for(size)
        state = ops.seed(state)
        stop = start + steps
        for a in range(start, stop, THRESHOLD_CHECK_TRIPS if thr is not None else steps):
            b = min(a + THRESHOLD_CHECK_TRIPS, stop) if thr is not None else stop
            state = _trips(ops, state, a, b)
            if thr is not None:
                t = torch.arange(a, b, device=limit.device)
                over = ~(state.merges[:, a:b, 2] <= thr) & (t < limit[:, None])
                counts = torch.minimum(counts, torch.where(over, t, n_steps).amin(dim=1))
                if bool((counts <= b).all()):   # the one read-back of a chunk
                    stopped = True
                    break
        if si > 0:
            _remap_rows(state.merges, remap, start, state.n_merges)
        start = stop
    return LWResult(merges=state.merges, n_merges=counts)


def _init_batch_state(D, alive, n_steps: int) -> LWState:
    B = alive.shape[0]
    zero = torch.zeros(B, dtype=torch.int64, device=D.device)
    return LWState(D=D, alive=alive, sizes=alive.to(torch.float32),
                   merges=torch.zeros((B, n_steps, 4), dtype=torch.float32, device=D.device),
                   n_merges=0, cand=(zero, zero, torch.zeros(B, device=D.device)), cache=())


def lane_limits(alive: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Each lane's merge count ``min(max(n_real − (n − n_steps), 0),
    n_steps)``, ``n_real`` its live slots, on the device."""
    return (alive.sum(1) - (alive.shape[1] - n_steps)).clamp(0, n_steps)


def run_dense_batch(D: torch.Tensor, alive: torch.Tensor, *, method: str, n_steps: int,
                    variant: str = "baseline", distance_threshold: float | None = None,
                    compaction: bool = False) -> LWResult:
    """The serial lockstep loop over the symmetric ``(B, n, n)`` bucket
    ``D`` (premasked, then updated in place) with ``(B, n)`` liveness
    ``alive``: ``n_steps`` lockstep merges, staged on the bucket's size
    with ``compaction``.  Returns the records ``(B, n_steps, 4)`` and each
    lane's merge count ``(B,)``, both on the device."""
    check_knobs(method, variant)
    n, dev = alive.shape[1], D.device
    return run_batch_loop(
        stage_plan("serial", n, n_steps, compaction),
        _init_batch_state(premask(D, alive), alive, n_steps), lane_limits(alive, n_steps),
        distance_threshold,
        ops_for=lambda size: dense_batch_ops(method, size, variant, dev),
        compact=lambda s, remap, size: compact_batch(s.D, s.alive, s.sizes, remap, size),
    )


class KernelBatchLoop:
    """The kernel lockstep loop of one bucket shape on static buffers:
    built once, run many times (a service's bucket programs run it again
    and again; :func:`run_kernel_batch` builds one for one run).

    Every tensor the loop's merges touch is allocated by the loop, around
    the ``(B, n, n)`` operand ``D`` (stage 0's matrix, kept and updated in
    place by a run): the liveness, sizes, the ``(B, n_steps, 4)`` record
    and the lanes' merge limits here, and for each compaction stage of the
    plan its matrix, liveness and sizes (after the first) and its merge
    buffers (:class:`~repro_torch.kernels.lw_step.MergeBatchBuffers`, or
    for ``lazy`` :class:`~repro_torch.kernels.lw_update.LazyBatchBuffers`
    with the row-minimum caches).  On a CUDA device each stage of at least
    :data:`~repro_torch.core.engine.THRESHOLD_CHECK_TRIPS` merges captures
    its :class:`~repro_torch.kernels.lw_step.MergeGraph` once.  A stage is
    built when a run first reaches it, so a one-shot run that stops early
    pays for no later stage; ``eager=True`` builds every stage here (a
    cached program, whose runs then build and capture nothing).

    :meth:`run` writes the lanes' liveness, sizes, limits and a cleared
    record, then runs :func:`run_batch_loop`; each stage's seed resets its
    buffers in place (the merge count at the stage's start, the per-row
    minima, B2's sync words and tickets, and for ``lazy`` the caches from
    the seed's scan) before it writes the candidate.  The merges are a
    fresh loop's bit for bit.
    """

    def __init__(self, D: torch.Tensor, *, method: str, n_steps: int,
                 variant: str = "baseline", compaction: bool = False, eager: bool = False):
        check_knobs(method, variant)
        B, n, dev = D.shape[0], D.shape[-1], D.device
        self.method, self.variant, self.D = method, variant, D
        self.stages = stage_plan("kernel", n, n_steps, compaction)
        self.alive = torch.zeros((B, n), dtype=torch.bool, device=dev)
        self.sizes = torch.zeros((B, n), dtype=torch.float32, device=dev)
        self.merges = torch.zeros((B, n_steps, 4), dtype=torch.float32, device=dev)
        self.limit = torch.zeros(B, dtype=torch.int64, device=dev)
        zero = torch.zeros(B, dtype=torch.int64, device=dev)
        self._cand = (zero, zero, torch.zeros(B, dtype=torch.float32, device=dev))
        self._stages: dict[int, tuple] = {}
        if eager:
            for size, _ in self.stages:
                self._stage(size)

    def _stage(self, size: int) -> tuple:
        """The stage of ``size`` slots: ``(start, buffers, merge, sync words,
        graph)``, built (and on a card captured) on first use."""
        if size in self._stages:
            return self._stages[size]
        from repro_torch.kernels import lw_step, lw_update

        B, dev = self.D.shape[0], self.D.device
        si = [s for s, _ in self.stages].index(size)
        start, steps = sum(k for _, k in self.stages[:si]), self.stages[si][1]
        if si == 0:
            Ds, alive, sizes = self.D, self.alive, self.sizes
        else:
            Ds = torch.zeros((B, size, size), dtype=torch.float32, device=dev)
            alive = torch.zeros((B, size), dtype=torch.bool, device=dev)
            sizes = torch.zeros((B, size), dtype=torch.float32, device=dev)
        if self.variant == "lazy":
            cache = (torch.full((B, size), _INF, device=dev),
                     torch.zeros((B, size), dtype=torch.int64, device=dev))
            b = lw_update.lazy_batch_buffers(Ds, alive, sizes, self.merges, self._cand, cache,
                                             start, self.limit)
            merge, sync = lw_update.lazy_merge_batch, ()     # B3's batch form has none
        else:
            b = lw_step.merge_batch_buffers(Ds, alive, sizes, self.merges, self._cand, start,
                                            self.limit)
            merge, sync = lw_step.lw_merge_batch, (lw_step._KEY_INIT, 0)
        graph = (lw_step.MergeGraph(self.method, b, THRESHOLD_CHECK_TRIPS, merge=merge)
                 if dev.type == "cuda" and steps >= THRESHOLD_CHECK_TRIPS else None)
        self._stages[size] = (start, b, merge, sync, graph)
        return self._stages[size]

    def tensors(self) -> list[torch.Tensor]:
        """Every static device tensor of the loop (views of one storage
        once): the operand, the record and each built stage's buffers."""
        seen, out = set(), []
        own = [self.D, self.alive, self.sizes, self.merges, self.limit, *self._cand]
        for t in own + [t for _, b, *_ in self._stages.values() for t in b]:
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                out.append(t)
        return out

    def _ops(self, size: int) -> StepOps:
        from repro_torch.kernels.lw_step import alive_bits
        from repro_torch.kernels.minscan import masked_argmin_batch

        start, b, merge_fn, sync, graph = self._stage(size)
        lazy = self.variant == "lazy"

        def seed(s: LWState) -> LWState:
            b.count.fill_(start)
            for k, w in enumerate(sync):
                b.sync[:, k].fill_(w)
            if lazy:
                b.rescanned.zero_()
                rmin, rarg = masked_row_mins_batch(s.D, s.alive)
                r, c, m = cached_cand_batch(s.alive, rmin, rarg)
                b.rmin.copy_(rmin)
                b.rarg.copy_(rarg)
            else:
                b.bits.copy_(alive_bits(s.alive))
                b.rmin.fill_(_INF)
                b.rarg.zero_()
                m, flat = masked_argmin_batch(s.D, s.alive)
                r, c = torch.div(flat, size, rounding_mode="floor"), flat % size
            b.cand[:, 0].copy_(r)
            b.cand[:, 1].copy_(c)
            b.dmin.copy_(m)
            return s._replace(cand=(b.cand[:, 0], b.cand[:, 1], b.dmin), cache=b)

        def merge(s: LWState) -> LWState:
            merge_fn(self.method, b)
            return s._replace(n_merges=s.n_merges + 1)

        def replay(s: LWState) -> LWState:
            graph.replay()
            return s._replace(n_merges=s.n_merges + graph.merges)

        return StepOps(seed=seed, merge=merge, replay=None if graph is None else replay)

    def _compact(self, s: LWState, remap: torch.Tensor, size: int):
        b = self._stage(size)[1]
        return compact_batch(s.D, s.alive, s.sizes, remap, size, premasked=False,
                             out=(b.D, b.alive, b.sizes))

    def run(self, alive: torch.Tensor, distance_threshold: float | None = None) -> LWResult:
        """One run over the operand ``D`` (symmetric, updated in place) with
        ``(B, n)`` liveness ``alive``: as :func:`run_kernel_batch` returns,
        the record being the loop's own static tensor."""
        self.alive.copy_(alive)
        self.sizes.copy_(alive)
        self.limit.copy_(lane_limits(alive, self.merges.shape[1]))
        self.merges.zero_()
        state = LWState(self.D, self.alive, self.sizes, self.merges, 0, (), ())
        return run_batch_loop(self.stages, state, self.limit, distance_threshold,
                              ops_for=self._ops, compact=self._compact)


def run_kernel_batch(D: torch.Tensor, alive: torch.Tensor, *, method: str, n_steps: int,
                     variant: str = "baseline", distance_threshold: float | None = None,
                     compaction: bool = False) -> LWResult:
    """The kernel lockstep loop over the symmetric ``(B, n, n)`` bucket
    ``D`` (updated in place) with ``(B, n)`` liveness ``alive``: ``n_steps``
    lockstep merges on the batch-grid kernels, staged down to
    :data:`~repro_torch.core.engine.KERNEL_MIN_STAGE` with ``compaction``
    (each stage seeds again, on its own buffers and graph).  One run of a
    :class:`KernelBatchLoop` built around ``D``.  Returns as
    :func:`run_dense_batch`."""
    loop = KernelBatchLoop(D, method=method, n_steps=n_steps, variant=variant,
                           compaction=compaction)
    return loop.run(alive, distance_threshold)
