"""Lance-Williams row update of one merge: the ``lazy`` variant's update.

Replaces the Pallas TPU kernel :func:`repro.kernels.lw_update.lw_update_pallas`
with the hand-written CUDA kernel ``csrc/lw_update.cu``.  For the merge of
slots ``i`` and ``j`` it gives the merged row
``aᵢ·D(k,i) + aⱼ·D(k,j) + b·D(i,j) + g·|D(k,i) − D(k,j)|`` for every
spectator ``k``, and 0 where ``keep`` is false (dead slots, ``i`` and
``j``), as the TPU kernel does.

Bound: bytes.  The bool mask is read and one float32 row written on every
lane; rows ``i`` and ``j`` (and, for ward, ``sizes``) are read on the kept
lanes only, and each method reads only the merge scalars its coefficients
use: with every lane kept, ``17·n + 12`` bytes for ward and ``13·n + 4``
for complete; at n = 16384 they stay in L2.  The kernel is one thread a
lane and masks its own ragged edge (no 128-lane padding); it rounds each
operation as :func:`repro_torch.core.linkage.update_row`, so it agrees bit
for bit with the plain version.  A launch of 64 blocks is launch-bound.

The ``lazy`` loop on the card runs the kernel's merge entry instead:
:func:`lazy_merge` is one whole merge on :class:`LazyBuffers`, in two
launches that read nothing back.  The first applies this update to row and
column ``i`` in place and the cached row minima's invalidation lane by
lane, reduces row ``i``'s own minimum and lists the other stale rows; the
second (:func:`lazy_rescan`) rescans the listed rows and leaves the next
candidate on the device.  :class:`~repro_torch.kernels.lw_step.MergeGraph`
captures a chunk of such merges as a CUDA graph.  Bound: bytes,
``(33 + 4·s)·n + 12·c`` a merge with ``s`` stale rows and ``c`` cache
entries rewritten (the stale rows' and the lowered ones'), and latency in
practice.

:func:`lazy_merge_batch` is that merge's batch-grid form, the batched
kernel engine's ``lazy`` merge, with a body of its own
(``csrc/lazy_merge_batch.cu``): one launch merges every lane of ``B``
stacked problems in lockstep, on :class:`LazyBatchBuffers` (a leading lane
axis, and each lane's merge limit: a lane that made its merges, or is
padding, is a no-op).  A block or a thread-block cluster owns a lane, as
:func:`lazy_batch_plan` lays it out; the update and the rescan are two
phases of the launch.  The TPU package batches the row-update kernel
through ``pallas_call``'s ``vmap`` rule.  Bound: bytes, the sum of each
active lane's ``(33 + 4·s)·n + 12·c``, and latency in practice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.linkage import METHODS, update_row
from repro_torch.kernels import _build
from repro_torch.kernels._build import INT_OUT, MAX_CLUSTER, sm_count
from repro_torch.kernels.lw_step import device_words


def lw_update_plain(method, d_ki, d_kj, d_ij, n_i, n_j, sizes, keep):
    """The plain torch version of the kernel, on any device."""
    return torch.where(keep, update_row(method, d_ki, d_kj, d_ij, n_i, n_j, sizes), 0.0)


@functools.cache
def _lib():
    lib = _build.load("lw_update")
    lib.lw_update.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 7,
                              ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    state = [*[ctypes.c_void_p] * 4, ctypes.c_longlong, *[ctypes.c_void_p] * 9,
             ctypes.c_longlong, ctypes.c_void_p]
    lib.lazy_merge.argtypes = [ctypes.c_int, ctypes.c_int, *state]
    lib.lazy_rescan.argtypes = [ctypes.c_int, *state]
    lib.lazy_merge_load.argtypes = [ctypes.c_int, ctypes.c_int]
    for fn in (lib.lw_update, lib.lazy_merge, lib.lazy_rescan, lib.lazy_merge_load):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _batch_lib():
    """The batch form's library, ``csrc/lazy_merge_batch.cu``."""
    lib = _build.load("lazy_merge_batch")
    lib.lazy_merge_batch.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 4,
                                     ctypes.c_longlong, *[ctypes.c_void_p] * 6,
                                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                                     *[ctypes.c_int] * 3, ctypes.c_void_p]
    lib.lazy_merge_batch_load.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                          *[ctypes.c_int] * 3, INT_OUT, INT_OUT, INT_OUT]
    for fn in (lib.lazy_merge_batch, lib.lazy_merge_batch_load):
        fn.restype = ctypes.c_int
    return lib


def lw_update(method, d_ki, d_kj, d_ij, n_i, n_j, sizes, keep):
    """The merged row ``(n,)`` float32, 0 where ``keep`` is false.

    ``d_ki``, ``d_kj``: ``(n,)`` float32 rows ``i`` and ``j``; ``sizes``:
    ``(n,)`` float32; ``keep``: ``(n,)`` bool; ``d_ij``, ``n_i``, ``n_j``:
    one-element float32 tensors, which stay on the device, so the launch
    never waits for the card.  A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    n = d_ki.shape[0]
    if d_ki.ndim != 1 or n < 1:
        raise ValueError(f"lw_update needs a non-empty row, got {tuple(d_ki.shape)}")
    if d_ki.device.type == "cpu":
        return lw_update_plain(method, d_ki, d_kj, d_ij, n_i, n_j, sizes, keep)
    for t, dtype, numel in ((d_kj, torch.float32, n), (sizes, torch.float32, n),
                            (keep, torch.bool, n), (d_ij, torch.float32, 1),
                            (n_i, torch.float32, 1), (n_j, torch.float32, 1)):
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"lw_update operand: expected {numel} x {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    _build.check_cuda(d_ki, torch.float32, d_kj, sizes, keep, d_ij, n_i, n_j)
    out = torch.empty(n, dtype=torch.float32, device=d_ki.device)
    err = _lib().lw_update(
        d_ki.device.index, METHODS.index(method), d_ki.data_ptr(), d_kj.data_ptr(),
        sizes.data_ptr(), keep.data_ptr(), d_ij.data_ptr(), n_i.data_ptr(), n_j.data_ptr(),
        n, out.data_ptr(), _build.raw_stream(d_ki.device.index),
    )
    if err:
        raise RuntimeError(f"lw_update kernel launch failed: CUDA error {err}")
    lw_update.launches += 1
    return out


lw_update.launches = 0


#: The sync words between launches: the two running-minimum keys at
#: ``(+inf, 0)`` (the unsigned ``0xFF80000000000000`` as an int64) and the
#: two tickets at 0.
_SYNC_INIT = (-(1 << 55), 0, -(1 << 55), 0)


class LazyBuffers(NamedTuple):
    """The resident ``lazy`` loop's state, updated in place by each merge.

    ``D`` ``(n, n)`` float32 (garbage representation), ``alive`` ``(n,)``
    bool, ``sizes`` ``(n,)`` float32, ``merges`` ``(cap, 4)`` float32 rows
    ``(i, j, dist, new_size)``, ``count`` ``(1,)`` int64 (the merges
    recorded, the row the next one is written to); ``cand`` ``(2,)`` int64
    and ``dmin`` ``(1,)`` float32, the merge to make next, ``(r, c)`` and
    ``D(r, c)``; ``rmin``/``rarg`` ``(n,)`` float32/int64, each row's cached
    ``(min, first column)`` over the masked view; ``stale`` ``(n,)`` int32
    and ``n_stale`` ``(1,)`` int32, the rows the rescan takes (empty between
    merges); ``rescanned`` ``(1,)`` int64, the stale rows rescanned so far;
    ``sync`` ``(4,)`` int64, the kernels' running-minimum keys and tickets.
    """

    D: torch.Tensor
    alive: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    count: torch.Tensor
    cand: torch.Tensor
    dmin: torch.Tensor
    rmin: torch.Tensor
    rarg: torch.Tensor
    stale: torch.Tensor
    n_stale: torch.Tensor
    rescanned: torch.Tensor
    sync: torch.Tensor


def lazy_buffers(D, alive, sizes, merges, cand, cache, n_merges: int) -> LazyBuffers:
    """Buffers around the loop state ``D``, ``alive``, ``sizes``, ``merges``
    and the caches ``cache = (rmin, rarg)`` (kept, not copied), with the
    candidate ``cand = (r, c, dmin)`` and ``n_merges`` merges recorded."""
    n, dev = D.shape[0], D.device
    r, c, dmin = cand
    rmin, rarg = cache
    return LazyBuffers(
        D=D, alive=alive, sizes=sizes, merges=merges,
        count=torch.full((1,), n_merges, dtype=torch.int64, device=dev),
        cand=torch.stack((r, c)).to(torch.int64).reshape(2),
        dmin=torch.as_tensor(dmin, dtype=torch.float32, device=dev).reshape(1).clone(),
        rmin=rmin, rarg=rarg,
        stale=torch.zeros(n, dtype=torch.int32, device=dev),
        n_stale=torch.zeros(1, dtype=torch.int32, device=dev),
        rescanned=torch.zeros(1, dtype=torch.int64, device=dev),
        sync=device_words(_SYNC_INIT, dev),
    )


def _lazy_update_plain(method: str, b: LazyBuffers) -> None:
    """The merge launch's plain version: the row update written into row
    and column ``i``, the record and bookkeeping, the caches' invalidation,
    row ``i``'s own minimum, and the other stale rows listed (ascending,
    padded with ``n``).  Reads nothing back."""
    from repro_torch.core.engine import _INF, _cache_invalidate, _first_where

    n = b.D.shape[0]
    ks = torch.arange(n, device=b.D.device)
    r, c = b.cand[0], b.cand[1]
    ij = torch.stack((torch.minimum(r, c), torch.maximum(r, c)))   # i keeps the union
    n_ij = b.sizes.index_select(0, ij)
    rows = b.D.index_select(0, ij)
    keep = b.alive & (ks != ij[0]) & (ks != ij[1])
    new = lw_update_plain(method, rows[0], rows[1], b.dmin, n_ij[:1], n_ij[1:], b.sizes, keep)
    b.D.index_copy_(0, ij[:1], new[None, :]).index_copy_(1, ij[:1], new[:, None])
    new_size = n_ij.sum()
    b.merges.index_copy_(0, b.count, torch.cat((ij.to(torch.float32), b.dmin,
                                                new_size.reshape(1)))[None])
    b.count.add_(1)
    b.alive.index_fill_(0, ij[1:], False)
    b.sizes.index_fill_(0, ij[1:], 0.0).index_put_((ij[:1],), new_size.reshape(1))
    col = torch.where(keep, new, _INF)
    rmin, rarg, stale = _cache_invalidate((b.rmin, b.rarg), ij, col, ks, b.alive)
    # row i is stale whenever it is alive: its masked row is column i's kept lanes
    m_i = col.amin()
    row_i = stale & (ks == ij[0])
    rmin = torch.where(row_i, m_i, rmin)
    rarg = torch.where(row_i, _first_where(col == m_i, ks), rarg)
    listed = stale & ~row_i
    b.stale.copy_(torch.sort(torch.where(listed, ks, n)).values)
    b.n_stale.copy_(listed.sum().reshape(1))
    b.rmin.copy_(rmin)
    b.rarg.copy_(rarg)


def lazy_rescan_plain(b: LazyBuffers) -> LazyBuffers:
    """The plain version of :func:`lazy_rescan`, on any device, in place:
    every row rescanned over the masked view and the listed ones kept, then
    the next candidate from the caches (the first live row attaining the
    minimum, then its cached column).  Reads nothing back."""
    from repro_torch.core.engine import _cached_cand, _masked_row_mins

    n = b.D.shape[0]
    ks = torch.arange(n, device=b.D.device)
    listed = torch.where(ks < b.n_stale, b.stale.to(torch.int64), n)
    mask = torch.zeros(n + 1, dtype=torch.bool, device=b.D.device).index_fill_(0, listed, True)[:n]
    rm, ra = _masked_row_mins(b.D, b.alive, ks, ks)
    rmin, rarg = torch.where(mask, rm, b.rmin), torch.where(mask, ra, b.rarg)
    r, c, m = _cached_cand(b.alive, rmin, rarg, ks)
    b.rmin.copy_(rmin)
    b.rarg.copy_(rarg)
    b.cand.copy_(torch.stack((r, c)))
    b.dmin.copy_(m.reshape(1))
    b.rescanned.add_(b.n_stale)
    b.n_stale.zero_()
    return b


def lazy_merge_plain(method: str, b: LazyBuffers) -> LazyBuffers:
    """The plain torch version of :func:`lazy_merge`, on any device, in
    place: the merge launch's work, then the rescan's.  Torch ops only,
    one-element index tensors, nothing read back."""
    _lazy_update_plain(method, b)
    return lazy_rescan_plain(b)


def _check_lazy(b: LazyBuffers) -> int:
    n = b.D.shape[0] if b.D.ndim else 0
    if b.D.ndim != 2 or b.D.shape[1] != n or not 1 <= n < 2**31:
        raise ValueError(f"lazy_merge needs a non-empty square matrix, got {tuple(b.D.shape)}")
    if b.merges.ndim != 2 or b.merges.shape[1] != 4:
        raise ValueError(f"lazy_merge merges must be (cap, 4), got {tuple(b.merges.shape)}")
    for t, dtype, numel in ((b.alive, torch.bool, n), (b.sizes, torch.float32, n),
                            (b.merges, torch.float32, b.merges.numel()),
                            (b.count, torch.int64, 1), (b.cand, torch.int64, 2),
                            (b.dmin, torch.float32, 1), (b.rmin, torch.float32, n),
                            (b.rarg, torch.int64, n), (b.stale, torch.int32, n),
                            (b.n_stale, torch.int32, 1), (b.rescanned, torch.int64, 1),
                            (b.sync, torch.int64, 4)):
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"lazy_merge operand: expected {numel} x {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    return n


def _state_args(b: LazyBuffers, n: int) -> list:
    return [b.D.data_ptr(), b.alive.data_ptr(), b.sizes.data_ptr(), b.merges.data_ptr(),
            b.merges.shape[0], *(t.data_ptr() for t in b[4:]), n,
            _build.raw_stream(b.D.device.index)]


def lazy_rescan(b: LazyBuffers) -> LazyBuffers:
    """The second launch of a resident ``lazy`` merge, in place on ``b``:
    each listed stale row's ``(min, first column)`` over the masked view,
    then the next candidate, and the list emptied.  A CUDA tensor launches
    the kernel (a fixed grid of 132 blocks, a block a stale row); a CPU
    tensor takes the plain version."""
    n = _check_lazy(b)
    if b.D.device.type == "cpu":
        return lazy_rescan_plain(b)
    _build.check_cuda(b.D, torch.float32, *b[1:])
    err = _lib().lazy_rescan(b.D.device.index, *_state_args(b, n))
    if err:
        raise RuntimeError(f"lazy_rescan kernel launch failed: CUDA error {err}")
    lazy_rescan.launches += 1
    return b


lazy_rescan.launches = 0


def lazy_merge(method: str, b: LazyBuffers) -> LazyBuffers:
    """One merge of the resident ``lazy`` loop, in place on ``b``: the merge
    of the candidate ``b.cand``, its record at row ``b.count`` of
    ``b.merges``, slot ``j`` tombstoned, the caches brought up to date and
    the next candidate.

    On a CUDA tensor two launches that read nothing back and allocate
    nothing: the merge kernel (counted here), then :func:`lazy_rescan`
    (counted there); a run of merges can be captured as a CUDA graph
    (:class:`~repro_torch.kernels.lw_step.MergeGraph`).  A CPU tensor takes
    the plain version.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    n = _check_lazy(b)
    if b.D.device.type == "cpu":
        return lazy_merge_plain(method, b)
    _build.check_cuda(b.D, torch.float32, *b[1:])
    err = _lib().lazy_merge(b.D.device.index, METHODS.index(method), *_state_args(b, n))
    if err:
        raise RuntimeError(f"lazy_merge kernel launch failed: CUDA error {err}")
    lazy_merge.launches += 1
    return lazy_rescan(b)


def _load_lazy_merge(method: str, b: LazyBuffers) -> None:
    err = _lib().lazy_merge_load(b.D.device.index, METHODS.index(method))
    if err:
        raise RuntimeError(f"lazy_merge kernel load failed: CUDA error {err}")


lazy_merge.launches = 0
lazy_merge.load = _load_lazy_merge
lazy_merge.counters = (lazy_merge, lazy_rescan)


class LazyBatchBuffers(NamedTuple):
    """:class:`LazyBuffers` of ``B`` stacked problems in lockstep, each
    field with a leading lane axis (``D`` ``(B, n, n)``, ``merges`` ``(B,
    cap, 4)``, ``cand`` ``(B, 2)``, ...), but no sync words, and ``limit``
    ``(B,)`` int64, the merges each lane makes: a lane whose ``count``
    reached it only adds one to ``count``, which then counts the lockstep
    merges, and its rescan does nothing.  The batch kernel lists stale rows
    and keeps its running minima in shared memory: ``stale`` and
    ``n_stale`` serve the plain twin, whose update writes them before its
    rescan reads them, and no launch writes them."""

    D: torch.Tensor
    alive: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    count: torch.Tensor
    cand: torch.Tensor
    dmin: torch.Tensor
    rmin: torch.Tensor
    rarg: torch.Tensor
    stale: torch.Tensor
    n_stale: torch.Tensor
    rescanned: torch.Tensor
    limit: torch.Tensor


def lazy_batch_buffers(D, alive, sizes, merges, cand, cache, start: int, limit) -> LazyBatchBuffers:
    """Batch buffers around the lanes' ``D``, ``alive``, ``sizes``,
    ``merges`` and caches ``cache = (rmin, rarg)`` (kept, not copied), with
    each lane's candidate ``cand = (r, c, dmin)`` (``(B,)`` tensors),
    ``start`` lockstep merges made and the merge ``limit`` ``(B,)``."""
    B, n = alive.shape
    dev = D.device
    r, c, dmin = cand
    rmin, rarg = cache
    return LazyBatchBuffers(
        D=D, alive=alive, sizes=sizes, merges=merges,
        count=torch.full((B,), start, dtype=torch.int64, device=dev),
        cand=torch.stack((r, c), dim=1).to(torch.int64),
        dmin=dmin.to(torch.float32).clone(),
        rmin=rmin, rarg=rarg,
        stale=torch.zeros((B, n), dtype=torch.int32, device=dev),
        n_stale=torch.zeros(B, dtype=torch.int32, device=dev),
        rescanned=torch.zeros(B, dtype=torch.int64, device=dev),
        limit=limit.to(torch.int64),
    )


def _lazy_update_batch_plain(method: str, b: LazyBatchBuffers) -> None:
    """The batch update's plain version: each active lane (``count <
    limit``) as :func:`_lazy_update_plain`, the others unchanged; every
    lane's ``count`` advanced."""
    from repro_torch.core.engine import _INF, _cache_invalidate

    B, n = b.alive.shape
    lanes = torch.arange(B, device=b.D.device)
    ks = torch.arange(n, device=b.D.device)
    active = b.count < b.limit
    act = active[:, None]
    i = torch.minimum(b.cand[:, 0], b.cand[:, 1])      # i keeps the union
    j = torch.maximum(b.cand[:, 0], b.cand[:, 1])
    n_i, n_j = b.sizes[lanes, i], b.sizes[lanes, j]
    row_i, row_j, col_i = b.D[lanes, i], b.D[lanes, j], b.D[lanes, :, i]
    keep = b.alive & (ks != i[:, None]) & (ks != j[:, None])
    new = lw_update_plain(method, row_i, row_j, b.dmin[:, None], n_i[:, None], n_j[:, None],
                          b.sizes, keep)
    b.D[lanes, i] = torch.where(act, new, row_i)
    b.D[lanes, :, i] = torch.where(act, new, col_i)
    new_size = n_i + n_j
    at = b.count.clamp_max(b.merges.shape[1] - 1)
    rec = torch.stack((i.to(torch.float32), j.to(torch.float32), b.dmin, new_size), dim=1)
    b.merges[lanes, at] = torch.where(act, rec, b.merges[lanes, at])
    b.count.add_(1)
    b.alive[lanes, j] = b.alive[lanes, j] & ~active
    b.sizes[lanes, j] = torch.where(active, 0.0, n_j)
    b.sizes[lanes, i] = torch.where(active, new_size, b.sizes[lanes, i])
    col = torch.where(keep, new, _INF)
    ij = torch.stack((i[:, None], j[:, None]))
    rmin, rarg, stale = _cache_invalidate((b.rmin, b.rarg), ij, col, ks, b.alive)
    # row i is stale whenever it is alive: its masked row is column i's kept lanes
    m_i = col.amin(dim=1, keepdim=True)
    row_i_stale = stale & (ks == i[:, None])
    rmin = torch.where(row_i_stale, m_i, rmin)
    rarg = torch.where(row_i_stale, torch.where(col == m_i, ks, n).amin(dim=1, keepdim=True),
                       rarg)
    listed = stale & ~row_i_stale & act
    b.stale.copy_(torch.sort(torch.where(listed, ks, n), dim=1).values)
    b.n_stale.copy_(torch.where(active, listed.sum(1), b.n_stale))
    b.rmin.copy_(torch.where(act, rmin, b.rmin))
    b.rarg.copy_(torch.where(act, rarg, b.rarg))


def lazy_rescan_batch_plain(b: LazyBatchBuffers) -> LazyBatchBuffers:
    """The batch rescan's plain version, on any device, in place: each
    lane whose update was not a no-op (``count <= limit`` after it) as
    :func:`lazy_rescan_plain`, the others unchanged."""
    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch

    B, n = b.alive.shape
    ks = torch.arange(n, device=b.D.device)
    active = b.count <= b.limit
    act = active[:, None]
    listed = torch.where(ks < b.n_stale[:, None], b.stale.to(torch.int64), n)
    mask = torch.zeros((B, n + 1), dtype=torch.bool, device=b.D.device)
    mask = mask.scatter_(1, listed, True)[:, :n] & act
    rm, ra = masked_row_mins_batch(b.D, b.alive)
    rmin, rarg = torch.where(mask, rm, b.rmin), torch.where(mask, ra, b.rarg)
    r, c, m = cached_cand_batch(b.alive, rmin, rarg)
    b.rmin.copy_(rmin)
    b.rarg.copy_(rarg)
    b.cand.copy_(torch.where(act, torch.stack((r, c), dim=1), b.cand))
    b.dmin.copy_(torch.where(active, m, b.dmin))
    b.rescanned.add_(torch.where(active, b.n_stale, 0))
    b.n_stale.copy_(torch.where(active, 0, b.n_stale))
    return b


def lazy_merge_batch_plain(method: str, b: LazyBatchBuffers) -> LazyBatchBuffers:
    """The plain torch version of :func:`lazy_merge_batch`, on any device,
    in place: the update (row and column ``i``, the caches' invalidation,
    the stale list), then the rescan."""
    _lazy_update_batch_plain(method, b)
    return lazy_rescan_batch_plain(b)


def _check_lazy_batch(b: LazyBatchBuffers) -> tuple[int, int]:
    if b.D.ndim != 3 or b.D.shape[1] != b.D.shape[2] or b.D.shape[0] < 1:
        raise ValueError(f"lazy_merge_batch needs a (B, n, n) stack, got {tuple(b.D.shape)}")
    B, n = b.D.shape[0], b.D.shape[1]
    if not 1 <= n < 2**31:
        raise ValueError(f"lazy_merge_batch needs 1 <= n < 2**31, got {n}")
    if b.merges.ndim != 3 or (b.merges.shape[0], b.merges.shape[2]) != (B, 4):
        raise ValueError(f"lazy_merge_batch merges must be ({B}, cap, 4), got "
                         f"{tuple(b.merges.shape)}")
    for t, dtype, numel in ((b.alive, torch.bool, B * n), (b.sizes, torch.float32, B * n),
                            (b.merges, torch.float32, b.merges.numel()),
                            (b.count, torch.int64, B), (b.cand, torch.int64, 2 * B),
                            (b.dmin, torch.float32, B), (b.rmin, torch.float32, B * n),
                            (b.rarg, torch.int64, B * n), (b.stale, torch.int32, B * n),
                            (b.n_stale, torch.int32, B), (b.rescanned, torch.int64, B),
                            (b.limit, torch.int64, B)):
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"lazy_merge_batch operand: expected {numel} x {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    return B, n


#: Rows a block takes alone: it updates them in one pass, 4 columns a thread of 256, and a warp
#: rescans one in one pass of 8 float4 a thread.
_BLOCK_ROWS = 1024


class LazyPlan(NamedTuple):
    """How :func:`lazy_merge_batch` lays a launch out: ``group`` threads
    rescan a stale row, ``threads`` make a block, and ``blocks`` blocks own
    a lane (one block, or a thread-block cluster when more than one)."""

    group: int
    threads: int
    blocks: int

    def __str__(self) -> str:
        owner = "a block" if self.blocks == 1 else f"a cluster of {self.blocks}"
        return f"{owner} a lane, {self.group} threads a stale row, {self.threads} a block"


@functools.cache
def lazy_batch_plan(lanes: int, n: int, sms: int = 132) -> LazyPlan:
    """The layout of a lockstep ``lazy`` merge of ``lanes`` lanes of ``n``
    slots on a card of ``sms`` multiprocessors.  A row group of ``n / 4``
    threads rescans a stale row in one pass of a float4 a thread (4, 8 or 16
    threads up to n = 64), a warp a longer one (8 float4 a thread a pass,
    1024 columns); a block has a warp up to n = 32, 64 threads at 64, 128 at
    128 and 256 above, a thread updating up to 4 columns a pass.  A block
    owns a lane up to n = 1024, where it updates and rescans rows in one
    pass: a cluster's two barriers and its distributed shared memory cost
    more than they save there.  Longer rows go to the largest cluster (a
    power of two up to :data:`~repro_torch.kernels._build.MAX_CLUSTER`)
    whose blocks each have an SM of their own (``2 · lanes · blocks <=
    sms`` before doubling): its blocks update the row in fewer passes, and
    each rescans its few stale rows with all its warps, a pass a row
    (chip_smoke ``--batch-kernel-times`` sweeps the cluster).  Rows
    need no alignment: the rescan reads an unaligned row's head one by
    one."""
    if lanes < 1 or n < 1:
        raise ValueError(f"a batch plan needs lanes and slots, got {lanes} and {n}")
    if n <= 128:
        return (LazyPlan(4, 32, 1) if n <= 16 else LazyPlan(8, 32, 1) if n <= 32
                else LazyPlan(16, 64, 1) if n <= 64 else LazyPlan(32, 128, 1))
    blocks = 1
    while n > _BLOCK_ROWS and blocks < MAX_CLUSTER and 2 * lanes * blocks <= sms:
        blocks *= 2
    return LazyPlan(32, 256, blocks)


def lazy_merge_batch(method: str, b: LazyBatchBuffers) -> LazyBatchBuffers:
    """One lockstep ``lazy`` merge of every lane, in place on ``b``: each
    lane whose ``count`` is below its ``limit`` makes the merge
    :func:`lazy_merge` makes on its slices (the update, then the rescan);
    the others only advance ``count``.

    On a CUDA tensor one launch that reads nothing back and allocates
    nothing, laid out by :func:`lazy_batch_plan`; it leaves ``stale`` and
    ``n_stale`` as they were.  A run of lockstep merges can be
    captured as a CUDA graph
    (:class:`~repro_torch.kernels.lw_step.MergeGraph`,
    ``merge=lazy_merge_batch``).  A CPU tensor takes the plain version.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    B, n = _check_lazy_batch(b)
    if b.D.device.type == "cpu":
        return lazy_merge_batch_plain(method, b)
    _build.check_cuda(b.D, torch.float32, *b[1:])
    index = b.D.device.index
    err = _batch_lib().lazy_merge_batch(
        index, METHODS.index(method), b.D.data_ptr(), b.alive.data_ptr(), b.sizes.data_ptr(),
        b.merges.data_ptr(), b.merges.shape[1], b.count.data_ptr(), b.cand.data_ptr(),
        b.dmin.data_ptr(), b.rmin.data_ptr(), b.rarg.data_ptr(), b.rescanned.data_ptr(), n,
        b.limit.data_ptr(), B, *lazy_batch_plan(B, n, sm_count(index)),
        _build.raw_stream(index))
    if err:
        raise RuntimeError(f"lazy_merge_batch kernel launch failed: CUDA error {err}")
    lazy_merge_batch.launches += 1
    return b


def _load_lazy_merge_batch(method: str, b: LazyBatchBuffers) -> None:
    B, n = _check_lazy_batch(b)
    lazy_batch_resources(method, n, B, b.D.device)


def lazy_batch_resources(method: str, n: int, lanes: int = 1, device=None) -> dict:
    """Load the kernel that a :func:`lazy_merge_batch` launch on ``lanes``
    lanes of ``n`` slots takes on CUDA device ``device`` (default: the
    current one), and return its registers a thread, local (spilled) bytes
    a thread and the blocks an SM holds."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _batch_lib().lazy_merge_batch_load(
        index, METHODS.index(method), n, *lazy_batch_plan(lanes, n, sm_count(index)),
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"lazy_merge_batch kernel load failed: CUDA error {err}")
    return dict(regs=regs.value, local_bytes=local.value, blocks_per_sm=per_sm.value)


lazy_merge_batch.launches = 0
lazy_merge_batch.load = _load_lazy_merge_batch
lazy_merge_batch.counters = (lazy_merge_batch,)
