"""Fused one-pass Lance-Williams merge step.

Replaces the Pallas TPU kernel :func:`repro.kernels.lw_step.lw_step_pallas`
with the hand-written CUDA kernels ``csrc/lw_step.cu`` (the single-problem
entries) and ``csrc/lw_merge_batch.cu`` (the batch form).  For the merge of
slots ``i < j`` it evaluates the LW recurrence for the merged row, commits
it into row ``i`` and column ``i`` of ``D`` (row/column ``j`` stay as
garbage), and finds each row's ``(min, first-column argmin)`` of the
post-merge masked matrix, in which ``j`` is dead.

The kernel has two entries.  :func:`lw_step` is the TPU kernel's contract:
the merge's scalars in, the per-row minima out.  :func:`lw_merge` is one
whole merge of the device-resident loop on :class:`MergeBuffers`: it reads
the candidate the previous merge left on the device and leaves the next
one there, with the merge record, the liveness and the sizes updated, so
the host reads nothing back; :class:`MergeGraph` captures a chunk of such
merges as a CUDA graph and replays it.

``D`` is updated in place, and the kernel reads rows ``i`` and ``j`` from
``D`` itself: ``D`` stays exactly symmetric, so no row copies are needed.
Bound: bytes.  The step needs the ``L × L`` live cells read once and row
and column ``i`` written, about ``4·L²`` bytes for ``L`` slots live after
the merge, at 3.35 TB/s.  The kernel reads whole live rows with 16-byte
loads, ``4·L·n`` bytes, so dead columns are its gap to the bound.

:func:`lw_merge_batch` is the merge entry's batch-grid form, the batched
kernel engine's merge: one launch merges every lane of ``B`` stacked
problems in lockstep, on :class:`MergeBatchBuffers` (the same buffers with
a leading lane axis, and each lane's merge limit: a lane that made its
merges, or is padding, is a no-op).  A block or a thread-block cluster owns
a lane, as :func:`merge_batch_plan` lays it out.  The TPU package batches
the same kernel through ``pallas_call``'s ``vmap`` rule.  Bound: bytes, the
sum of each active lane's ``4·L'²`` and bookkeeping.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.linkage import METHODS, update_row
from repro_torch.kernels import _build
from repro_torch.kernels._build import INT_OUT, MAX_CLUSTER, sm_count

#: Largest ``n`` the kernel takes: its liveness bitmask fits in 48 KiB of
#: shared memory.
MAX_N = 48 * 1024 * 8

#: The running minimum's packed key between launches, ``(+inf, row 0)``
#: (the unsigned ``0xFF80000000000000`` as an int64).
_KEY_INIT = -(1 << 55)


def lw_step_plain(method, D, d_ki, d_kj, d_ij, n_i, n_j, sizes, alive, i, j):
    """The plain torch version of the kernel, on any device (``D`` in place)."""
    n = D.shape[0]
    ks = torch.arange(n, device=D.device)
    keep = alive & (ks != i) & (ks != j)
    new = torch.where(keep, update_row(method, d_ki, d_kj, d_ij, n_i, n_j, sizes), 0.0)
    slot = torch.as_tensor(i, device=D.device).reshape(1)
    D.index_copy_(1, slot, new[:, None])
    D.index_copy_(0, slot, new[None, :])
    live = alive & (ks != j)
    valid = live[:, None] & live[None, :] & (ks[:, None] != ks[None, :])
    rmin, rarg = torch.min(torch.where(valid, D, torch.inf), dim=1)  # first minimum
    return D, rmin, rarg


@functools.cache
def _lib():
    lib = _build.load("lw_step")
    lib.lw_step.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 8, ctypes.c_longlong,
                            *[ctypes.c_void_p] * 4]
    lib.lw_merge.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 5, ctypes.c_longlong,
                             *[ctypes.c_void_p] * 6, ctypes.c_longlong, ctypes.c_void_p]
    lib.lw_merge_load.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  INT_OUT, INT_OUT]
    for fn in (lib.lw_step, lib.lw_merge, lib.lw_merge_load):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _batch_lib():
    """The batch form's library, ``csrc/lw_merge_batch.cu``."""
    lib = _build.load("lw_merge_batch")
    lib.lw_merge_batch.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 5,
                                   ctypes.c_longlong, *[ctypes.c_void_p] * 5, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_longlong, *[ctypes.c_int] * 4,
                                   ctypes.c_void_p]
    lib.lw_merge_batch_load.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                        *[ctypes.c_int] * 4, INT_OUT, INT_OUT, INT_OUT]
    for fn in (lib.lw_merge_batch, lib.lw_merge_batch_load):
        fn.restype = ctypes.c_int
    return lib


def _check_square(name: str, method: str, D: torch.Tensor) -> int:
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    n = D.shape[0] if D.ndim else 0
    if D.ndim != 2 or D.shape[1] != n or n < 1:
        raise ValueError(f"{name} needs a non-empty square matrix, got {tuple(D.shape)}")
    if D.device.type == "cuda" and n > MAX_N:
        raise ValueError(f"{name} takes n <= {MAX_N}, got {n}")
    return n


def _check_operands(name: str, specs) -> None:
    for t, dtype, numel in specs:
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"{name} operand: expected {numel} x {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")


def lw_step(method, D, d_ki, d_kj, d_ij, n_i, n_j, sizes, alive, i, j):
    """One fused merge step; returns ``(D, rmin, rarg)`` with ``D`` updated
    in place.

    ``D``: ``(n, n)`` float32, exactly symmetric; ``d_ki``, ``d_kj``:
    ``(n,)`` copies of its rows ``i`` and ``j`` (the plain version reads
    them; the kernel reads the same values from ``D``); ``sizes``: ``(n,)``
    float32 and ``alive``: ``(n,)`` bool, both from before the merge;
    ``d_ij``, ``n_i``, ``n_j``: one-element float32 tensors; ``i < j``:
    one-element int64 tensors.  The scalars stay on the device, so the
    launch never waits for the card.  A CUDA tensor launches the kernel (a
    first small launch packs ``alive`` into a bitmask); a CPU tensor takes
    the plain version.
    """
    n = _check_square("lw_step", method, D)
    if D.device.type == "cpu":
        return lw_step_plain(method, D, d_ki, d_kj, d_ij, n_i, n_j, sizes, alive, i, j)
    _check_operands("lw_step", ((d_ki, torch.float32, n), (d_kj, torch.float32, n),
                                (sizes, torch.float32, n), (alive, torch.bool, n),
                                (d_ij, torch.float32, 1), (n_i, torch.float32, 1),
                                (n_j, torch.float32, 1), (i, torch.int64, 1),
                                (j, torch.int64, 1)))
    _build.check_cuda(D, torch.float32, d_ki, d_kj, sizes, alive, d_ij, n_i, n_j, i, j)
    bits = torch.empty(-(-n // 32), dtype=torch.int32, device=D.device)
    rmin = torch.empty(n, dtype=torch.float32, device=D.device)
    rarg = torch.empty(n, dtype=torch.int64, device=D.device)
    err = _lib().lw_step(
        D.device.index, METHODS.index(method), D.data_ptr(), sizes.data_ptr(), alive.data_ptr(),
        d_ij.data_ptr(), n_i.data_ptr(), n_j.data_ptr(), i.data_ptr(), j.data_ptr(), n,
        bits.data_ptr(), rmin.data_ptr(), rarg.data_ptr(), _build.raw_stream(D.device.index),
    )
    if err:
        raise RuntimeError(f"lw_step kernel launch failed: CUDA error {err}")
    lw_step.launches += 1
    return D, rmin, rarg


lw_step.launches = 0


def alive_bits(alive: torch.Tensor) -> torch.Tensor:
    """``alive`` ``(..., n)`` as ``(..., ⌈n/32⌉)`` int32 words, bit ``c % 32``
    of word ``c // 32`` set when slot ``c`` is alive (the kernel's bitmask)."""
    lead, n = alive.shape[:-1], alive.shape[-1]
    padded = torch.zeros((*lead, -(-n // 32) * 32), dtype=torch.int64, device=alive.device)
    padded[..., :n] = alive
    words = (padded.view(*lead, -1, 32) << torch.arange(32, device=alive.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def device_words(words, device, lanes: int | None = None) -> torch.Tensor:
    """The int64 ``words`` as a tensor on ``device`` (``lanes`` copies as a
    ``(lanes, len(words))`` tensor), written by fill launches, one a word: a
    copy from the host would wait for the card, and buffers built between
    two stages of a run must not."""
    shape = (len(words),) if lanes is None else (lanes, len(words))
    out = torch.zeros(shape, dtype=torch.int64, device=device)
    for k, w in enumerate(words):
        if w:
            out[..., k:k + 1].fill_(w)
    return out


class MergeBuffers(NamedTuple):
    """The device-resident loop's state, updated in place by each merge.

    ``D`` ``(n, n)`` float32 (garbage representation), ``alive`` ``(n,)``
    bool, ``bits`` the same liveness as ``(⌈n/32⌉,)`` int32 words,
    ``sizes`` ``(n,)`` float32, ``merges`` ``(cap, 4)`` float32 rows ``(i,
    j, dist, new_size)``; ``cand`` ``(2,)`` int64 and ``dmin`` ``(1,)``
    float32, the merge to make next, ``(r, c)`` and ``D(r, c)``; ``count``
    ``(1,)`` int64, the merges recorded so far (the row the next one is
    written to); ``rmin``/``rarg`` ``(n,)``, each row's ``(min, first
    column)`` after the last merge; ``sync`` ``(2,)`` int64, the kernel's
    running-minimum key and block ticket.
    """

    D: torch.Tensor
    alive: torch.Tensor
    bits: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    cand: torch.Tensor
    dmin: torch.Tensor
    count: torch.Tensor
    rmin: torch.Tensor
    rarg: torch.Tensor
    sync: torch.Tensor


def merge_buffers(D, alive, sizes, merges, cand, n_merges: int) -> MergeBuffers:
    """Buffers around the loop state ``D``, ``alive``, ``sizes`` and
    ``merges`` (kept, not copied), with the candidate ``cand = (r, c,
    dmin)`` and ``n_merges`` merges already recorded."""
    n, dev = D.shape[0], D.device
    r, c, dmin = cand
    return MergeBuffers(
        D=D, alive=alive, bits=alive_bits(alive), sizes=sizes, merges=merges,
        cand=torch.stack((r, c)).to(torch.int64).reshape(2),
        dmin=torch.as_tensor(dmin, dtype=torch.float32, device=dev).reshape(1).clone(),
        count=torch.full((1,), n_merges, dtype=torch.int64, device=dev),
        rmin=torch.full((n,), torch.inf, dtype=torch.float32, device=dev),
        rarg=torch.zeros(n, dtype=torch.int64, device=dev),
        sync=device_words((_KEY_INIT, 0), dev),
    )


def lw_merge_plain(method: str, b: MergeBuffers) -> MergeBuffers:
    """The plain torch version of :func:`lw_merge`, on any device, in place:
    the fused step of :func:`lw_step_plain` on copies of rows ``i`` and
    ``j``, the next candidate from the per-row minima (the first row that
    attains the minimum, then its first column), and the bookkeeping."""
    r, c = b.cand[0], b.cand[1]
    ij = torch.stack((torch.minimum(r, c), torch.maximum(r, c)))   # i keeps the union
    n_ij = b.sizes.index_select(0, ij)
    rows = b.D.index_select(0, ij)
    _, rmin, rarg = lw_step_plain(method, b.D, rows[0], rows[1], b.dmin[0], n_ij[0], n_ij[1],
                                  b.sizes, b.alive, ij[0], ij[1])
    new_size = n_ij.sum()
    b.merges.index_copy_(0, b.count, torch.cat((ij.to(torch.float32), b.dmin,
                                                new_size.reshape(1)))[None])
    b.count.add_(1)
    b.alive.index_fill_(0, ij[1:], False)
    b.bits.copy_(alive_bits(b.alive))
    b.sizes.index_fill_(0, ij[1:], 0.0).index_put_((ij[:1],), new_size.reshape(1))
    m, r_next = torch.min(rmin, dim=0)
    b.cand.copy_(torch.stack((r_next, rarg[r_next])))
    b.dmin.copy_(m.reshape(1))
    b.rmin.copy_(rmin)
    b.rarg.copy_(rarg)
    return b


def _check_buffers(method: str, b: MergeBuffers) -> int:
    n = _check_square("lw_merge", method, b.D)
    if b.merges.ndim != 2 or b.merges.shape[1] != 4:
        raise ValueError(f"lw_merge merges must be (cap, 4), got {tuple(b.merges.shape)}")
    _check_operands("lw_merge", (
        (b.D, torch.float32, n * n), (b.alive, torch.bool, n),
        (b.bits, torch.int32, -(-n // 32)), (b.sizes, torch.float32, n),
        (b.merges, torch.float32, b.merges.numel()), (b.cand, torch.int64, 2),
        (b.dmin, torch.float32, 1), (b.count, torch.int64, 1), (b.rmin, torch.float32, n),
        (b.rarg, torch.int64, n), (b.sync, torch.int64, 2)))
    return n


def lw_merge(method: str, b: MergeBuffers) -> MergeBuffers:
    """One merge of the device-resident loop, in place on ``b``: the merge
    of the candidate ``b.cand``, its record at row ``b.count`` of
    ``b.merges``, slot ``j`` tombstoned, and the next candidate.

    One launch that reads nothing back and allocates nothing, so a run of
    merges can be captured as a CUDA graph (:class:`MergeGraph`).  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version.
    """
    n = _check_buffers(method, b)
    if b.D.device.type == "cpu":
        return lw_merge_plain(method, b)
    _build.check_cuda(b.D, torch.float32, *b[1:])
    err = _lib().lw_merge(
        b.D.device.index, METHODS.index(method), b.D.data_ptr(), b.alive.data_ptr(),
        b.bits.data_ptr(), b.sizes.data_ptr(), b.merges.data_ptr(), b.merges.shape[0],
        b.cand.data_ptr(), b.dmin.data_ptr(), b.count.data_ptr(), b.rmin.data_ptr(),
        b.rarg.data_ptr(), b.sync.data_ptr(), n, _build.raw_stream(b.D.device.index),
    )
    if err:
        raise RuntimeError(f"lw_merge kernel launch failed: CUDA error {err}")
    lw_merge.launches += 1
    return b


#: The kernel's entries, in the order ``lw_merge_load`` numbers them.
ENTRIES = ("lw_step", "lw_merge", "lw_merge_batch")


def kernel_resources(method: str, n: int, entry: str, device=None, lanes: int = 1,
                     aligned: bool = True) -> dict:
    """Load the kernel that a launch of ``entry`` at ``n`` slots (of
    ``lanes`` lanes, for the batch form, on matrices that start on a 16-byte
    boundary where ``aligned``) takes, on CUDA device ``device`` (default:
    the current one), and return its registers a thread, local (spilled)
    bytes a thread and, for the batch form, the blocks an SM holds (0 for
    the other entries)."""
    if method not in METHODS or entry not in ENTRIES:
        raise ValueError(f"unknown method {method!r} or entry {entry!r}")
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if entry == "lw_merge_batch":
        err = _batch_lib().lw_merge_batch_load(
            index, METHODS.index(method), n,
            *merge_batch_plan(lanes, n, sm_count(index), aligned=aligned),
            ctypes.byref(regs), ctypes.byref(local), ctypes.byref(per_sm))
    else:
        err = _lib().lw_merge_load(index, METHODS.index(method), n, ENTRIES.index(entry),
                                   ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"{entry} kernel load failed: CUDA error {err}")
    return dict(regs=regs.value, local_bytes=local.value, blocks_per_sm=per_sm.value)


def _load_merge(method: str, b: MergeBuffers) -> None:
    kernel_resources(method, _check_buffers(method, b), "lw_merge", b.D.device)


lw_merge.launches = 0
lw_merge.load = _load_merge
lw_merge.counters = (lw_merge,)


class MergeBatchBuffers(NamedTuple):
    """:class:`MergeBuffers` of ``B`` stacked problems in lockstep, each
    field with a leading lane axis (``D`` ``(B, n, n)``, ``merges`` ``(B,
    cap, 4)``, ``cand`` ``(B, 2)``, ``dmin`` and ``count`` ``(B,)``, ``sync``
    ``(B, 2)``, ...), and ``limit`` ``(B,)`` int64, the merges each lane
    makes: a lane whose ``count`` reached it only adds one to ``count``,
    which then counts the lockstep merges (records stay where they are).
    The batch kernel keeps its running minimum in shared memory, not in
    ``sync``: the engine's stages still reset the field, and no launch
    writes it."""

    D: torch.Tensor
    alive: torch.Tensor
    bits: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    cand: torch.Tensor
    dmin: torch.Tensor
    count: torch.Tensor
    rmin: torch.Tensor
    rarg: torch.Tensor
    sync: torch.Tensor
    limit: torch.Tensor


def merge_batch_buffers(D, alive, sizes, merges, cand, start: int, limit) -> MergeBatchBuffers:
    """Batch buffers around the lanes' ``D``, ``alive``, ``sizes`` and
    ``merges`` (kept, not copied), with each lane's candidate ``cand = (r,
    c, dmin)`` (``(B,)`` tensors), ``start`` lockstep merges made and the
    merge ``limit`` ``(B,)``; built by device launches alone."""
    B, n = alive.shape
    dev = D.device
    r, c, dmin = cand
    return MergeBatchBuffers(
        D=D, alive=alive, bits=alive_bits(alive), sizes=sizes, merges=merges,
        cand=torch.stack((r, c), dim=1).to(torch.int64),
        dmin=dmin.to(torch.float32).clone(),
        count=torch.full((B,), start, dtype=torch.int64, device=dev),
        rmin=torch.full((B, n), torch.inf, dtype=torch.float32, device=dev),
        rarg=torch.zeros((B, n), dtype=torch.int64, device=dev),
        sync=device_words((_KEY_INIT, 0), dev, lanes=B),
        limit=limit.to(torch.int64),
    )


#: Rows a cluster's block takes at the least (a bitmask word).
_MIN_BLOCK_ROWS = 32


class BatchPlan(NamedTuple):
    """How :func:`lw_merge_batch` lays a launch out: ``group`` threads scan
    a row; ``unroll`` float4 loads a thread at a time into registers, or 0
    where the Tensor Memory Accelerator copies whole rows into each warp's
    shared-memory buffers; ``threads`` make a block; and ``blocks`` blocks
    own a lane (one block, or a thread-block cluster when more than one)."""

    group: int
    unroll: int
    threads: int
    blocks: int

    def __str__(self) -> str:
        owner = "a block" if self.blocks == 1 else f"a cluster of {self.blocks}"
        rows = ("bulk copies" if self.unroll == 0
                else f"{self.unroll} float4 a thread in registers")
        return f"{owner} a lane, {self.group} threads a row, {rows}, {self.threads} a block"


@functools.cache
def merge_batch_plan(lanes: int, n: int, sms: int = 132, aligned: bool = True) -> BatchPlan:
    """The layout of a lockstep merge of ``lanes`` lanes of ``n`` slots on
    a card of ``sms`` multiprocessors (``aligned``: the matrices start on a
    16-byte boundary).  Rows of at least 128 slots that are 16-byte aligned
    (``n % 4 == 0``: every bucket) are bulk-copied into shared memory, in
    units of 4 KiB: a group of ``n / 32`` threads (4 at the least) scans a
    row, 32 scan a longer row in chunks of 1024 columns.  Shorter rows go
    into registers, 4 threads a row in one pass, and longer unaligned rows a
    warp a row.  A block has 256 threads (512 where rows go in chunks, 32 or
    128 for rows of 16 or 32 slots).  Up to ``n = 128`` a block owns a lane;
    above, a cluster of the fewest blocks (a power of two up to
    :data:`MAX_CLUSTER`, each at least a bitmask word of rows) whose warps
    give each of the card's schedulers one, ``lanes · blocks · warps >= 4 ·
    sms``: at 132 SMs, one 256-thread block a lane from 66 lanes on."""
    if lanes < 1 or n < 1:
        raise ValueError(f"a batch plan needs lanes and slots, got {lanes} and {n}")
    bulk = aligned and n % 4 == 0 and n >= 128
    if n <= 128 and not bulk:   # a block a lane, a row in one pass: 4 threads of n / 16 float4
        return (BatchPlan(4, 1, 32, 1) if n <= 16 else BatchPlan(4, 2, 128, 1) if n <= 32
                else BatchPlan(4, 4, 256, 1) if n <= 64 else BatchPlan(4, 8, 256, 1))
    if not bulk:
        group, unroll, threads = 32, 8, 256
    elif n > 1024:   # rows in chunks: 16 warps a block
        group, unroll, threads = 32, 0, 512
    else:
        group, unroll, threads = max(4, 1 << (-(-n // 32) - 1).bit_length()), 0, 256
    blocks = 1
    while (n > 128 and blocks < MAX_CLUSTER and lanes * blocks * threads < 128 * sms
           and 2 * blocks * _MIN_BLOCK_ROWS <= n):
        blocks *= 2
    return BatchPlan(group, unroll, threads, blocks)


def lw_merge_batch_plain(method: str, b: MergeBatchBuffers) -> MergeBatchBuffers:
    """The plain torch version of :func:`lw_merge_batch`, on any device, in
    place: each active lane (``count < limit``) as :func:`lw_merge_plain`,
    the others unchanged; every lane's ``count`` advanced.  Torch ops over
    the lane axis, nothing read back."""
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
    new = torch.where(keep, update_row(method, row_i, row_j, b.dmin[:, None], n_i[:, None],
                                       n_j[:, None], b.sizes), 0.0)
    b.D[lanes, :, i] = torch.where(act, new, col_i)
    b.D[lanes, i] = torch.where(act, new, row_i)
    live = b.alive & (ks != j[:, None])
    valid = live[:, :, None] & live[:, None, :] & (ks[:, None] != ks[None, :])
    rmin, rarg = torch.min(torch.where(valid, b.D, torch.inf), dim=2)   # first minimum
    new_size = n_i + n_j
    at = b.count.clamp_max(b.merges.shape[1] - 1)
    rec = torch.stack((i.to(torch.float32), j.to(torch.float32), b.dmin, new_size), dim=1)
    b.merges[lanes, at] = torch.where(act, rec, b.merges[lanes, at])
    b.count.add_(1)
    b.alive[lanes, j] = b.alive[lanes, j] & ~active
    b.bits.copy_(alive_bits(b.alive))
    b.sizes[lanes, j] = torch.where(active, 0.0, n_j)
    b.sizes[lanes, i] = torch.where(active, new_size, b.sizes[lanes, i])
    m, r_next = torch.min(rmin, dim=1)
    b.cand.copy_(torch.where(act, torch.stack((r_next, rarg[lanes, r_next]), dim=1), b.cand))
    b.dmin.copy_(torch.where(active, m, b.dmin))
    b.rmin.copy_(torch.where(act, rmin, b.rmin))
    b.rarg.copy_(torch.where(act, rarg, b.rarg))
    return b


def _check_batch_buffers(method: str, b: MergeBatchBuffers) -> tuple[int, int]:
    if b.D.ndim != 3 or b.D.shape[0] < 1:
        raise ValueError(f"lw_merge_batch needs a (B, n, n) stack, got {tuple(b.D.shape)}")
    B = b.D.shape[0]
    n = _check_square("lw_merge_batch", method, b.D[0])
    if b.merges.ndim != 3 or (b.merges.shape[0], b.merges.shape[2]) != (B, 4):
        raise ValueError(f"lw_merge_batch merges must be ({B}, cap, 4), got "
                         f"{tuple(b.merges.shape)}")
    _check_operands("lw_merge_batch", (
        (b.D, torch.float32, B * n * n), (b.alive, torch.bool, B * n),
        (b.bits, torch.int32, B * -(-n // 32)), (b.sizes, torch.float32, B * n),
        (b.merges, torch.float32, b.merges.numel()), (b.cand, torch.int64, 2 * B),
        (b.dmin, torch.float32, B), (b.count, torch.int64, B), (b.rmin, torch.float32, B * n),
        (b.rarg, torch.int64, B * n), (b.sync, torch.int64, 2 * B), (b.limit, torch.int64, B)))
    return B, n


def lw_merge_batch(method: str, b: MergeBatchBuffers) -> MergeBatchBuffers:
    """One lockstep merge of every lane, in place on ``b``: each lane whose
    ``count`` is below its ``limit`` makes the merge :func:`lw_merge` makes
    on its slices; the others only advance ``count``.

    One launch that reads nothing back and allocates nothing, so a run of
    lockstep merges can be captured as a CUDA graph (:class:`MergeGraph`,
    ``merge=lw_merge_batch``).  A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version.
    """
    B, n = _check_batch_buffers(method, b)
    if b.D.device.type == "cpu":
        return lw_merge_batch_plain(method, b)
    _build.check_cuda(b.D, torch.float32, *b[1:])
    index = b.D.device.index
    err = _batch_lib().lw_merge_batch(
        index, METHODS.index(method), b.D.data_ptr(), b.alive.data_ptr(), b.bits.data_ptr(),
        b.sizes.data_ptr(), b.merges.data_ptr(), b.merges.shape[1], b.cand.data_ptr(),
        b.dmin.data_ptr(), b.count.data_ptr(), b.rmin.data_ptr(), b.rarg.data_ptr(), n,
        b.limit.data_ptr(), B,
        *merge_batch_plan(B, n, sm_count(index), aligned=b.D.data_ptr() % 16 == 0),
        _build.raw_stream(index),
    )
    if err:
        raise RuntimeError(f"lw_merge_batch kernel launch failed: CUDA error {err}")
    lw_merge_batch.launches += 1
    return b


def _load_merge_batch(method: str, b: MergeBatchBuffers) -> None:
    B, n = _check_batch_buffers(method, b)
    kernel_resources(method, n, "lw_merge_batch", b.D.device, lanes=B,
                     aligned=b.D.data_ptr() % 16 == 0)


lw_merge_batch.launches = 0
lw_merge_batch.load = _load_merge_batch
lw_merge_batch.counters = (lw_merge_batch,)


class MergeGraph:
    """``k`` merges of ``merge`` on the buffers ``b``, captured once as a
    CUDA graph on a side stream; :meth:`replay` runs them on the current
    stream.  ``merge`` is a resident merge entry, :func:`lw_merge` (the
    default), :func:`repro_torch.kernels.lw_update.lazy_merge` or their
    batch forms on batch buffers (a replay then makes ``k`` lockstep merges
    of every lane): it
    carries ``load(method, b)``, which loads its kernels, and ``counters``,
    the wrappers whose ``launches`` a merge adds one to.

    The kernels are loaded before the capture (CUDA loads kernels lazily,
    and a first load must not fall inside one).  A failed capture raises.
    Its error mode is ``thread_local``: device work on another thread (a
    service's submitter or a second worker) does not fail it.
    The wrappers' Python runs only while the graph is captured, so the
    capture leaves their counts as it found them and each replay adds the
    ``k`` launches of each that it makes (and one to ``MergeGraph.replays``).
    ``MergeGraph.captures`` counts the graphs captured in this process.
    """

    replays = 0
    captures = 0

    def __init__(self, method: str, b, k: int, merge=None):
        merge = lw_merge if merge is None else merge
        merge.load(method, b)
        dev = b.D.device
        self.graph, self.merges, self.counters = torch.cuda.CUDAGraph(), k, merge.counters
        launches = [f.launches for f in self.counters]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                for _ in range(k):
                    merge(method, b)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        for f, count in zip(self.counters, launches):
            f.launches = count
        MergeGraph.captures += 1

    def replay(self) -> None:
        self.graph.replay()
        for f in self.counters:
            f.launches += self.merges
        MergeGraph.replays += 1
