"""Masked (min, flat argmin) of a square matrix: the merge loop's seed.

Replaces the Pallas TPU kernel :func:`repro.kernels.minscan.masked_argmin_pallas`
with the hand-written CUDA kernel ``csrc/minscan.cu``.  Dead rows, dead
columns and the diagonal are excluded; ties go to the first minimum in
row-major order; a fully masked matrix gives ``(inf, 0)``.

Bound: bytes, one read of the ``L × L`` live cells, ``4·L²`` bytes, at
3.35 TB/s.  The kernel gives each row its own block (one coalesced read of
the whole row, dead rows skipped: ``4·L·n`` bytes) and reduces the row
results in a second one-block pass; both passes break ties on the index,
so block order does not matter.

:func:`masked_argmin_batch` is the kernel's batch-grid form, the seed of the
batched kernel engine (once a compaction stage of a shape bucket): ``B``
stacked problems, each lane's first minimum, in one launch of a body of its
own (``csrc/argmin_batch.cu``) laid out by :func:`argmin_batch_plan`.  A
warp owns a lane of up to 32 slots, a block or a thread-block cluster a
longer one; it reads only the lane's live rows over its live column span
(first to last live slot), through the Tensor Memory Accelerator's bulk
copies where rows are long, and reduces the rows' keys in shared memory
(a cluster's through block 0's): no second pass and no scratch.  A seed
finds each lane's live slots packed into a prefix, where that reads the
bound's bytes.  The TPU package batches the same kernel through
``pallas_call``'s ``vmap`` rule.  Bound: bytes, ``Σ 4·L_b² + B·n`` over the
lanes' live cells.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import INT_OUT, sm_count
from repro_torch.kernels.lw_step import merge_batch_plan

#: The most slots a lane of the batch kernel may have: its liveness bitmask
#: holds 128 words in shared memory, and its flat indices are 32-bit.
BATCH_MAX_N = 4096
#: The most slots of a lane that a warp owns whole.
WARP_LANE_MAX_N = 32


def masked_argmin_plain(D: torch.Tensor, alive: torch.Tensor):
    """The plain torch version of the kernel, on any device."""
    n = D.shape[0]
    ks = torch.arange(n, device=D.device)
    valid = alive[:, None] & alive[None, :] & (ks[:, None] != ks[None, :])
    v, flat = torch.min(torch.where(valid, D, torch.inf).reshape(-1), dim=0)  # first minimum
    return v, flat


def masked_argmin_batch_plain(D: torch.Tensor, alive: torch.Tensor):
    """The plain torch version of the batch kernel, on any device."""
    B, n = alive.shape
    ks = torch.arange(n, device=D.device)
    valid = alive[:, :, None] & alive[:, None, :] & (ks[:, None] != ks[None, :])
    return torch.min(torch.where(valid, D, torch.inf).reshape(B, -1), dim=1)  # first minimum


@functools.cache
def _lib():
    lib = _build.load("minscan")
    lib.masked_argmin.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, *[ctypes.c_void_p] * 5]
    lib.masked_argmin.restype = ctypes.c_int
    return lib


@functools.cache
def _batch_lib():
    lib = _build.load("argmin_batch")
    lib.masked_argmin_batch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_longlong,
                                        ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4,
                                        ctypes.c_void_p]
    lib.masked_argmin_batch_load.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                             *[ctypes.c_int] * 4, INT_OUT, INT_OUT, INT_OUT]
    for fn in (lib.masked_argmin_batch, lib.masked_argmin_batch_load):
        fn.restype = ctypes.c_int
    return lib


def masked_argmin(D: torch.Tensor, alive: torch.Tensor):
    """Masked ``(min, flat argmin)`` of square float32 ``D`` with ``(n,)``
    bool ``alive``, as 0-d tensors (float32, int64) on ``D``'s device.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    n = D.shape[0]
    if D.ndim != 2 or D.shape[1] != n or n < 1:
        raise ValueError(f"masked_argmin needs a non-empty square matrix, got {tuple(D.shape)}")
    if alive.shape != (n,) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be ({n},) bool, got {tuple(alive.shape)} {alive.dtype}")
    if D.device.type == "cpu":
        return masked_argmin_plain(D, alive)
    _build.check_cuda(D, torch.float32, alive)
    rmin = torch.empty(n, dtype=torch.float32, device=D.device)
    rarg = torch.empty(n, dtype=torch.int64, device=D.device)
    v = torch.empty((), dtype=torch.float32, device=D.device)
    flat = torch.empty((), dtype=torch.int64, device=D.device)
    err = _lib().masked_argmin(D.device.index, D.data_ptr(), alive.data_ptr(), n, rmin.data_ptr(), rarg.data_ptr(),
                    v.data_ptr(), flat.data_ptr(), _build.raw_stream(D.device.index))
    if err:
        raise RuntimeError(f"masked_argmin kernel launch failed: CUDA error {err}")
    masked_argmin.launches += 1
    return v, flat


masked_argmin.launches = 0



class ArgminPlan(NamedTuple):
    """How :func:`masked_argmin_batch` lays a launch out.  ``group`` 0: a
    warp owns a lane (rows of up to 32 slots), ``threads / 32`` lanes a
    block, ``unroll`` floats a load (4 where rows are 16-byte aligned, else
    1).  Otherwise as :class:`repro_torch.kernels.lw_step.BatchPlan`:
    ``group`` threads scan a live row; ``unroll`` float4 loads a thread at a
    time into registers, or 0 where the Tensor Memory Accelerator copies the
    rows' spans of 128 columns or more into each warp's shared-memory
    buffers (shorter spans go into registers); ``threads`` make a block; and
    ``blocks`` blocks own a lane (a thread-block cluster when more than
    one)."""

    group: int
    unroll: int
    threads: int
    blocks: int

    def __str__(self) -> str:
        if self.group == 0:
            return (f"a warp a lane, {self.threads // 32} lanes a block, "
                    f"{self.unroll} floats a load")
        owner = "a block" if self.blocks == 1 else f"a cluster of {self.blocks}"
        rows = ("bulk copies" if self.unroll == 0
                else f"{self.unroll} float4 a thread in registers")
        return f"{owner} a lane, {self.group} threads a row, {rows}, {self.threads} a block"


@functools.cache
def argmin_batch_plan(lanes: int, n: int, sms: int = 132, aligned: bool = True) -> ArgminPlan:
    """The layout of :func:`masked_argmin_batch` over ``lanes`` lanes of
    ``n`` slots on a card of ``sms`` multiprocessors (``aligned``: the
    matrices start on a 16-byte boundary).  Up to ``n = 32`` a warp owns a
    lane, four lanes a block, reading float4 where rows are 16-byte aligned
    (``n % 4 == 0``).  Longer rows follow B2's batch rule
    (:func:`~repro_torch.kernels.lw_step.merge_batch_plan`): a block owns a
    lane, or past ``n = 128`` a cluster of the fewest blocks (a power of two
    up to ``MAX_CLUSTER``) whose warps give each of the card's schedulers
    one; rows of at least 128 aligned slots are bulk-copied (a span shorter
    than 128 columns goes into registers in one pass), other rows go into
    registers.  Rows of 65 to 128 slots, and rows of up to 256 that a
    cluster owns or that are not aligned, go into registers in one pass of
    512 threads instead, ``n / 32`` threads a row: there a lane's chain of
    round trips, not its bytes, sets the time (chip_smoke.py
    ``--batch-kernel-times``' plan sweeps on an H100)."""
    if lanes < 1 or n < 1:
        raise ValueError(f"a batch plan needs lanes and slots, got {lanes} and {n}")
    if n <= WARP_LANE_MAX_N:
        return ArgminPlan(0, 4 if aligned and n % 4 == 0 else 1, 128, 1)
    plan = ArgminPlan(*merge_batch_plan(lanes, n, sms, aligned))
    if 64 < n <= 256 and (n <= 128 or plan.blocks > 1 or plan.unroll != 0):
        return ArgminPlan(4 if n <= 128 else 8, 8, 512, plan.blocks)
    return plan


def masked_argmin_batch(D: torch.Tensor, alive: torch.Tensor):
    """Each lane's masked ``(min, flat argmin)`` of ``(B, n, n)`` float32
    ``D`` with ``(B, n)`` bool ``alive``, as ``(B,)`` tensors (float32,
    int64; the flat index ``r·n + c`` within the lane) on ``D``'s device.

    A CUDA tensor launches the kernel (one launch a call, ``n`` up to
    :data:`BATCH_MAX_N`); a CPU tensor takes the plain version.
    """
    if D.ndim != 3 or D.shape[1] != D.shape[2] or D.shape[1] < 1:
        raise ValueError(f"masked_argmin_batch needs a (B, n, n) stack, got {tuple(D.shape)}")
    B, n = D.shape[0], D.shape[1]
    if alive.shape != (B, n) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be ({B}, {n}) bool, got {tuple(alive.shape)} {alive.dtype}")
    if D.device.type == "cpu":
        return masked_argmin_batch_plain(D, alive)
    if n > BATCH_MAX_N:
        raise ValueError(f"masked_argmin_batch takes lanes of up to {BATCH_MAX_N} slots on a "
                         f"CUDA device (a bitmask of 128 words, 32-bit indices), got {n}")
    _build.check_cuda(D, torch.float32, alive)
    v = torch.empty(B, dtype=torch.float32, device=D.device)
    flat = torch.empty(B, dtype=torch.int64, device=D.device)
    if B == 0:
        return v, flat
    index = D.device.index
    err = _batch_lib().masked_argmin_batch(
        index, D.data_ptr(), alive.data_ptr(), B, n, v.data_ptr(), flat.data_ptr(),
        *argmin_batch_plan(B, n, sm_count(index), aligned=D.data_ptr() % 16 == 0),
        _build.raw_stream(index))
    if err:
        raise RuntimeError(f"masked_argmin_batch kernel launch failed: CUDA error {err}")
    masked_argmin_batch.launches += 1
    return v, flat


masked_argmin_batch.launches = 0


def argmin_batch_resources(n: int, lanes: int = 1, device=None, aligned: bool = True) -> dict:
    """Load the kernel that :func:`masked_argmin_batch` launches over
    ``lanes`` lanes of ``n`` slots (on matrices that start on a 16-byte
    boundary where ``aligned``), on CUDA device ``device`` (default: the
    current one), and return its registers a thread, local (spilled) bytes
    a thread and the blocks an SM holds."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _batch_lib().masked_argmin_batch_load(
        index, n, *argmin_batch_plan(lanes, n, sm_count(index), aligned=aligned),
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"masked_argmin_batch kernel load failed: CUDA error {err}")
    return dict(regs=regs.value, local_bytes=local.value, blocks_per_sm=per_sm.value)
