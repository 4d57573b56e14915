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
stacked problems, each lane's first minimum, in one launch of each pass
(up to ``n = 1024`` a warp a row, then one reduction block a lane).  The
TPU package batches the same kernel through ``pallas_call``'s ``vmap``
rule.  Bound: bytes, ``Σ 4·L_b² + B·n`` over the lanes' live cells.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


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
    lib.masked_argmin_batch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_longlong,
                                        *[ctypes.c_void_p] * 5]
    for fn in (lib.masked_argmin, lib.masked_argmin_batch):
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



def masked_argmin_batch(D: torch.Tensor, alive: torch.Tensor):
    """Each lane's masked ``(min, flat argmin)`` of ``(B, n, n)`` float32
    ``D`` with ``(B, n)`` bool ``alive``, as ``(B,)`` tensors (float32,
    int64; the flat index ``r·n + c`` within the lane) on ``D``'s device.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    if D.ndim != 3 or D.shape[1] != D.shape[2] or D.shape[1] < 1:
        raise ValueError(f"masked_argmin_batch needs a (B, n, n) stack, got {tuple(D.shape)}")
    B, n = D.shape[0], D.shape[1]
    if alive.shape != (B, n) or alive.dtype != torch.bool:
        raise ValueError(f"alive must be ({B}, {n}) bool, got {tuple(alive.shape)} {alive.dtype}")
    if D.device.type == "cpu":
        return masked_argmin_batch_plain(D, alive)
    _build.check_cuda(D, torch.float32, alive)
    rmin = torch.empty((B, n), dtype=torch.float32, device=D.device)
    rarg = torch.empty((B, n), dtype=torch.int64, device=D.device)
    v = torch.empty(B, dtype=torch.float32, device=D.device)
    flat = torch.empty(B, dtype=torch.int64, device=D.device)
    err = _lib().masked_argmin_batch(D.device.index, D.data_ptr(), alive.data_ptr(), B, n,
                                     rmin.data_ptr(), rarg.data_ptr(), v.data_ptr(),
                                     flat.data_ptr(), _build.raw_stream(D.device.index))
    if err:
        raise RuntimeError(f"masked_argmin_batch kernel launch failed: CUDA error {err}")
    masked_argmin_batch.launches += 1
    return v, flat


masked_argmin_batch.launches = 0
