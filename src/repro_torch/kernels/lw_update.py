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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.linkage import METHODS, update_row
from repro_torch.kernels import _build


def lw_update_plain(method, d_ki, d_kj, d_ij, n_i, n_j, sizes, keep):
    """The plain torch version of the kernel, on any device."""
    return torch.where(keep, update_row(method, d_ki, d_kj, d_ij, n_i, n_j, sizes), 0.0)


@functools.cache
def _kernel():
    fn = _build.load("lw_update").lw_update
    fn.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 7, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    err = _kernel()(
        d_ki.device.index, METHODS.index(method), d_ki.data_ptr(), d_kj.data_ptr(),
        sizes.data_ptr(), keep.data_ptr(), d_ij.data_ptr(), n_i.data_ptr(), n_j.data_ptr(),
        n, out.data_ptr(), _build.raw_stream(d_ki.device.index),
    )
    if err:
        raise RuntimeError(f"lw_update kernel launch failed: CUDA error {err}")
    lw_update.launches += 1
    return out


lw_update.launches = 0
