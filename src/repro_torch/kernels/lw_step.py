"""Fused one-pass Lance-Williams merge step.

Replaces the Pallas TPU kernel :func:`repro.kernels.lw_step.lw_step_pallas`
with the hand-written CUDA kernel ``csrc/lw_step.cu``.  For the merge of
slots ``i < j`` it evaluates the LW recurrence for the merged row, commits
it into row ``i`` and column ``i`` of ``D`` (row/column ``j`` stay as
garbage), and returns each row's ``(min, first-column argmin)`` of the
post-merge masked matrix, in which ``j`` is dead.

Unlike the TPU kernel, ``D`` is updated in place: each output cell depends
only on its own old value and on the two fetched rows, which are copies.
Bound: bytes.  The step needs the ``L × L`` live cells read once and row
and column ``i`` written, about ``4·L²`` bytes for ``L`` slots live after
the merge, at 3.35 TB/s.  The kernel gives each row its own block, skips
dead rows and stores only ``2n`` cells; it reads whole live rows, ``4·L·n``
bytes, so dead columns are its gap to the bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.linkage import METHODS, update_row
from repro_torch.kernels import _build


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
def _kernel():
    fn = _build.load("lw_step").lw_step
    fn.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 10, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lw_step(method, D, d_ki, d_kj, d_ij, n_i, n_j, sizes, alive, i, j):
    """One fused merge step; returns ``(D, rmin, rarg)`` with ``D`` updated
    in place.

    ``D``: ``(n, n)`` float32; ``d_ki``, ``d_kj``: ``(n,)`` copies of rows
    ``i`` and ``j``; ``sizes``: ``(n,)`` float32 and ``alive``: ``(n,)`` bool,
    both from before the merge; ``d_ij``, ``n_i``, ``n_j``: one-element
    float32 tensors; ``i < j``: one-element int64 tensors.  The scalars stay
    on the device, so the launch never waits for the card.  A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    n = D.shape[0]
    if D.ndim != 2 or D.shape[1] != n or n < 1:
        raise ValueError(f"lw_step needs a non-empty square matrix, got {tuple(D.shape)}")
    if D.device.type == "cpu":
        return lw_step_plain(method, D, d_ki, d_kj, d_ij, n_i, n_j, sizes, alive, i, j)
    for t, dtype, numel in ((d_ki, torch.float32, n), (d_kj, torch.float32, n),
                            (sizes, torch.float32, n), (alive, torch.bool, n),
                            (d_ij, torch.float32, 1), (n_i, torch.float32, 1),
                            (n_j, torch.float32, 1), (i, torch.int64, 1), (j, torch.int64, 1)):
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"lw_step operand: expected {numel} x {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    _build.check_cuda(D, torch.float32, d_ki, d_kj, sizes, alive, d_ij, n_i, n_j, i, j)
    rmin = torch.empty(n, dtype=torch.float32, device=D.device)
    rarg = torch.empty(n, dtype=torch.int64, device=D.device)
    err = _kernel()(
        D.device.index, METHODS.index(method), D.data_ptr(), d_ki.data_ptr(), d_kj.data_ptr(),
        sizes.data_ptr(), alive.data_ptr(), d_ij.data_ptr(), n_i.data_ptr(), n_j.data_ptr(),
        i.data_ptr(), j.data_ptr(), n, rmin.data_ptr(), rarg.data_ptr(),
        _build.raw_stream(D.device.index),
    )
    if err:
        raise RuntimeError(f"lw_step kernel launch failed: CUDA error {err}")
    lw_step.launches += 1
    return D, rmin, rarg


lw_step.launches = 0
