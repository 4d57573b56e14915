"""Squared Euclidean distances on the card: the full pair grid (B4) and
one row of it (B5).

**B4**, :func:`pairwise_sq_euclidean`, replaces the Pallas TPU kernel
:func:`repro.kernels.pairwise.pairwise_sq_euclidean_pallas` with the
hand-written CUDA kernel ``csrc/pairwise.cu``: ``(n, d) × (m, d) → (n, m)``
float32 in the TPU kernel's Gram form ``max(‖x‖² + ‖y‖² − 2·x·y, 0)``,
which keeps the labels of the JAX package's kernel route.  Bound:
operations, ``2·n·m·d`` at the card's 67 TFLOP/s outside the tensor cores
(2.94 ms at the landmark assignment's (124917, 6155, 128), against 0.94 ms
for its bytes at 3.35 TB/s).  A 64 × 64 output tile a block, 4 × 4 a
thread, ``d`` staged in chunks of 16, FFMA only (TF32 misses the 1e-4
tolerance); ragged edges masked, nothing padded.

**B5**, :func:`row_sq_euclidean`, replaces
:func:`repro.kernels.pairwise.row_sq_euclidean_pallas`
with the hand-written CUDA kernel ``csrc/row_sq.cu``.  The chain tip
``x`` ``(d,)`` against every summary ``Y`` ``(m, d)`` gives
``out[k] = Σ_c (Y[k, c] − x[c])²`` in float32, for any ``m`` and ``d``:
the kernel masks its own ragged edge, so nothing is padded.

The TPU kernel used the Gram form ``‖x‖² + ‖y‖² − 2·x·y`` to put the row
on the MXU.  One row is a matrix-vector product that no tensor core
helps, so the port takes the difference form, which reads the same bytes,
has no cancellation and is the arithmetic of the JAX package's jnp row.
Bound: bytes, ``4·(m·d + m + d)``.  At m = 32768, d = 128 those are
16.9 MB, which fit in the 50 MB L2: a chain that builds one row after
another reads them from L2, so the bound takes the L2 read rate, not the
HBM rate (3.35 TB/s, 5.0 µs).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def row_sq_euclidean_plain(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel, on any device."""
    return ((Y - x) ** 2).sum(-1)


@functools.cache
def _kernel():
    fn = _build.load("row_sq").row_sq_euclidean
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_sq_euclidean(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``(d,) × (m, d) → (m,)`` float32 squared distances: the ONE row-build
    dispatch of every matrix-free chain composition.

    A CUDA tensor launches the kernel (``x`` and ``Y`` float32, contiguous,
    on the current device); a CPU tensor takes the plain version.
    """
    if Y.ndim != 2 or x.shape != Y.shape[1:]:
        raise ValueError(f"row_sq_euclidean needs x (d,) and Y (m, d), got "
                         f"{tuple(x.shape)} and {tuple(Y.shape)}")
    if Y.device.type == "cpu":
        return row_sq_euclidean_plain(x, Y)
    _build.check_cuda(Y, torch.float32, x)
    if x.dtype != torch.float32:
        raise ValueError(f"expected {torch.float32}, got {x.dtype}")
    m, d = Y.shape
    out = torch.empty(m, dtype=torch.float32, device=Y.device)
    if m == 0:
        return out
    err = _kernel()(Y.device.index, x.data_ptr(), Y.data_ptr(), m, d, out.data_ptr(),
                    _build.raw_stream(Y.device.index))
    if err:
        raise RuntimeError(f"row_sq_euclidean kernel launch failed: CUDA error {err}")
    row_sq_euclidean.launches += 1
    return out


row_sq_euclidean.launches = 0


def pairwise_sq_euclidean_plain(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The plain torch version of B4, on any device: the Gram form with the
    product in full float32, clamped at 0 (the tiny negatives of
    cancellation); the diagonal of ``X`` against itself is not zeroed."""
    from repro_torch.core.distance import full_fp32_matmul

    xx = torch.sum(X * X, dim=-1)
    yy = torch.sum(Y * Y, dim=-1)
    with full_fp32_matmul():
        G = X @ Y.T
    return torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * G, 0.0)


@functools.cache
def _pairwise_kernel():
    fn = _build.load("pairwise").pairwise_sq_euclidean
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pairwise_sq_euclidean(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``(n, d) × (m, d) → (n, m)`` float32 squared distances in Gram form,
    clamped at 0.

    A CUDA tensor launches B4 (``X`` and ``Y`` float32, contiguous, on the
    current device); a CPU tensor takes the plain version.
    """
    if X.ndim != 2 or Y.ndim != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"pairwise_sq_euclidean needs X (n, d) and Y (m, d), got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    if X.device.type == "cpu":
        return pairwise_sq_euclidean_plain(X, Y)
    _build.check_cuda(X, torch.float32, Y)
    if Y.dtype != torch.float32:
        raise ValueError(f"expected {torch.float32}, got {Y.dtype}")
    (n, d), m = X.shape, Y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    if n == 0 or m == 0:
        return out
    err = _pairwise_kernel()(X.device.index, X.data_ptr(), Y.data_ptr(), n, m, d,
                             out.data_ptr(), _build.raw_stream(X.device.index))
    if err:
        raise RuntimeError(f"pairwise_sq_euclidean kernel launch failed: CUDA error {err}")
    pairwise_sq_euclidean.launches += 1
    return out


pairwise_sq_euclidean.launches = 0
