"""One row of squared Euclidean distances: the matrix-free chain's row build.

Replaces the Pallas TPU kernel :func:`repro.kernels.pairwise.row_sq_euclidean_pallas`
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
