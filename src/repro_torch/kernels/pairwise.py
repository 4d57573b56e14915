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

B5 has a second entry, the matrix-free chain's main path:
:func:`chain_trip` is one whole trip of the chain loop on
:class:`ChainBuffers`, in one launch that reads nothing back.  It builds
the tip's row, masks it, finds the nearest neighbor, and pushes it or
merges the top two summaries, with the merge record, the sizes, the
liveness and the counts kept on the device; :class:`TripGraph` captures a
chunk of trips as a CUDA graph and replays it.  Bound: bytes, the
summaries and one per-slot scalar read once, ``4·m·d + 4·m + m/8`` plus
O(d), at the L2 read rate (about 2 µs at (32768, 128)).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.linkage import METHODS
from repro_torch.kernels import _build


def row_sq_euclidean_plain(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel, on any device: ``((Y − x)²)``
    summed over ``d``, the square as one product (``** 2`` rounds the same
    and runs ~10× slower on the CPU)."""
    t = Y - x
    return (t * t).sum(-1)


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


class ChainBuffers(NamedTuple):
    """The matrix-free chain's state on the device, updated in place by
    each trip.

    ``W`` ``(n, d)`` and ``u`` ``(n,)`` float32, the geometric summaries;
    ``alive`` ``(n,)`` bool, and ``bits`` the same liveness as
    ``(⌈n/32⌉,)`` int32 words; ``sizes`` ``(n,)`` float32; ``chain``
    ``(n + 1,)`` int32, the chain stack; ``merges`` ``(n_steps, 4)``
    float32 rows ``(i, j, dist, new_size)`` in chain order; ``count``
    ``(4,)`` int32: the chain's length, the merges recorded, the trips
    made and the stop flag (a NaN row); ``sync`` ``(3,)`` int64, the
    kernel's running-minimum key, block ticket and value at the previous
    chain element.  ``n_steps`` merges end the run, as ``cap`` trips do.
    """

    W: torch.Tensor
    u: torch.Tensor
    alive: torch.Tensor
    bits: torch.Tensor
    sizes: torch.Tensor
    chain: torch.Tensor
    merges: torch.Tensor
    count: torch.Tensor
    sync: torch.Tensor
    n_steps: int
    cap: int


def chain_buffers(W, u, alive, sizes, n_steps: int) -> ChainBuffers:
    """Buffers around the summaries ``W``, ``u``, ``alive`` and ``sizes``
    (kept, not copied) for a run of ``n_steps`` merges, capped at ``4n +
    8`` trips; the chain holds the first live slot."""
    from repro_torch.kernels.lw_step import alive_bits

    n, dev = alive.shape[0], alive.device
    chain = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    chain[:1] = torch.argmax(alive.to(torch.uint8)).reshape(1)     # the first live slot
    return ChainBuffers(
        W=W, u=u, alive=alive, bits=alive_bits(alive), sizes=sizes, chain=chain,
        merges=torch.zeros((n_steps, 4), dtype=torch.float32, device=dev),
        count=torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=dev),
        sync=torch.tensor([-1, 0, 0], dtype=torch.int64, device=dev),     # key ~0: no minimum
        n_steps=n_steps, cap=4 * n + 8,
    )


def chain_trip_plain(method: str, b: ChainBuffers) -> ChainBuffers:
    """The plain torch version of :func:`chain_trip`, on any device, in
    place and without a read-back (one-element index tensors, no
    ``.item()``): the host loop's trip (``nnchain._chain_loop`` on the
    summary ops), every branch computed and kept where it applies.  A
    trip past the last merge, the cap or a stop changes nothing; a NaN row
    sets the stop flag; a merge that empties the chain pushes the first
    live slot."""
    from repro_torch.core.nnchain import summary_distance, summary_merge

    n = b.alive.shape[0]
    ks = torch.arange(n, device=b.W.device)
    length, n_merges, iters, stopped = b.count.clone().unbind()
    active = (n_merges < b.n_steps) & (iters < b.cap) & (stopped == 0)
    top = b.chain.index_select(0, (length - 1).clamp_min(0).reshape(1)).long()
    prev = b.chain.index_select(0, (length - 2).clamp_min(0).reshape(1)).long()
    row_raw = summary_distance(method, row_sq_euclidean_plain(b.W.index_select(0, top)[0], b.W),
                               b.u, b.u.index_select(0, top)[0], b.sizes,
                               b.sizes.index_select(0, top)[0])
    row = torch.where(b.alive & (ks != top), row_raw, torch.inf)
    m = row.min()
    c = torch.where(row == m, ks, n).min()                    # first index of the minimum
    prev_hit = (length >= 2) & (row.index_select(0, prev)[0] == m)
    c = torch.where(prev_hit, prev[0], c)                     # the previous element wins ties
    merge = active & (length >= 1) & prev_hit
    push = active & (length >= 1) & ~prev_hit & (c < n)
    stop = active & ~(merge | push)                           # a NaN row (or no tip)

    i = torch.minimum(top[0], c).reshape(1)
    j = torch.maximum(top[0], c).clamp_max(n - 1).reshape(1)
    ij = torch.cat((i, j))
    w, u, sizes = (t.index_select(0, ij) for t in (b.W, b.u, b.sizes))
    w_new, u_new = summary_merge(method, w[0], w[1], u[0], u[1], sizes[0], sizes[1])
    new_size = sizes.sum()

    rec = torch.stack((i[0].to(torch.float32), j[0].to(torch.float32), m, new_size))
    at = n_merges.clamp_max(b.merges.shape[0] - 1).long().reshape(1)
    b.merges.index_copy_(0, at, torch.where(merge, rec, b.merges.index_select(0, at)))
    b.W.index_copy_(0, i, torch.where(merge, w_new, w[:1]))
    b.u.index_copy_(0, i, torch.where(merge, u_new, u[:1]))
    zero = torch.zeros_like(new_size)
    b.sizes.index_copy_(0, ij, torch.where(merge, torch.stack((new_size, zero)), sizes))
    b.alive.index_copy_(0, j, b.alive.index_select(0, j) & ~merge)
    word = torch.div(j, 32, rounding_mode="floor")
    bits = b.bits.index_select(0, word).long() & ~((1 << (j % 32)) * merge)
    b.bits.index_copy_(0, word, torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32))
    slot = length.clamp(0, n).long().reshape(1)              # a push writes the next slot
    b.chain.index_copy_(0, slot,
                        torch.where(push, c.to(torch.int32), b.chain.index_select(0, slot)))
    new_length = torch.where(merge, length - 2, torch.where(push, length + 1, length))
    restart = merge & (new_length == 0)
    first = torch.argmax(b.alive.to(torch.uint8)).to(torch.int32)   # the first live slot
    b.chain[:1] = torch.where(restart, first, b.chain[:1])
    new_length = torch.where(restart, 1, new_length)
    b.count.copy_(torch.stack((new_length, n_merges + merge, iters + active, stopped | stop)))
    return b


@functools.cache
def _trip_lib():
    lib = _build.load("row_sq")
    lib.chain_trip.argtypes = [ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 9,
                               *[ctypes.c_longlong] * 4, ctypes.c_void_p]
    lib.chain_trip_load.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_longlong]
    for fn in (lib.chain_trip, lib.chain_trip_load):
        fn.restype = ctypes.c_int
    return lib


def _check_chain_buffers(method: str, b: ChainBuffers) -> tuple[int, int]:
    from repro_torch.core.nnchain import POINTS_METHODS

    if method not in POINTS_METHODS:
        raise ValueError(f"a chain trip takes the methods {POINTS_METHODS}, got {method!r}")
    if b.W.ndim != 2:
        raise ValueError(f"chain_trip needs summaries W (n, d), got {tuple(b.W.shape)}")
    n, d = b.W.shape
    specs = ((b.W, torch.float32, n * d), (b.u, torch.float32, n), (b.alive, torch.bool, n),
             (b.bits, torch.int32, -(-n // 32)), (b.sizes, torch.float32, n),
             (b.chain, torch.int32, n + 1), (b.merges, torch.float32, 4 * b.n_steps),
             (b.count, torch.int32, 4), (b.sync, torch.int64, 3))
    for t, dtype, numel in specs:
        if t.dtype != dtype or t.numel() != numel:
            raise ValueError(f"chain_trip operand: expected {numel} x {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    return n, d


def chain_trip(method: str, b: ChainBuffers) -> ChainBuffers:
    """One trip of the matrix-free chain, in place on ``b``: the tip's row,
    its nearest neighbor, and the push or the merge it leads to.

    One launch that reads nothing back and allocates nothing, so a run of
    trips can be captured as a CUDA graph (:class:`TripGraph`).  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version.
    """
    n, d = _check_chain_buffers(method, b)
    if b.W.device.type == "cpu":
        return chain_trip_plain(method, b)
    _build.check_cuda(b.W, torch.float32, *b[1:9])
    err = _trip_lib().chain_trip(
        b.W.device.index, METHODS.index(method), *(t.data_ptr() for t in b[:9]), n, d,
        b.n_steps, b.cap, _build.raw_stream(b.W.device.index),
    )
    if err:
        raise RuntimeError(f"chain_trip kernel launch failed: CUDA error {err}")
    chain_trip.launches += 1
    return b


chain_trip.launches = 0


class TripGraph:
    """``k`` trips of :func:`chain_trip` on the buffers ``b``, captured once
    as a CUDA graph on a side stream; :meth:`replay` runs them on the
    current stream.

    The kernel is loaded before the capture (CUDA loads kernels lazily, and
    a first load must not fall inside one).  A failed capture raises; its
    error mode is ``thread_local``, as :class:`~repro_torch.kernels.lw_step.MergeGraph`'s.
    The capture leaves ``chain_trip.launches`` as it found it; each replay
    adds the ``k`` launches it makes, and one to ``TripGraph.replays``.
    ``TripGraph.captures`` counts the graphs captured in this process.
    """

    replays = 0
    captures = 0

    def __init__(self, method: str, b: ChainBuffers, k: int):
        _, d = _check_chain_buffers(method, b)
        dev = b.W.device
        err = _trip_lib().chain_trip_load(dev.index, METHODS.index(method), b.W.data_ptr(), d)
        if err:
            raise RuntimeError(f"chain_trip kernel load failed: CUDA error {err}")
        self.graph, self.trips = torch.cuda.CUDAGraph(), k
        launches = chain_trip.launches
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                for _ in range(k):
                    chain_trip(method, b)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        chain_trip.launches = launches
        TripGraph.captures += 1

    def replay(self) -> None:
        self.graph.replay()
        chain_trip.launches += self.trips
        TripGraph.replays += 1


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
