"""Distributed Lance-Williams clustering, the paper's algorithm, over
``torch.distributed``.

Counterpart of :mod:`repro.core.distributed` for the row-sharded LW engine.
The ``(n, n)`` distance matrix is **block-row sharded** over the ranks of a
process group, the paper's processor ring: rank ``r`` of ``p`` holds rows
``[r·n/p, (r+1)·n/p)``, ``n`` padded to a multiple of ``p`` (padding slots
are born dead).  Per merge (:func:`repro_torch.core.engine.sharded_ops`):

  paper step 1    each rank's local first minimum                  O(n²/p)
  paper step 2-3  one ``all_gather`` of the p ``(min, row, col)`` triples
  paper step 4-5  every rank takes the same winner: no further
                  communication
  paper step 6a   rows ``i`` and ``j`` reach every rank through one
                  owner-contributes ``all_reduce``                  O(2n)
  paper step 6b   each rank applies the recurrence to its slice of column
                  ``i``; the owner rewrites row ``i``; row and column
                  ``j`` are tombstoned

A compaction boundary re-shards the live rows with one ``reduce_scatter``,
so a rank holds ``n²/p`` cells, then ``size²/p`` as the run goes on.  The
merges equal the serial backend's (:func:`repro_torch.core.lance_williams.lance_williams`)
bit for bit, for every method and variant.

The sharded **matrix-free NN chain** (:func:`distributed_nn_chain_from_points`)
takes the paper's storage argument past n²/p: the ``(n, d)`` points are
block-row sharded, the O(n) summary bookkeeping is replicated, and each
trip builds only the rank's slice of the chain tip's row, folded into the
rank's vote as it is built (kernel B5's vote entry on the card: one launch
a trip, the row never written), with three small collectives a trip:
O(n·d/p + n) a rank.  A segmented driver retries a segment after a
simulated shard loss and can shrink onto a smaller ring
(:mod:`repro_torch.checkpoint.elastic`).

The **two-phase approximate tier** (:func:`two_phase_from_points`) runs
in one process: the matrix-free chain on each contiguous block of points,
truncated; the host replays each block's merges into geometric summaries;
one more chain agglomerates the summaries.  On the card both phases run
kernel B5's resident chain trip.

The ring is :class:`Ring`, a small dataclass over a ``ProcessGroup`` with
this process's rank, the group's size and the rank's device, not a
``DeviceMesh``: one group and one device are all the engine uses.
:func:`require_ring_mesh` also takes a 1-D ``DeviceMesh`` and rejects a
multi-dimensional one, as the JAX package rejects a multi-axis mesh.

Ranks are launched as any ``torch.distributed`` program's are: each
process calls ``torch.distributed.init_process_group`` (NCCL with one GPU a
rank, gloo on the CPU) with an address, the world size and its rank, then
every rank calls these functions with the same arguments (SPMD).  With no
group up, :func:`make_cluster_mesh` brings up a world-size-1 group in the
process, so one card (NCCL) or the CPU (gloo) runs the same code with
p = 1.  The collectives are called by the names the installed torch has
(``all_gather_single`` and ``reduce_scatter_single`` where they exist,
else ``all_gather_into_tensor`` and ``reduce_scatter_tensor``).
"""

from __future__ import annotations

import math
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distance
from repro_torch.core.engine import (
    LWResult,
    ShardedLWResult,
    check_knobs,
    resolve_compaction,
    resolve_device,
    resolve_n_steps,
    run_sharded,
    symmetrize,
)
from repro_torch.core.nnchain import POINTS_METHODS, summary_merge
from repro_torch.distributed.fault import SimulatedFailure, StepDeadline
from repro_torch.distributed.sharding import shard_rows
from repro_torch.obs import NULL_TRACER, Tracer, get_registry
from repro_torch.roofline.cost import wire_bytes

#: ``kind`` of :func:`distributed_pairwise`.
PAIRWISE_KINDS = ("sqeuclidean", "euclidean", "cosine", "rmsd")


def _collective(name: str, old: str):
    return getattr(dist, name, None) or getattr(dist, old)


@dataclass(eq=False)
class Ring:
    """The paper's processor ring: a process group, this process's rank in
    it, its size ``p`` and the device this rank's tensors live on.  Its
    methods are the engine's collectives, each counted in
    :attr:`collectives`, and the bytes each puts on the wire from this rank
    added to :attr:`wire_bytes` under the reference's op name, by the ring
    model of :func:`repro_torch.roofline.cost.wire_bytes`."""

    group: Any
    rank: int
    size: int
    device: torch.device
    collectives: int = 0
    wire_bytes: dict = field(default_factory=dict)

    def _count(self, op: str, out: torch.Tensor) -> None:
        self.collectives += 1
        wire = wire_bytes(op, out.numel() * out.element_size(), self.size)
        self.wire_bytes[op] = self.wire_bytes.get(op, 0.0) + wire

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the first dimension, in rank
        order."""
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        _collective("all_gather_single", "all_gather_into_tensor")(out, t.contiguous(),
                                                                   group=self.group)
        self._count("all-gather", out)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        self._count("all-reduce", t)
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks and keep this rank's ``1/p`` of the first
        dimension."""
        out = torch.empty((t.shape[0] // self.size, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, t.contiguous(),
                                                                      group=self.group)
        self._count("reduce-scatter", out)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk ``q`` of ``t``'s first dimension (``p`` equal chunks) goes
        to rank ``q``; chunk ``q`` of the result came from rank ``q``."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        self._count("all-to-all", out)
        return out


def ring_of(group, device) -> Ring:
    """The ring of ``group`` on ``device``.  Its collectives must run on
    tensors of that device: a CUDA device needs an NCCL group, the CPU a
    gloo (or MPI) group, and a mismatch raises ``ValueError``; nothing
    moves to the CPU on its own."""
    dev = torch.device(device)
    backend = str(dist.get_backend(group))
    if dev.type == "cuda" and "nccl" not in backend:
        raise ValueError(f"a {backend} process group runs no collective on CUDA tensors: "
                         "bring up an NCCL group for a CUDA device, or pass device='cpu'")
    if dev.type != "cuda" and "gloo" not in backend and "mpi" not in backend:
        raise ValueError(f"a {backend} process group runs no collective on {dev.type} "
                         "tensors: bring up a gloo group for device='cpu'")
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Ring(group, dist.get_rank(group), dist.get_world_size(group), dev)


def sub_ring(ranks, device=None) -> Ring:
    """The ring over ``ranks`` of the default group, in ascending order, on
    ``device`` (CUDA unless the caller names another): a smaller ring for
    the matrix-free chain's elastic shrink.  Every rank of the world must
    call it (``dist.new_group``); a rank outside ``ranks`` gets a ring with
    rank -1 and the ring's size, which runs no collective."""
    ranks = sorted(int(r) for r in ranks)
    group = dist.new_group(ranks)
    dev = torch.device("cuda" if device is None else device)
    if dist.get_rank() in ranks:
        return ring_of(group, dev)
    return Ring(group, -1, len(ranks), resolve_device(dev))


def group_size() -> int:
    """World size of the default process group, 1 when none is up: the
    port's count of devices, where the JAX package reads
    ``jax.device_count()``."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_cluster_mesh(device=None) -> Ring:
    """The ring over every rank of the default process group, on ``device``
    (CUDA unless the caller names another, as
    :func:`repro_torch.core.engine.resolve_device` decides).  With no group
    up, brings up a world-size-1 group in this process on a
    ``HashStore``: NCCL for a CUDA device, gloo for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        resolve_device(dev)         # no GPU: raise before bringing anything up
        if dev.type == "cuda" and "TORCH_NCCL_TRACE_BUFFER_SIZE" not in os.environ:
            # a rank with no peer has no hang to record: the NCCL flight
            # recorder keeps each collective's Python stack, 90-180 us of host
            # a call on one rank (an H100 host, PERF.md), and a chain trip
            # makes three (TORCH_NCCL_TRACE_BUFFER_SIZE is its older name)
            os.environ.setdefault("TORCH_FR_BUFFER_SIZE", "0")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return ring_of(dist.group.WORLD, dev)


def flatten_mesh(mesh, device=None) -> Ring:
    """View a ``DeviceMesh`` of any shape as the paper's 1-D ring, its ranks
    in the mesh's row-major order, which must be ascending (a process
    group orders its ranks so).  Every rank of the world must call it."""
    if isinstance(mesh, Ring):
        return mesh
    ranks = mesh.mesh.flatten().tolist()
    if ranks != sorted(ranks):
        raise ValueError(f"the mesh's ranks {ranks} are not in ascending row-major order; "
                         "build the ring from a process group instead")
    group = (dist.group.WORLD if ranks == list(range(dist.get_world_size()))
             else dist.new_group(ranks))
    return ring_of(group, mesh.device_type if device is None else device)


def require_ring_mesh(mesh=None, device=None) -> Ring:
    """The ring every distributed engine runs on: ``None`` is
    :func:`make_cluster_mesh` on ``device``; a :class:`Ring` is taken as it
    is (``device``, if given, must be its device); a 1-D ``DeviceMesh``
    becomes the ring of its group.  A multi-dimensional mesh is rejected
    with instructions rather than silently flattened: the collectives run
    on one ring, and guessing a flattening order behind the caller's back
    reorders the ranks' rows."""
    if mesh is None:
        return make_cluster_mesh(device)
    if isinstance(mesh, Ring):
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device={device!r} contradicts the ring's device {mesh.device}")
        return mesh
    if mesh.ndim != 1:
        raise ValueError(
            f"the distributed clustering engines run on a 1-D mesh (the "
            f"paper's processor ring), got a {mesh.ndim}-axis mesh with axes "
            f"{tuple(mesh.mesh_dim_names or ())} of shape {tuple(mesh.mesh.shape)} — "
            "choose the device order explicitly with "
            "repro_torch.core.distributed.flatten_mesh(mesh) or build one with "
            "make_cluster_mesh(device)"
        )
    return ring_of(mesh.get_group(), mesh.device_type if device is None else device)


def pad_to_mesh(n: int, p: int, *, block: int = 1) -> int:
    """Smallest padded size ≥ ``n`` divisible by ``p · block``: every rank
    owns the same number of rows, and a tiled row build needs each rank's
    rows to be a multiple of its ``block``.  Padding slots are born dead."""
    if p < 1:
        raise ValueError(f"mesh must have at least one device, got p={p}")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    q = p * block
    return max(math.ceil(n / q), 1) * q


def _pad_matrix(D: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = D.shape[0]
    if n_pad == n:
        return D
    out = D.new_zeros((n_pad, n_pad))
    out[:n, :n] = D
    return out


class ShardedMatrix(NamedTuple):
    """A distance matrix born sharded (:func:`distributed_pairwise`): this
    rank's ``(n_pad / p, n_pad)`` block of rows of the padded, symmetric
    matrix with a zero diagonal (what :func:`~repro_torch.core.engine.symmetrize`
    makes of the whole), the real size ``n`` and the ring it lives on.
    :func:`distributed_lance_williams` takes it as it is."""

    block: torch.Tensor
    n: int
    n_pad: int
    mesh: Ring

    def gather(self) -> torch.Tensor:
        """The whole ``(n, n)`` matrix on every rank (one ``all_gather``)."""
        return self.mesh.all_gather(self.block)[: self.n, : self.n]


def distributed_lance_williams(
    D,
    method: str = "complete",
    mesh=None,
    variant: str = "baseline",
    *,
    stop_at_k: int = 1,
    distance_threshold: float | None = None,
    compaction: bool | str = "auto",
) -> ShardedLWResult:
    """Cluster an ``(n, n)`` distance matrix across every rank of ``mesh``
    (:func:`require_ring_mesh`; the default ring when ``None``).

    SPMD: every rank calls it with the same arguments.  ``D`` is the whole
    matrix (or its upper triangle), of which each rank keeps its block of
    rows after :func:`~repro_torch.core.engine.symmetrize` and padding, or
    a :class:`ShardedMatrix`, whose block is used as it is (copied: the
    caller's block is not modified).  The knobs are the serial backend's;
    ``compaction`` stages the run on the plan of the padded size with stage
    sizes multiples of ``p``, each boundary re-sharding the live rows.
    Returns the replicated merge record on every rank, with this rank's
    block shapes (:class:`~repro_torch.core.engine.ShardedLWResult`).
    """
    check_knobs(method, variant)
    ring = require_ring_mesh(mesh)
    p = ring.size
    if isinstance(D, ShardedMatrix):
        if D.mesh.size != p or D.block.shape != (D.n_pad // p, D.n_pad):
            raise ValueError(f"a block of shape {tuple(D.block.shape)} of an n_pad={D.n_pad} "
                             f"matrix is not a row block of a ring of {p}")
        n, n_pad = D.n, D.n_pad
        block = D.block.to(device=ring.device, dtype=torch.float32, copy=True)
    else:
        sym = symmetrize(torch.as_tensor(D, dtype=torch.float32, device=ring.device))
        n = sym.shape[0]
        n_pad = pad_to_mesh(n, p)
        block = shard_rows(_pad_matrix(sym, n_pad), ring)
        del sym
        if p > 1:
            block = block.clone()   # drop the rest of the matrix
    n_steps = resolve_n_steps(n, stop_at_k)
    return run_sharded(
        block, torch.arange(n_pad, device=ring.device) < n, method=method, n_steps=n_steps,
        ring=ring, variant=variant, distance_threshold=distance_threshold,
        compaction=resolve_compaction(compaction, n_pad, n_steps, align=p),
    )


def distributed_pairwise(X, kind: str = "sqeuclidean", mesh=None) -> ShardedMatrix:
    """Build the distance matrix of ``X`` born sharded, row block by row
    block: the paper's parallel distance phase (its RMSD build for protein
    conformations with ``kind="rmsd"``).

    ``X`` is ``(n, d)`` points (``(n, atoms, 3)`` conformations for
    ``rmsd``), padded with zeros to a multiple of ``p``.  Each rank keeps
    its ``(n_pad / p, …)`` slice, all-gathers the point set once, and builds
    its row block with the single-device builders of
    :mod:`repro_torch.core.distance`; one ``all_to_all`` of the block's
    column chunks then averages it with its transpose and the diagonal is
    zeroed, as :func:`~repro_torch.core.engine.symmetrize` does to a whole
    matrix.  Returns a :class:`ShardedMatrix`.
    """
    if kind not in PAIRWISE_KINDS:
        raise ValueError(f"unknown distance kind {kind!r}; pick from {PAIRWISE_KINDS}")
    ring = require_ring_mesh(mesh)
    p = ring.size
    X = torch.as_tensor(X, dtype=torch.float32, device=ring.device)
    if kind == "rmsd" and (X.ndim != 3 or X.shape[-1] != 3):
        raise ValueError(f"rmsd expects (n, atoms, 3) conformations, got {tuple(X.shape)}")
    if kind != "rmsd" and X.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {tuple(X.shape)}")
    n = X.shape[0]
    n_pad = pad_to_mesh(n, p)
    rows = n_pad // p
    if n_pad != n:
        X = torch.cat((X, X.new_zeros((n_pad - n, *X.shape[1:]))))
    mine = shard_rows(X, ring)
    everyone = ring.all_gather(mine)
    if kind == "sqeuclidean":
        block = distance.pairwise_sq_euclidean(mine, everyone)
    elif kind == "euclidean":
        block = distance.pairwise_euclidean(mine, everyone)
    elif kind == "cosine":
        block = distance.pairwise_cosine(mine, everyone)
    else:
        block = distance.pairwise_rmsd_cross(mine, everyone)
    # chunk q of the block's columns is D[mine, q's rows]: rank q gets it,
    # and what comes back stacks into D[:, mine], whose transpose is D.T's rows
    chunks = block.reshape(rows, p, rows).transpose(0, 1).reshape(n_pad, rows)
    transposed = ring.all_to_all(chunks).T
    block = 0.5 * (block + transposed)
    block.diagonal(ring.rank * rows).fill_(0.0)
    return ShardedMatrix(block, n, n_pad, ring)


# ---------------------------------------------------------------------------
# the sharded matrix-free NN chain: O(n·d/p + n) a rank
# ---------------------------------------------------------------------------


class DistributedChainResult(NamedTuple):
    """The sharded chain's merges and the segmented driver's telemetry.

    ``merges`` ``(n − 1, 4)`` rows ``(i, j, dist, new_size)`` in chain order
    (the first ``n_merges`` are the run's), replicated on every rank;
    ``restarts``, ``stragglers`` and ``segments`` count the driver's
    same-segment retries, the segments past the deadline and the segments
    dispatched (the same counts land on the metrics registry); ``iters``
    the chain trips made.  ``dropped`` marks a rank outside the fallback
    ring of an elastic shrink: it stopped at the shrink, and its merges are
    the ``n_merges`` committed before it.
    """

    merges: torch.Tensor
    n_merges: int
    restarts: int = 0
    stragglers: int = 0
    segments: int = 0
    iters: int = 0
    dropped: bool = False


@dataclass(eq=False)
class _ChainState:
    """One rank's sharded chain, updated in place: its block ``W`` of the
    summary points and, replicated, the scatter terms ``u``, ``alive``,
    ``sizes`` and the merge record (heights and sizes) on the device; the
    chain stack, the merged slots, a host mirror of ``alive`` and the trip
    count on the host.  Each trip's decision comes from collectives, so
    every rank holds the same of all but ``W`` (and the vote)."""

    W: torch.Tensor
    u: torch.Tensor
    alive: torch.Tensor
    sizes: torch.Tensor
    merges: torch.Tensor
    live: np.ndarray
    chain: list
    pairs: list
    vote: Any                       # pairwise.VoteBuffers: the vote's send buffer and scratch
    iters: int = 0
    stopped: bool = False           # a NaN row: no candidate

    def result(self, **telemetry) -> DistributedChainResult:
        if self.pairs:
            self.merges[: len(self.pairs), :2] = torch.tensor(
                self.pairs, dtype=torch.float32, device=self.merges.device)
        return DistributedChainResult(merges=self.merges, n_merges=len(self.pairs),
                                      iters=self.iters, **telemetry)


def _chain_state(X: torch.Tensor, ring: Ring) -> _ChainState:
    """The first state of a sharded chain of the ``(n, d)`` points ``X`` on
    ``ring``: ``X`` padded to :func:`pad_to_mesh` (padding slots born dead,
    of size 0), this rank's block of rows copied to its device, every slot
    a leaf."""
    from repro_torch.kernels.pairwise import vote_buffers

    n, d = X.shape
    n_pad = pad_to_mesh(n, ring.size)
    if n_pad != n:
        X = torch.cat((X, X.new_zeros((n_pad - n, d))))
    dev = ring.device
    alive = torch.arange(n_pad, device=dev) < n
    return _ChainState(W=shard_rows(X, ring).clone(), u=torch.zeros(n_pad, device=dev),
                       alive=alive, sizes=alive.to(torch.float32),
                       merges=torch.zeros((n - 1, 4), dtype=torch.float32, device=dev),
                       live=np.arange(n_pad) < n, chain=[], pairs=[],
                       vote=vote_buffers(dev))


def _owner_row(ring: Ring, W: torch.Tensor, slot: int) -> torch.Tensor:
    """Summary ``slot`` on every rank: its owner contributes the row, every
    other rank zeros, and one ``all_reduce`` sums them (``x + 0`` is exact,
    so the row arrives bit for bit).  O(d)."""
    rows = W.shape[0]
    local = slot - ring.rank * rows
    row = W[local].clone() if 0 <= local < rows else W.new_zeros(W.shape[1])
    return ring.all_reduce(row)


def _chain_trip(method: str, s: _ChainState, ring: Ring) -> None:
    """One trip of the chain over ``ring``, exactly three collectives: the
    tip's summary by an owner-contributes ``all_reduce`` (O(d)); one
    ``all_gather`` of each rank's ``(local min, first local argmin, masked
    value at prev)`` as float32 (the slot is exact below 2²⁴), read back:
    the trip's one wait for the device; the elected candidate's summary by
    another owner-contributes ``all_reduce``, made on a push as on a merge.
    The rank's vote is :func:`~repro_torch.kernels.pairwise.chain_vote`
    (B5's vote entry on a CUDA tensor, one launch into the state's send
    buffer; its plain twin on the CPU): the rank's slice of the tip's row,
    the summary distance, masked as the serial loop masks it, the first
    minimum and prev's value.  Every rank elects on the host from the same
    values: the global minimum, the first rank attaining it and its first
    local slot; the previous chain element wins a tie, and a NaN minimum
    stops the chain.  Scalars go to the device by ``fill_``, which copies
    nothing from the host."""
    from repro_torch.kernels.pairwise import chain_vote

    W = s.W
    rows = W.shape[0]
    offset = ring.rank * rows
    n_pad = s.alive.shape[0]
    if not s.chain:
        s.chain.append(int(np.argmax(s.live)))             # first live slot
    top = s.chain[-1]
    prev = s.chain[-2] if len(s.chain) >= 2 else None
    w_top = _owner_row(ring, W, top)                        # collective 1
    vote = chain_vote(method, w_top, W, s.u, s.sizes, s.alive, top, prev, offset, s.vote)
    # collective 2: every rank's (min, first argmin, prev's value), read back
    votes = ring.all_gather(vote)
    v = votes.tolist()
    mins = v[0::3]
    if any(x != x for x in mins):                          # a NaN row: no candidate
        win, c = None, n_pad
    else:
        m = min(mins)
        win = mins.index(m)                                # the first rank with the least
        c = int(v[3 * win + 1]) + win * rows
        if prev is not None and min(v[2::3]) == m:         # the previous element wins ties
            c = prev
    w_c = _owner_row(ring, W, c)                           # collective 3, on a push too
    s.iters += 1
    if win is None:
        s.stopped = True
    elif c == prev:                                        # mutual nearest neighbors
        i, j = min(top, c), max(top, c)
        w_i, w_j = (w_top, w_c) if top < c else (w_c, w_top)
        n_i, n_j = s.sizes[i], s.sizes[j]
        new_size = n_i + n_j
        w_new, u_new = summary_merge(method, w_i, w_j, s.u[i], s.u[j], n_i, n_j)
        if offset <= i < offset + rows:
            W[i - offset] = w_new
        s.u[i] = u_new
        s.merges[len(s.pairs), 2:] = torch.stack((votes[3 * win], new_size))
        s.sizes[i] = new_size
        s.sizes[j].fill_(0.0)
        s.alive[j].fill_(False)
        s.live[j] = False
        s.pairs.append((i, j))
        del s.chain[-2:]
    else:
        s.chain.append(c)


def _run_sharded_chain(method: str, s: _ChainState, ring: Ring, target: int) -> int:
    """The trips of one segment: until ``target`` merges are committed, the
    trip cap of ``4·n_pad + 8`` is reached or a NaN row stops the chain.
    Returns the merges committed."""
    cap = 4 * s.alive.shape[0] + 8
    while len(s.pairs) < target and s.iters < cap and not s.stopped:
        _chain_trip(method, s, ring)
    return len(s.pairs)


def _fault_event(log, msg: str) -> None:
    if log is not None:
        log(msg)
    else:
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


#: Logical → ring axis mapping of the sharded chain state: only the summary
#: rows are sharded, over the paper's ring axis; the rest is replicated.
_CHAIN_ROW_RULES = {"rows": ("p",)}


def _chain_state_specs(n_pad: int, d: int, n: int) -> tuple:
    """The sharded chain state as :class:`~repro_torch.checkpoint.elastic.ParamSpec`
    leaves, in the reference's state order."""
    from repro_torch.checkpoint.elastic import ParamSpec

    rep = ParamSpec((n_pad,), (None,))
    scalar = ParamSpec((), ())
    return (
        ParamSpec((n_pad, d), ("rows", None)),          # W
        rep,                                            # u
        rep,                                            # alive
        rep,                                            # sizes
        rep,                                            # chain
        scalar,                                         # chain_len
        ParamSpec((n - 1, 4), (None, None)),            # merges
        scalar,                                         # n_merges
        scalar,                                         # iters
    )


def _shrink_chain_state(s: _ChainState, ring: Ring, fallback: Ring, *, n_pad: int, d: int,
                        n: int, cause, log) -> None:
    """Validate the fallback ring, then move the summary rows onto it.

    The validation runs before any state moves
    (:func:`~repro_torch.checkpoint.elastic.validate_mesh_for_tree`), so an
    incompatible fallback fails with the offending leaves and axes named
    and the state still whole on the old ring.  Then one ``all_gather`` on
    the old ring (the failure is simulated: every rank is still up) and
    each fallback rank keeps its block; a rank outside the fallback keeps
    none (``s.W`` becomes ``None``)."""
    from repro_torch.checkpoint.elastic import reshard_rows, validate_mesh_for_tree

    problems = validate_mesh_for_tree(_chain_state_specs(n_pad, d, n), _CHAIN_ROW_RULES,
                                      fallback)
    if problems:
        raise RuntimeError(
            f"restart budget exhausted on the p={ring.size} ring, and the fallback ring "
            f"(p={fallback.size}) cannot hold the sharded chain state:"
            "\n  " + "\n  ".join(problems) + "\n"
            "the last consistent state is still on the original ring — pick a fallback "
            "whose size divides the padded row count"
        ) from cause
    _fault_event(
        log,
        f"[fault] restart budget exhausted on p={ring.size} — resharding the chain state "
        f"onto the p={fallback.size} fallback ring and continuing (same segment, fresh "
        "budget; no merges lost)",
    )
    s.W = reshard_rows(s.W, ring, fallback)


def distributed_nn_chain_from_points(
    X,
    method: str = "ward",
    mesh=None,
    *,
    segment_steps: int | None = None,
    failure_plan=None,
    max_restarts: int = 2,
    fallback_mesh=None,
    deadline: StepDeadline | None = None,
    log=None,
    tracer: Tracer | None = None,
) -> DistributedChainResult:
    """Sharded matrix-free agglomeration of ``(n, d)`` points across every
    rank of ``mesh`` (:func:`require_ring_mesh`; the default ring when
    ``None``): the exact serial NN chain with **O(n·d/p + n)** memory a
    rank.

    SPMD: every rank calls it with the same arguments.  The points are
    padded (:func:`pad_to_mesh`; padding slots are born dead) and each rank
    keeps its block of rows; ``u``, ``alive``, ``sizes`` and the merge
    record are replicated, and the chain stack lives on the host.  Each
    trip makes three collectives and one read-back
    (:func:`_chain_trip`).  Merges come back in chain order on every rank,
    equal bit for bit to the serial host-driven points chain with the same
    row build (:func:`repro_torch.core.nnchain._chain_loop` over
    ``_points_nnchain_ops``; on the card B5's row entry, whose sum the vote
    entry shares); canonicalize with
    :func:`repro_torch.core.dendrogram.canonical_order` before cutting
    (``cluster(algorithm="nnchain", backend="distributed")`` does).  The
    reference's TPU knobs (``use_pallas``, ``block_n``, ``interpret``) are
    not taken: B5 masks its own ragged edge.

    **Fault tolerance** (:mod:`repro_torch.distributed.fault`): with
    ``segment_steps`` the run goes in segments of that many merges;
    ``failure_plan.check(segment)`` injects a shard loss before a segment,
    and recovery retries the same segment from the committed state (no
    merge is lost), at most ``max_restarts`` times running, then raises a
    ``RuntimeError``.  A :class:`~repro_torch.distributed.fault.StepDeadline`
    flags segments that straggle.  Events go to ``log``, else to a
    ``RuntimeWarning``.

    **Elastic shrink**: with a ``fallback_mesh`` (a ring over the first
    ``p'`` ranks, which every rank builds beforehand, e.g. with
    :func:`sub_ring`), exhausting the restart budget validates the state
    against the fallback (a ``RuntimeError`` naming the offending leaves
    and axes, before any state moves), moves the summary rows onto it and
    retries the same segment there with a fresh budget; one shrink a run.
    The ranks outside the fallback make no further collective: they return
    the merges committed before the shrink, marked ``dropped`` (the JAX
    package has no ranks to drop: its mesh just gets smaller).

    **Telemetry**: the result carries ``restarts``, ``stragglers`` and
    ``segments``; the registry (:func:`repro_torch.obs.get_registry`)
    counts ``distributed_chain_segments_total``, ``..._restarts_total``,
    ``..._straggler_segments_total`` and ``..._shrinks_total``; with a
    ``tracer`` each segment dispatch is a ``chain_segment`` span (a failed
    one with ``error="shard-lost"``).
    """
    if method not in POINTS_METHODS:
        raise ValueError(
            f"the sharded matrix-free chain supports {POINTS_METHODS} "
            f"(their LW distance is a geometric-summary function), got "
            f"{method!r} — use the dense distributed LW engine instead"
        )
    X = torch.as_tensor(X, dtype=torch.float32)
    if X.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {tuple(X.shape)}")
    ring = require_ring_mesh(mesh)
    n, d = X.shape
    if n < 2:
        return DistributedChainResult(
            merges=torch.zeros((0, 4), dtype=torch.float32, device=ring.device), n_merges=0)
    fallback = None if fallback_mesh is None else require_ring_mesh(fallback_mesh, ring.device)
    s = _chain_state(X, ring)
    n_pad = s.alive.shape[0]

    n_steps = n - 1
    seg = n_steps if segment_steps is None else max(1, int(segment_steps))
    tracer = tracer or NULL_TRACER
    reg = get_registry()
    seg_counter = reg.counter("distributed_chain_segments_total", "Segment dispatches")
    restart_counter = reg.counter("distributed_chain_restarts_total",
                                  "Shard-loss same-segment retries")
    straggler_counter = reg.counter("distributed_chain_straggler_segments_total",
                                    "Segments past the straggler deadline")
    shrink_counter = reg.counter("distributed_chain_shrinks_total",
                                 "Elastic reshard-to-fallback-mesh events")
    done, seg_idx, restarts, stragglers = 0, 0, 0, 0
    while done < n_steps:
        target = min(done + seg, n_steps)
        t0 = time.perf_counter()
        try:
            if failure_plan is not None:
                failure_plan.check(seg_idx)
            made = _run_sharded_chain(method, s, ring, target)
        except SimulatedFailure as e:
            restarts += 1
            restart_counter.inc()
            tracer.add_span("chain_segment", t0, time.perf_counter(), cat="distributed",
                            segment=seg_idx, error="shard-lost", restarts=restarts)
            if restarts > max_restarts:
                if fallback is None:
                    raise RuntimeError(
                        f"distributed NN-chain lost a shard at segment {seg_idx} and "
                        f"exceeded max_restarts={max_restarts} (committed {done}/{n_steps} "
                        f"merges, p={ring.size}, n={n}); the last consistent sharded state "
                        "is still on the ring — re-dispatch with a fresh failure budget to "
                        "continue, or pass fallback_mesh= to shrink elastically"
                    ) from e
                # elastic shrink: validate, then move the rows; the same
                # segment is retried on the smaller ring with a fresh budget
                _shrink_chain_state(s, ring, fallback, n_pad=n_pad, d=d, n=n, cause=e,
                                    log=log)
                shrink_counter.inc()
                if s.W is None:
                    _fault_event(log, f"[fault] rank {ring.rank} is outside the "
                                      f"p={fallback.size} fallback ring: it stops with the "
                                      f"{done} merges committed before the shrink")
                    return s.result(restarts=restarts, stragglers=stragglers,
                                    segments=seg_idx, dropped=True)
                ring, fallback, restarts = fallback, None, 0     # one shrink a run
                continue
            _fault_event(
                log,
                f"[fault] {e} — retrying segment {seg_idx} ({restarts}/{max_restarts}); "
                "the sharded state is the checkpoint, no merges lost",
            )
            continue
        t1 = time.perf_counter()
        dt = t1 - t0
        seg_counter.inc()
        tracer.add_span("chain_segment", t0, t1, cat="distributed", segment=seg_idx,
                        merges_done=made, target=target)
        if deadline is not None and deadline.observe(dt):
            stragglers += 1
            straggler_counter.inc()
            _fault_event(
                log,
                f"[fault] segment {seg_idx} straggled ({dt:.3f}s > {deadline.factor}x "
                "median) — delayed shard flagged; run continues",
            )
        seg_idx += 1
        done = made
        if made < target:               # the trip cap or a NaN row inside the segment
            break
    if done != n_steps:
        raise RuntimeError(
            "sharded NN-chain hit its iteration cap (or a NaN row) before finishing — "
            "the input likely contains NaNs (the chain invariant needs a total order on "
            f"distances); committed {done}/{n_steps} merges"
        )
    return s.result(restarts=restarts, stragglers=stragglers, segments=seg_idx)


# ---------------------------------------------------------------------------
# the two-phase approximate tier (Variance-based Distributed Clustering)
# ---------------------------------------------------------------------------


def _replay_summaries(X: np.ndarray, merges: np.ndarray, method: str):
    """Replay a merge prefix through the geometric-summary recursions.

    The JAX package's host mirror of ``summary_merge``, verbatim: numpy
    float32 on the host, so that the summaries phase 2 starts from are the
    reference's bit for bit (the order of numpy's scalar-times-array and
    its pairwise ``sum`` is kept).  Walking the phase-1 merge prefix
    rebuilds exactly the ``(w, u, size)`` state each surviving cluster
    would carry, WPGMA's tree-dependent midpoints included.  Returns
    ``(W, u, sizes, alive)`` over the shard's slots.
    """
    m = X.shape[0]
    W = np.array(X, np.float32, copy=True)
    u = np.zeros(m, np.float32)
    sizes = np.ones(m, np.float32)
    alive = np.ones(m, bool)
    for row in np.asarray(merges):
        i, j = int(round(row[0])), int(round(row[1]))
        n_i, n_j = sizes[i], sizes[j]
        tot = n_i + n_j
        gap = np.float32(((W[i] - W[j]) ** 2).sum())
        if method == "weighted":
            w_new = np.float32(0.5) * (W[i] + W[j])
            u_new = np.float32(0.5) * (u[i] + u[j]) + np.float32(0.25) * gap
        elif method == "average":
            w_new = (n_i * W[i] + n_j * W[j]) / tot
            u_new = (n_i * u[i] + n_j * u[j]) / tot \
                + (n_i * n_j) / (tot * tot) * gap
        else:                                   # ward
            w_new = (n_i * W[i] + n_j * W[j]) / tot
            u_new = np.float32(0.0)
        W[i], u[i], sizes[i], alive[j] = w_new, u_new, tot, False
    return W, u, sizes, alive


def two_phase_from_points(
    X,
    method: str = "ward",
    *,
    shards: int | None = None,
    intermediate_k: int | None = None,
    device=None,
) -> LWResult:
    """Approximate two-phase agglomeration (arXiv 1703.09823's scheme):
    cluster each shard's block locally, agglomerate summaries globally, on
    ``device`` (CUDA unless told otherwise).

    Phase 1 runs the matrix-free chain
    (:func:`repro_torch.core.nnchain.nn_chain_from_points`, B5's resident
    trip on the card) on each of ``shards`` contiguous blocks (default: the
    default process group's world size, 1 with no group) and truncates its
    canonical merge list at ``intermediate_k`` clusters (default
    ``round(√(block size))``); phase 2 replays those prefixes into
    geometric summaries on the host (:func:`_replay_summaries`) and
    agglomerates the surviving ``Σ intermediate_k`` summaries with
    :func:`repro_torch.core.nnchain.nn_chain_from_summaries` (the same
    trip).  Every shard runs in this process, on its device, one after
    another, as in the JAX package.  The stitched result is a full
    ``(n − 1, 4)`` merge list in the global slot convention, heights
    monotone-repaired and height-sorted (on the CPU, as a tensor): a valid
    dendrogram, but not the exact one, since no merge crosses shards below
    the truncation level.
    """
    from repro_torch.core import dendrogram as dg
    from repro_torch.core.nnchain import nn_chain_from_points, nn_chain_from_summaries

    if method not in POINTS_METHODS:
        raise ValueError(
            f"the two-phase tier supports {POINTS_METHODS} (phase 2 "
            f"agglomerates geometric summaries), got {method!r}"
        )
    X = np.asarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"expected (n, d) points, got {X.shape}")
    n = X.shape[0]
    if n < 2:
        return LWResult(merges=torch.zeros((0, 4), dtype=torch.float32), n_merges=0)
    p = int(shards) if shards is not None else group_size()
    if p < 1:
        raise ValueError(f"shards must be positive, got {shards}")
    dev = resolve_device(device)
    p = min(p, n)
    base = math.ceil(n / p)

    stitched: list = []
    reps: list[int] = []
    Wg, ug, szg = [], [], []
    for o in range(0, n, base):
        Xs = X[o:o + base]
        m = Xs.shape[0]
        k_s = (intermediate_k if intermediate_k is not None
               else max(1, int(round(math.sqrt(m)))))
        k_s = max(1, min(int(k_s), m))
        if m >= 2 and m - k_s > 0:
            res = nn_chain_from_points(Xs, method, device=dev)
            if res.n_merges != m - 1:
                raise RuntimeError(
                    f"phase-1 chain on shard at offset {o} hit its "
                    "iteration cap (NaNs in the input?)"
                )
            local = dg.canonical_order(res.merges.cpu().numpy(), n=m)[: m - k_s]
        else:
            local = np.zeros((0, 4), np.float32)
        W, u, sizes, alive = _replay_summaries(Xs, local, method)
        for row in local:
            stitched.append((o + row[0], o + row[1], row[2], row[3]))
        for s in np.flatnonzero(alive):
            reps.append(o + int(s))
            Wg.append(W[s])
            ug.append(u[s])
            szg.append(sizes[s])

    K = len(reps)
    if K >= 2:
        res2 = nn_chain_from_summaries(np.stack(Wg), np.array(ug, np.float32),
                                       np.array(szg, np.float32), method, device=dev)
        if res2.n_merges != K - 1:
            raise RuntimeError(
                "phase-2 summary chain hit its iteration cap "
                "(NaNs in the input?)"
            )
        m2 = res2.merges.cpu().numpy()
        reps_arr = np.asarray(reps, np.float32)
        # summaries are enumerated in ascending global-slot order, so the
        # i < j slot convention survives the index mapping unchanged
        mapped = m2.copy()
        mapped[:, 0] = reps_arr[m2[:, 0].astype(np.int64)]
        mapped[:, 1] = reps_arr[m2[:, 1].astype(np.int64)]
        stitched.extend(map(tuple, mapped))

    merges = np.asarray(stitched, np.float32).reshape(-1, 4)
    # monotone repair (unbounded clamp budget) and the canonical height
    # sort: emission order is dependency order, so the repaired stable sort
    # is a valid dendrogram by construction (canonical_order validates it)
    merges = dg.canonical_order(merges, n=n, rtol=1e30)
    return LWResult(merges=torch.from_numpy(merges), n_merges=merges.shape[0])
