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
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import distance
from repro_torch.core.engine import (
    ShardedLWResult,
    check_knobs,
    resolve_compaction,
    resolve_device,
    resolve_n_steps,
    run_sharded,
    symmetrize,
)
from repro_torch.distributed.sharding import shard_rows

#: ``kind`` of :func:`distributed_pairwise`.
PAIRWISE_KINDS = ("sqeuclidean", "euclidean", "cosine", "rmsd")


def _collective(name: str, old: str):
    return getattr(dist, name, None) or getattr(dist, old)


@dataclass(eq=False)
class Ring:
    """The paper's processor ring: a process group, this process's rank in
    it, its size ``p`` and the device this rank's tensors live on.  Its
    methods are the engine's collectives, each counted in
    :attr:`collectives`."""

    group: Any
    rank: int
    size: int
    device: torch.device
    collectives: int = 0

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the first dimension, in rank
        order."""
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        _collective("all_gather_single", "all_gather_into_tensor")(out, t.contiguous(),
                                                                   group=self.group)
        self.collectives += 1
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        self.collectives += 1
        return t

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks and keep this rank's ``1/p`` of the first
        dimension."""
        out = torch.empty((t.shape[0] // self.size, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, t.contiguous(),
                                                                      group=self.group)
        self.collectives += 1
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk ``q`` of ``t``'s first dimension (``p`` equal chunks) goes
        to rank ``q``; chunk ``q`` of the result came from rank ``q``."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        self.collectives += 1
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


def make_cluster_mesh(device=None) -> Ring:
    """The ring over every rank of the default process group, on ``device``
    (CUDA unless the caller names another, as
    :func:`repro_torch.core.engine.resolve_device` decides).  With no group
    up, brings up a world-size-1 group in this process on a
    ``HashStore``: NCCL for a CUDA device, gloo for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        resolve_device(dev)         # no GPU: raise before bringing anything up
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
