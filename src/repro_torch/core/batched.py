"""Batched multi-problem engines: many small dendrograms at once.

Counterpart of :mod:`repro.core.batched`.  The paper scales one large
problem; production traffic is the transpose, many small problems (one
dendrogram per user, document shard or protein family).  Ragged batches
are padded into **shape buckets**: a problem's ``n`` rounds up to the
next size of :data:`BUCKETS`, a bucket's batch up to a power of two, and
each bucket runs as one batched engine call.  Padded slots are born dead
and padded problems have ``n_real = 0``.  Two engines run a bucket on one
device (:mod:`repro_torch.core.batch_engine`):

* **serial** — plain torch over the ``(B, n, n)`` bucket, every lane
  merging in lockstep.
* **kernel** — the batch-grid forms of the CUDA kernels, one launch a
  lockstep merge (``lazy``: two), replayed from CUDA graphs
  (:func:`repro_torch.kernels.ops.lance_williams_kernelized_batch`).

Each problem's merges equal the single-problem run on the same backend
bit for bit, and the JAX package's slot for slot.  A bucket may instead
run the **batched NN chain** (``algorithm="nnchain"``, or ``"auto"`` for
matrix-free points buckets of
:data:`repro_torch.core.nnchain.NNCHAIN_BATCH_AUTO_MIN_N` or more); its
merges come back canonicalized (height-sorted), early stop applied after
the fact.  The JAX package's distributed engine (whole problems sharded
over a mesh) is not ported yet: ``engine="distributed"`` raises
``NotImplementedError`` (ROADMAP.md A7).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import dendrogram as dg
from repro_torch.core.batch_engine import KernelBatchLoop, run_dense_batch
from repro_torch.core.engine import VARIANTS, resolve_compaction, resolve_device, symmetrize
from repro_torch.core.linkage import METHODS
from repro_torch.core.nnchain import (
    nn_chain_batched,
    nn_chain_batched_from_points,
    resolve_batch_algorithm,
)

#: Static padded-n grid (shape buckets), the JAX package's.
BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_n(n: int) -> int:
    """Smallest bucket that fits a problem of ``n`` items."""
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"problem size n={n} exceeds the largest batch bucket {BUCKETS[-1]}; "
        "cluster it with the single-problem distributed engine instead"
    )


def bucket_batch(b: int, multiple_of: int = 1) -> int:
    """Round a batch size up to a power of two, then up to a multiple of
    ``multiple_of`` (the device count for the sharded engine)."""
    out = max(1, 1 << (b - 1).bit_length())
    if multiple_of > 1 and out % multiple_of:
        out = -(-out // multiple_of) * multiple_of
    return out


@dataclass(frozen=True)
class BucketSignature:
    """Static signature of one bucket dispatch (the JAX package's compile
    key): two dispatches with one signature run the same shapes and loop
    structure."""

    bucket_n: int          # padded problem size (from the BUCKETS grid)
    bucket_B: int          # padded batch size (power of two × device multiple)
    method: str
    engine: str            # 'serial' | 'distributed' | 'kernel'
    variant: str
    n_steps: int           # static trip count = max(bucket_n - stop_at_k, 0)
    with_threshold: bool   # structural: a run that checks a threshold
    compaction: bool = False  # structural: staged vs single-stage loop
    algorithm: str = "lw"     # merge engine: 'lw' | 'nnchain'
    points_dim: int = 0       # >0: matrix-free (B, n, d) operands (nnchain)


def _resolve_bucket_compaction(flag, engine: str, bucket_n: int, n_steps: int) -> bool:
    """Resolved compaction flag of one bucket: a bucket property, since the
    stage plan runs on the bucket's padded shape.  The kernel engine
    resolves through :func:`repro_torch.kernels.ops.resolve_kernel_compaction`,
    whose plan halves down to ``KERNEL_MIN_STAGE = 256`` with no 128-lane
    alignment: the JAX kernel plan stages bucket 256 (256 → 128) and this
    one does not, so the two packages' kernel signatures differ there."""
    if engine == "kernel":
        from repro_torch.kernels.ops import resolve_kernel_compaction

        return resolve_kernel_compaction(flag, bucket_n, n_steps)
    return resolve_compaction(flag, bucket_n, n_steps)


def bucket_signature(
    n: int,
    batch: int,
    *,
    method: str,
    engine: str = "serial",
    variant: str = "baseline",
    stop_at_k: int = 1,
    with_threshold: bool = False,
    b_multiple: int = 1,
    compaction: bool | str = "auto",
    algorithm: str = "lw",
    points_dim: int = 0,
) -> BucketSignature:
    """Signature of the bucket serving ``batch`` problems of ≤ ``n`` items,
    rounded as :func:`cluster_batch_merges` rounds them; ``compaction`` and
    ``algorithm`` are stored resolved.  An NN-chain bucket is canonical
    (full trip count, no threshold, baseline variant, no compaction): the
    chain runs the whole agglomeration and early stop is applied after."""
    bn = bucket_n(n)
    algo = resolve_batch_algorithm(
        algorithm, method=method, engine=engine, bucket_n=bn,
        variant=variant, compaction=compaction,
        points_capable=points_dim > 0,
    )
    if algo == "nnchain":
        return BucketSignature(
            bucket_n=bn, bucket_B=bucket_batch(batch, b_multiple), method=method,
            engine="serial", variant="baseline", n_steps=bn - 1, with_threshold=False,
            compaction=False, algorithm="nnchain", points_dim=points_dim,
        )
    n_steps = max(bn - stop_at_k, 0)
    return BucketSignature(
        bucket_n=bn, bucket_B=bucket_batch(batch, b_multiple), method=method, engine=engine,
        variant=variant, n_steps=n_steps, with_threshold=with_threshold,
        compaction=_resolve_bucket_compaction(compaction, engine, bn, n_steps),
    )


@dataclass(frozen=True)
class BatchStats:
    """Scheduler accounting for one :func:`cluster_batch_merges` call."""

    n_problems: int
    buckets: tuple[tuple[int, int], ...]   # (bucket_n, n_problems) per bucket
    padded_problems: int                   # dead problems added for B rounding
    engine: str
    cells_real: int = 0                    # sum of n_b² (n_b·d matrix-free) real
    cells_padded: int = 0                  # sum of cells dispatched incl. padding
    # (bucket_n, 'lw' | 'nnchain') per dispatched bucket, aligned with `buckets`
    bucket_algorithms: tuple[tuple[int, str], ...] = ()

    @property
    def pad_waste(self) -> float:
        """Fraction of dispatched matrix cells that are padding (dead slots
        of real problems and whole dead problems)."""
        if self.cells_padded == 0:
            return 0.0
        return 1.0 - self.cells_real / self.cells_padded


# ---------------------------------------------------------------------------
# packing and slicing
# ---------------------------------------------------------------------------


def _fill_lanes(out: torch.Tensor, arrays, dirty: int) -> torch.Tensor:
    """Write the real problems (numpy arrays or tensors) into the first
    lanes of ``out``, each at the top-left of its lane, after zeroing the
    first ``max(dirty, len(arrays))`` lanes: ``out`` is zero past the lanes
    an earlier fill wrote (``dirty``), so padding stays zero."""
    out[: max(dirty, len(arrays))].zero_()
    for b, a in enumerate(arrays):
        a = torch.as_tensor(a, dtype=torch.float32)
        out[(b, *(slice(0, k) for k in a.shape))] = a
    return out


def pack_bucket(problems: list, sig: BucketSignature,
                device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Stack one bucket's problems into the engine's operand layout on
    ``device``, as a run packs them (:meth:`BucketProgram.load` of a
    program built for ``sig``): ``(bucket_B, bucket_n, bucket_n)`` float32
    matrices, or ``(bucket_B, bucket_n, points_dim)`` points for a
    matrix-free signature (padded slots and problems zero), and the
    ``(bucket_B,)`` real sizes."""
    prog = BucketProgram(sig, device)
    prog.load(problems)
    return prog.operand, prog.n_real


def pack_points_bucket(points: list, sig: BucketSignature,
                       device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_bucket` of a matrix-free bucket's ``(n_b, d)`` point
    sets: a padded lane costs O(n·d)."""
    return pack_bucket(points, sig, device)


def merge_prefix(n: int, stop_at_k: int, n_merges: int) -> int:
    """Rows of a lane's merge buffer that belong to its problem: the first
    ``max(n - stop_at_k, 0)``, cut further by a threshold stop (the lane's
    recorded count)."""
    return min(max(n - stop_at_k, 0), int(n_merges))


# ---------------------------------------------------------------------------
# the bucket program: one signature's run on one device
# ---------------------------------------------------------------------------


class BucketProgram:
    """One :class:`BucketSignature`'s run on one device, built once and run
    many times: the port's counterpart of the JAX package's AOT-compiled
    bucket executable (:mod:`repro_torch.service.cache` keeps them).

    It allocates the bucket's operand once, ``(B, n, n)`` float32 (``(B, n,
    d)`` for a matrix-free chain bucket), with the ``(B,)`` real sizes and
    a host staging copy of each (pinned on a CUDA device).  The kernel
    engine's LW bucket also builds its :class:`~repro_torch.core.batch_engine.KernelBatchLoop`:
    each stage's static buffers for the signature's plan, and each stage's
    CUDA graph, captured once.  With ``eager=True`` (a cached program) every
    stage is built here and no run builds or captures; by default (a
    one-shot :func:`cluster_batch_merges` bucket) a stage is built when a
    run first reaches it, so a run that stops early pays for no later
    stage.  The serial engine and the batched chain keep their static
    operand and run their eager loops (their steps allocate as they go).

    :meth:`run` is :meth:`load` then :meth:`execute` under the program's
    lock: a program owns buffers that a run updates in place, so one run
    holds it at a time (a second caller, say a worker the service's
    watchdog abandoned, waits its turn).  :meth:`load` packs the problems
    into the staging copy and uploads it in one copy (device tensors are
    packed on the device directly); :meth:`execute` symmetrizes the operand
    in place and runs the engine, returning ``(merges, n_merges)``: the
    ``(B, n_steps, 4)`` records on the device and each lane's merge count
    (on the device for LW, on the host for the chain).  Each lane's merges
    are a fresh :func:`cluster_batch_merges` run's bit for bit.
    ``BucketProgram.built`` counts the programs built in this process.
    """

    built = 0

    def __init__(self, sig: BucketSignature, device="cpu", *, eager: bool = False):
        dev = torch.device(device)
        self.sig, self.device = sig, dev
        self.lock = threading.Lock()
        width = sig.points_dim or sig.bucket_n
        shape = (sig.bucket_B, sig.bucket_n, width)
        with _on(dev):
            self.operand = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.n_real = torch.zeros(sig.bucket_B, dtype=torch.int64, device=dev)
            pin = dev.type == "cuda"
            self._staging = torch.zeros(shape, dtype=torch.float32, pin_memory=pin)
            self._n_real_host = torch.zeros(sig.bucket_B, dtype=torch.int64, pin_memory=pin)
            self._uploaded = torch.cuda.Event() if pin else None
            self._used = 0              # lanes the last load wrote
            self._loop = None
            if sig.algorithm == "lw" and sig.engine == "kernel":
                self._loop = KernelBatchLoop(self.operand, method=sig.method,
                                             n_steps=sig.n_steps, variant=sig.variant,
                                             compaction=sig.compaction, eager=eager)
        BucketProgram.built += 1

    @property
    def nbytes(self) -> int:
        """Device bytes the program keeps: the operand, the sizes and the
        kernel loop's static buffers."""
        ts = [self.operand, self.n_real]
        if self._loop is not None:
            ts += self._loop.tensors()[1:]      # past the operand
        return sum(t.numel() * t.element_size() for t in ts)

    def load(self, problems: list) -> None:
        """Pack ``problems`` (numpy arrays or tensors, at most ``bucket_B``)
        into the operand: each at the top-left of its lane, zeros in every
        padded cell and lane."""
        if len(problems) > self.sig.bucket_B:
            raise ValueError(f"{len(problems)} problems exceed the bucket's {self.sig.bucket_B}")
        ts = [torch.as_tensor(p, dtype=torch.float32) for p in problems]
        with _on(self.device):
            if self._uploaded is not None:
                self._uploaded.synchronize()    # the last upload has left the host copies
            if all(t.device.type == "cpu" for t in ts):
                _fill_lanes(self._staging, ts, self._used)
                self._used = len(ts)
                self.operand.copy_(self._staging, non_blocking=True)
            else:                               # a run rewrites the operand: zero it all
                _fill_lanes(self.operand, ts, self.sig.bucket_B)
            self._n_real_host.zero_()
            self._n_real_host[: len(ts)] = torch.tensor([t.shape[0] for t in ts])
            self.n_real.copy_(self._n_real_host, non_blocking=True)
            if self._uploaded is not None:
                self._uploaded.record()

    def execute(self, distance_threshold: float | None = None):
        """Run the engine on the loaded bucket; ``(merges, n_merges)``."""
        sig, dev = self.sig, self.device
        with _on(dev):
            if sig.algorithm == "nnchain":
                chain = nn_chain_batched_from_points if sig.points_dim else nn_chain_batched
                res = chain(self.operand, self._n_real_host.numpy(), sig.method, device=dev)
                return res.merges, res.n_merges
            thr = distance_threshold if sig.with_threshold else None
            alive = torch.arange(sig.bucket_n, device=dev) < self.n_real[:, None]
            if self._loop is not None:
                self.operand.copy_(symmetrize(self.operand))
                res = self._loop.run(alive, thr)
                return res.merges.clone(), res.n_merges
            res = run_dense_batch(symmetrize(self.operand), alive, method=sig.method,
                                  n_steps=sig.n_steps, variant=sig.variant,
                                  distance_threshold=thr, compaction=sig.compaction)
            return res.merges, res.n_merges

    def run(self, problems: list, distance_threshold: float | None = None):
        """:meth:`load` and :meth:`execute` under the program's lock."""
        with self.lock:
            self.load(problems)
            return self.execute(distance_threshold)


def _on(dev: torch.device):
    """The device context of a program's work: ``dev`` made current on the
    calling thread (a service runs programs on its worker threads)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def cluster_batch_merges(
    matrices: list,
    method: str = "complete",
    *,
    engine: str = "serial",
    variant: str = "baseline",
    stop_at_k: int = 1,
    distance_threshold: float | None = None,
    compaction: bool | str = "auto",
    algorithm: str = "auto",
    points: list | None = None,
    device=None,
) -> tuple[list[np.ndarray], BatchStats]:
    """Cluster many independent ``(n_b, n_b)`` distance matrices at once,
    on ``device`` (CUDA unless told otherwise).

    Returns ``(merge_lists, stats)`` as :func:`repro.core.batched.cluster_batch_merges`
    does: ``merge_lists[b]`` is problem ``b``'s slot-convention merge list,
    in input order, equal bit for bit to the single-problem run of the
    same backend (``lance_williams`` for ``serial``,
    ``lance_williams_kernelized`` for ``kernel``) with the same early-stop
    knobs.  ``matrices`` may hold numpy arrays or tensors; ``points``
    (aligned with them) marks matrix-free capable problems, whose matrix
    may then be ``None``.  ``algorithm`` routes each bucket through
    :func:`repro_torch.core.nnchain.resolve_batch_algorithm`; NN-chain
    lists come back canonicalized.
    """
    if method not in METHODS:
        raise ValueError(f"unknown linkage method {method!r}")
    if engine not in ("serial", "distributed", "kernel"):
        raise ValueError(f"unknown batch engine {engine!r}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    if stop_at_k < 1:
        raise ValueError(f"stop_at_k must be >= 1, got {stop_at_k}")
    if algorithm == "nnchain":
        # validate method/engine once up front (raises on a bad combo)
        resolve_batch_algorithm(algorithm, method=method, engine=engine, bucket_n=BUCKETS[0],
                                variant=variant, compaction=compaction)
    elif algorithm not in ("auto", "lw"):
        raise ValueError(f"algorithm must be 'auto', 'lw' or 'nnchain', got {algorithm!r}")
    if engine == "distributed":
        raise NotImplementedError("engine='distributed' is not ported yet: ROADMAP.md A7")
    dev = resolve_device(device)
    matrices = list(matrices)
    pts = ([None] * len(matrices) if points is None
           else [None if p is None else np.asarray(p, np.float32) for p in points])
    if len(pts) != len(matrices):
        raise ValueError(f"points must align with matrices: {len(pts)} != {len(matrices)}")
    sizes: list[int] = []
    for b in range(len(matrices)):
        p = pts[b]
        if p is not None:
            if p.ndim != 2:
                raise ValueError(f"problem {b}: expected (n, d) points, got {p.shape}")
            if p.shape[0] < 2:
                raise ValueError(f"problem {b}: need at least 2 items, got {p.shape[0]}")
            sizes.append(int(p.shape[0]))
            continue
        m = matrices[b] if isinstance(matrices[b], torch.Tensor) else np.asarray(matrices[b])
        matrices[b] = m
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            raise ValueError(f"problem {b}: expected a square matrix, got {tuple(m.shape)}")
        if m.shape[0] < 2:
            raise ValueError(f"problem {b}: need at least 2 items, got {m.shape[0]}")
        sizes.append(int(m.shape[0]))

    # group by (shape bucket, matrix-free dim): a points problem joins the
    # matrix-free bucket only when its bucket resolves to nnchain; otherwise
    # its matrix is built here and it rides the dense bucket
    groups: dict[tuple[int, int], list[int]] = {}
    for idx in range(len(matrices)):
        bn = bucket_n(sizes[idx])
        p = pts[idx]
        use_points = p is not None and resolve_batch_algorithm(
            algorithm, method=method, engine=engine, bucket_n=bn, variant=variant,
            compaction=compaction, points_capable=True,
        ) == "nnchain"
        if p is not None and not use_points and matrices[idx] is None:
            diff = p[:, None, :] - p[None, :, :]
            matrices[idx] = np.einsum("ijk,ijk->ij", diff, diff).astype(np.float32)
        groups.setdefault((bn, p.shape[1] if use_points else 0), []).append(idx)

    out: list[np.ndarray | None] = [None] * len(matrices)
    bucket_log: list[tuple[int, int]] = []
    algo_log: list[tuple[int, str]] = []
    padded_problems = cells_padded = cells_real = 0
    for n_pad, pdim in sorted(groups):
        idxs = groups[(n_pad, pdim)]
        bucket_log.append((n_pad, len(idxs)))
        sig = bucket_signature(
            n_pad, len(idxs), method=method, engine=engine, variant=variant,
            stop_at_k=stop_at_k, with_threshold=distance_threshold is not None,
            compaction=compaction, algorithm=algorithm, points_dim=pdim,
        )
        algo_log.append((n_pad, sig.algorithm))
        B_pad = sig.bucket_B
        padded_problems += B_pad - len(idxs)
        width = pdim or n_pad
        cells_padded += B_pad * n_pad * width
        cells_real += sum(sizes[i] * (pdim or sizes[i]) for i in idxs)

        prog = BucketProgram(sig, dev)
        merges, n_merges = prog.run([pts[i] if pdim else matrices[i] for i in idxs],
                                    distance_threshold)
        merges, n_merges = merges.cpu().numpy(), n_merges.cpu().numpy()
        for slot, idx in enumerate(idxs):
            nr = sizes[idx]
            if sig.algorithm == "lw":
                out[idx] = merges[slot, : merge_prefix(nr, stop_at_k, n_merges[slot])]
                continue
            if int(n_merges[slot]) != nr - 1:
                raise RuntimeError(
                    "NN-chain loop hit its iteration cap before finishing — the "
                    "input likely contains NaNs (the chain invariant needs a total "
                    "order on distances)"
                )
            canon = dg.canonical_order(merges[slot, : nr - 1], n=nr)
            out[idx] = dg.truncate_canonical(canon, nr, stop_at_k, distance_threshold)

    stats = BatchStats(
        n_problems=len(matrices), buckets=tuple(bucket_log), padded_problems=padded_problems,
        engine=engine, cells_real=cells_real, cells_padded=cells_padded,
        bucket_algorithms=tuple(algo_log),
    )
    return out, stats  # type: ignore[return-value]
