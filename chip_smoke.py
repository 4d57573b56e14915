#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the card's name and power limit;
   the registers and local bytes of every instantiation of B2's entries
   and of B1's and B3's batch forms (none may spill).
2. Hold each kernel against its plain torch version on the card, and time
   both: the LW kernels on a mid-run state with dead slots at n = 1968 and
   n = 16384 (the step kernel through both its entries, the per-row step
   and the resident merge, with the bytes it reads and the rate it reaches;
   the row update checked for all 7 methods), the row kernel at
   (m, d) = (1968, 64) and (32768, 128), its trip entry (a whole chain trip,
   the matrix-free chain's main path) at (32768, 128), (6155, 128) and
   (1968, 64) against its plain twin over 64 trips from the first state of
   a run, timed over 20 trips from the state they reach and over a graph
   replay of 256 trips, the pairwise kernel at the landmark
   assignment's (n, m, d) = (124917, 6155, 128) and the streaming shape
   (65536, 4096, 128), the row update's lazy merge entry (two launches a
   merge) against its plain twin over 64 merges from a mid-run state at
   n = 1968 and 8192 for all 7 methods, timed over 20 merges and over a
   graph replay of 128, with the host's time to enqueue one call of the row
   update, its lazy merge, the row kernel and the pairwise kernel.  Then the
   batch-grid forms of B1, B2's merge entry and B3's lazy merge on mid-run
   buckets (BATCH_KERNEL_SHAPES: (B, n) = (256, 1024), (4096, 16), the
   service card mix's (64, 128), (64, 256) and (64, 512) and (16, 2048)
   for all three, phase 13's (64, 1024) for B3, (2, 4096) for B1 and B3):
   each against its plain twin and against one single-problem launch a
   lane (20 or 8 lockstep merges against each lane's own), bit for bit,
   and timed with its bound summed over the lanes, with the plan it took;
   B1's rows with the matrix bytes it reads and its rate on them, B3's
   with its registers and local bytes.  B1's batch form also on the seed
   states the main path gives it (ARGMIN_SEED_SHAPES: each lane's live
   slots a prefix; full at (256, 1024), (256, 512) and (256, 256), ragged
   at the card mix's buckets and (4096, 16)), held and timed the same
   way.  A kernel whose operands fit in half the L2
   is timed on L2-resident data, as its caller finds them; its bound then
   takes the L2 read rate measured here (two torch reductions over a
   16 MiB buffer), else the HBM rate.
3. The paper's configuration: n = 1968 points in 64 dimensions, complete
   linkage, through ``cluster(..., algorithm="lw", backend="kernel")``,
   which stages the run by default (compaction: 1968, 984 and 492
   slots), each stage's merges replayed from its own captured CUDA graph
   of 128 merges; merges equal the same call with ``compaction=False``
   bit for bit and the engine run with the plain step functions, heights
   match scipy's, and the launch counters read one seed a stage and n - 1
   merges.  Then ``cluster(X, "complete")`` with default knobs resolves
   to the NN chain, whose dendrogram equals the LW loop's.
4. Full size: n = 16384 (a 1 GiB float32 matrix) through the same calls,
   staged (7 stages) and unstaged; wall time and peak memory; the first
   256 merges equal the plain engine's.  Phases 3 and 4 also read the
   device's busy time over a second, profiled run of each call (the
   profiler sees every merge launched from a graph replay), and set the
   host's time per merge against the device's over two graph replays of
   the unstaged loop (showing that the loop never waits for the card).
   Phases 3, 4, 7 and 8 print for each run, staged and unstaged, the
   wall, the busy time, the idle share, the stages and their sizes, the
   launches and the graph replays.
5. The dense NN chain on the first 8192 of phase 4's points
   (``cluster(X, "complete")``, default knobs): its dendrogram equals the
   LW loop's on the same points; wall, trips, busy time and idle share.  Phases 5 and 6 read the busy time and the trip
   count over a profiled run of the chain engine alone.
6. The matrix-free chain: ``cluster(X, "ward")`` with default knobs on
   n = 32768 points in 128 dimensions (the matrix would be 4 GiB): no
   matrix kept, one trip-kernel launch a trip, replayed from CUDA graphs
   of 256 trips (launches = replays x 256, at least the trips and less
   than one replay more; the profiler sees every launch), peak memory
   under 0.25 GiB, and the dendrogram of the host-driven chain loop with
   the plain row on the card (one read-back a trip: the "before" wall).
   Then at n = 4096 (d = 128) and n = 1968 (d = 64) the matrix-free ward
   run against the LW loop on the kernel backend.
7. The serial LW backend: ``cluster(X, "centroid")`` with default knobs on
   phase 5's points resolves to it (staged), reports ``backend="serial"``,
   launches no kernel, equals the unstaged call bit for bit, and gives the
   kernel backend's dendrogram; wall, busy time, idle share and peak
   memory.  At n = 1968, complete linkage under the ``rowmin`` and
   ``lazy`` variants gives phase 3's merges.
8. The kernel backend's ``lazy`` variant on phase 5's points, staged and
   unstaged (bit for bit): the row update's lazy merge entry, two launches
   a merge (the merge and the rescan) replayed from CUDA graphs of 128
   merges, and no other kernel; phase 5's LW merges; wall, busy time, idle
   share, host and device ms per merge, and the stale rows rescanned a
   merge.  ``rowmin`` and ``lazy`` at n = 1968: their launches, and phase
   3's merges.
9. ``distance_threshold`` on both LW backends, staged and unstaged (bit
   for bit): at the median merge height of phase 3's run (the stop is the
   first merge of the kernel plan's second stage) and at the height of
   merge 1600 (inside its third): exactly the merges at or below it.
10. Streaming assignment: a centroid index at k = 4096 of phase 6's fit and
    an exemplar index at k = 64 of phase 3's chain fit label 65536 fresh
    queries of the same mixtures with ``assign(backend="kernel")`` (one
    pairwise-kernel launch, the profiler agreeing) and ``backend="auto"``:
    equal labels on every row whose top-two gap exceeds the kernel's
    tolerance, near-ties counted; wall, busy time and idle share.
11. The landmark tier: ``cluster(X, "ward", algorithm="landmark")`` on
    n = 131072 points in 128 dimensions (k = 6155; the matrix would be
    64 GiB): the reference's query-budget gates, ARI >= 0.95 against the
    mixture's labels at the 8-cut, the same merges in a profiled second run,
    the landmark chain's trips against its trip-kernel launches, peak
    memory under 32 GiB; ``assign(backend="kernel")`` of the
    non-landmarks against the run's landmarks gives its groups.  At
    n = 8192 the landmark run against the exact chain at the 8-cut.
12. The paper's protein mode: ``cluster(C, "complete", metric="rmsd")`` on
    1968 conformations of 24 atoms builds its matrix on the card, which
    agrees with the plain rmsd's on the CPU, and equals the serial LW
    backend's run on that matrix.
13. Batching through ``cluster_batch``: the reference's bench setting
    (64 matrices of n = 128, complete, ``algorithm="lw"``) on both
    backends against a loop of single-problem calls (equal merges); full
    width, 256 problems of n = 1024 points in 64-D in one bucket of 1 GiB
    of matrices, kernel staged (1024, 512, 256) and unstaged (bit for
    bit), serial staged (the kernel's slots), kernel ``lazy`` on the first
    64; 4096 ragged problems of 16 to 512 points (buckets 16 … 512) on the
    kernel backend, 64 of them against single-problem runs; 256 ward point
    sets of n = 256 with default knobs, which go to the batched chain and
    give the LW batch's dendrograms.  Each run's wall, busy time, idle
    share, problems per second and launches (one B1 batch seed a stage,
    one B2 batch launch a lockstep merge; ``lazy``: one B3 batch launch a
    lockstep merge, the update and the rescan; graph replays of 128),
    checked against the kernel plan of each bucket.
14. The clustering service (``repro_torch.service``) under three traffic
    mixes (SERVICE_MIXES): the reference load driver's defaults (complete,
    serial engine, buckets 8/16/32, sizes 5-27, 200 req/s for 3 s); card
    scale on the batch kernels (complete, kernel engine, buckets
    128/256/512, sizes 100-512 in 16-D, ``max_batch`` 64, 5 s); and ward
    point sets in 64-D that go to the batched chain (buckets 64/128/256,
    ``max_batch`` 32, 3 s).  Each mix finds the rate a closed loop
    sustains for 3 s; the last two run open loop at 0.8 of it.  Each mix warms a
    service (programs built, graphs captured, each program's bytes), runs
    open loop (requests a second, p50/p99 latency, pad waste) and again
    under the profiler (busy time and idle share of the steady window).
    Gates: no program built and no graph captured after warmup; no
    request failed, shed, expired or unresolved; 64 sampled responses
    equal ``cluster_batch`` of the same problems (LW bit for bit, the
    chain as dendrograms); on the kernel engine, the launches of the
    dispatched buckets' plans.
15. One line ``{"kernels": [...]}`` with each kernel's numbers (the batch
    entries beside the others, with their launches in the service's card
    mix), the card's ``nvidia-smi`` line, and last
    ``{"ok": true, "device": {...}}``.

Every path is driven with the launch counters set to 0 just before it
and read just after.  Phase 6's profiled chain run (``--profile-chain``),
phases 10-12 (``--later-phases``), phase 13 (``--batch``) and phase 14
(``--service``) run in child processes of this script, for the
profiler's sake (``run_child``).

Needs one CUDA device and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import json
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
L2_PROBE_MIB, L2_PROBE_REPS = 16, 16   # the L2 probe reads a 16 MiB buffer 16 times a launch
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
PAPER_N, FULL_N, DIM = 1968, 16384, 64
CHAIN_N, CHAIN_DIM = 32768, 128  # matrix-free run: 16 MiB of summaries, no 4 GiB matrix
CROSS_SHAPES = ((4096, 128), (1968, 64))   # matrix-free ward held against the LW loop
MID_N = 8192                   # phases 5, 7, 8: n = 16384 until the smoke outgrew 700 s
ROW_SHAPES = ((PAPER_N, DIM), (CHAIN_N, CHAIN_DIM))
LANDMARK_N, LANDMARK_K = 131072, 6155   # k = ceil(sqrt(n) log2 n); the matrix would be 64 GiB
LANDMARK_PEAK_LIMIT_GIB = 32.0          # half of that matrix
LANDMARK_CROSS_N = 8192                 # the landmark run held against the exact chain
QUERY_N, CENTROID_K, EXEMPLAR_K = 65536, 4096, 64
TRIP_SHAPES = ((CHAIN_N, CHAIN_DIM), (LANDMARK_K, CHAIN_DIM), (PAPER_N, DIM))
TRIP_CHECKS = 64               # trips of the trip kernel held against its plain twin
LAZY_CHECKS = 64               # merges of B3's lazy merge held against its plain twin
LAZY_SHAPES = (PAPER_N, MID_N)
PAIRWISE_SHAPES = ((LANDMARK_N - LANDMARK_K, LANDMARK_K, CHAIN_DIM),
                   (QUERY_N, CENTROID_K, CHAIN_DIM))
PAIRWISE_RTOL, PAIRWISE_ATOL_SCALE = 1e-4, 1e-6   # atol = scale * max(|x|^2 + |y|^2)
CUT_K, QUALITY_MIN = 8, 0.95           # the mixtures' 8 components; the reference's gate
RMSD_N, RMSD_ATOMS, RMSD_ATOL = 1968, 24, 1e-4
PEAK_LIMIT_GIB = 0.25          # the matrix-free run must stay O(n d)
PROFILER_MISS_SHARE = 1e-3     # kernel records the profiler may drop in a whole run ...
PROFILER_MISS_MIN = 50_000     # ... of this many launches or more (fewer: none)
PROFILER_TRIES = 3             # profiled runs of a call before dropped records fail a phase
PREFIX = 256                   # merges of the full-size run held against the plain engine
STAGE_FLOORS = (None, 512, 256, 128)   # phase 3's kernel plan floors (None: unstaged) ...
FLOOR_REPS = 20                        # ... each timed this many times, in turns
THRESHOLD_STAGE2_MERGE = 1600  # phase 9: a stop in the kernel plan's third stage (merges 1476-1966)
SPLIT_REPLAYS = 2              # graph replays whose host time is set against their device time
MERGE_REPS = 20                # merges a timed batch of the step kernel's merge entry makes
SLEEP_CYCLES = 400_000_000     # ~0.2 s of GPU clock: holds the stream while the host enqueues
HOST_CALLS = 32                # calls timed on the host: ~400 launches of a plain version
BATCH_BENCH = (64, 128, 8)     # (B, n, d) of the reference's benchmarks/bench_batch.py
BATCH_FULL = (256, 1024, DIM)  # one bucket of 1 GiB of matrices, phase 4's n = 16384 matrix
BATCH_LAZY_B = 64              # the full bucket's first problems through kernel lazy
BATCH_RAGGED = (4096, 16, 512, 16)   # problems, n from 16 to 512 uniform, d (batch_dedup's traffic)
BATCH_SAMPLE = 64              # ragged lanes held against single-problem runs
BATCH_POINTS = (256, 256, DIM)  # (B, n, d) ward points: default knobs send them to the chain
# (B, n, timed merges, the batch forms timed there: B1 "argmin", B2 "merge", B3 "lazy"): the
# full-width and ragged buckets, the service card mix's (64 lanes of 128, 256 and 512) and few
# lanes of long rows, which a cluster owns: n = 2048 (a row in passes; B1, B2 and B3) and
# n = 4096 (B1 and B3); phase 13's kernel lazy bucket (B3)
BATCH_ALL = ("argmin", "merge", "lazy")
BATCH_KERNEL_SHAPES = ((256, 1024, MERGE_REPS, BATCH_ALL), (4096, 16, 8, BATCH_ALL),
                       (64, 128, MERGE_REPS, BATCH_ALL), (64, 256, MERGE_REPS, BATCH_ALL),
                       (64, 512, MERGE_REPS, BATCH_ALL),
                       (BATCH_LAZY_B, 1024, MERGE_REPS, ("lazy",)),
                       (16, 2048, MERGE_REPS, BATCH_ALL), (2, 4096, MERGE_REPS, ("argmin", "lazy")))
# (B, n, ragged): B1's batch form on a stage's seed state, each lane's live slots a prefix as
# compact_batch leaves them: the full-width stages (every slot live) and ragged prefixes (n/2 + 1
# to n live, the sizes a bucket of n holds) at the card mix's buckets and at (4096, 16)
ARGMIN_SEED_SHAPES = ((256, 1024, False), (256, 512, False), (256, 256, False),
                      (64, 128, True), (64, 256, True), (64, 512, True), (4096, 16, True))
# (B, n) at which B1's batch form runs with two live slots a lane: the fixed cost of a lane
ARGMIN_FLOOR_SHAPES = ((64, 128), (64, 256))
# the (lanes, n) at which B2's entries and B1's and B3's batch forms are loaded for the register
# and spill report: the single-problem entries on each row width, the batch forms on each path
RESOURCE_SHAPES = {"lw_step": ((1, 1024), (1, 4096), (1, 16384)),
                   "lw_merge": ((1, 1024), (1, 4096), (1, 16384)),
                   "lw_merge_batch": ((4096, 16), (1024, 32), (256, 64), (256, 127), (256, 128),
                                      (256, 256), (256, 512), (256, 1024), (64, 256), (64, 512),
                                      (16, 1024), (256, 2048), (16, 2048), (256, 1023),
                                      (16, 1023)),
                  "lazy_merge_batch": ((4096, 16), (1024, 32), (256, 64), (256, 128),
                                       (256, 1024), (66, 2048), (17, 2048), (2, 4096)),
                  "masked_argmin_batch": ((4096, 16), (4096, 17), (256, 64), (256, 127),
                                          (256, 128), (256, 255), (33, 256), (256, 256),
                                          (256, 512), (256, 1024), (64, 512), (16, 1024),
                                          (16, 2048), (2, 4096), (256, 1023), (16, 1023))}
RTOL, ATOL = 1e-4, 1e-5        # height tolerance of the JAX package's kernel tests
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
KERNEL_SYMBOLS = {             # wrapper -> its device functions, the first once a launch
    "masked_argmin": ("masked_row_min", "first_min_over_rows"),
    "masked_argmin_batch": ("argmin_batch_kernel",),
    "lw_merge_batch": ("lw_merge_batch_kernel",),
    "lazy_merge_batch": ("lazy_merge_batch_kernel",),
    "lw_step": ("lw_step_kernel", "pack_alive_kernel"),
    "lw_merge": ("lw_merge_kernel",),
    "lw_update": ("lw_update_kernel",),
    "lazy_merge": ("lazy_merge_kernel",),
    "lazy_rescan": ("lazy_rescan_kernel",),
    "row_sq_euclidean": ("row_sq_kernel",),
    "chain_trip": ("chain_trip_kernel",),
    "pairwise_sq_euclidean": ("pairwise_sq_kernel",),
}
NO_LAUNCHES = dict.fromkeys(KERNEL_SYMBOLS, 0)
ENTRY_SOURCES = {"masked_argmin_batch": "src/repro_torch/csrc/argmin_batch.cu",
                 "lw_merge_batch": "src/repro_torch/csrc/lw_merge_batch.cu",
                 "lazy_merge_batch": "src/repro_torch/csrc/lazy_merge_batch.cu"}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, batches: int = 5) -> float:
    """Median device ms of one call of ``fn``: CUDA events around ``reps``
    calls queued behind a sleep kernel, so host overhead leaves no gaps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        torch.cuda._sleep(50_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host µs to enqueue one call of ``fn``, with a sleep kernel holding
    the stream so that no call waits for the card.  The calls must fit in
    the device's launch queue (about a thousand launches), or the host
    blocks until the sleep ends: raises if the host time reached it."""
    fn()
    torch.cuda.synchronize()
    held, start = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    held.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    start.synchronize()
    if host_s * 1e3 >= held.elapsed_time(start):
        raise AssertionError(f"enqueueing {calls} calls took {host_s * 1e3:.1f} ms, as long "
                             "as the stream was held: the launch queue filled")
    return host_s / calls * 1e6


def l2_read_rate(torch) -> float:
    """The highest rate, bytes/s, at which two torch reductions read a
    16 MiB buffer that stays in the 50 MB L2: one reads it L2_PROBE_REPS
    times in a launch (a stride-0 view), one once.  A rate the card
    reaches, so its L2 peak is at least this."""
    buf = torch.rand(L2_PROBE_MIB * 2**18, device="cuda")
    reps = buf.expand(L2_PROBE_REPS, -1)
    n_bytes = buf.numel() * 4
    return max(L2_PROBE_REPS * n_bytes / (time_ms(torch, lambda: reps.sum(1)) * 1e-3),
               n_bytes / (time_ms(torch, lambda: buf.sum()) * 1e-3))


def bound(torch, n_bytes: float, n_ops: float, resident_bytes: float,
          l2_rate: float) -> dict:
    """The least ms the card could take, what bounds it, and the byte rate
    taken: the L2 read rate when the ``resident_bytes`` that a timed run
    keeps touching fit in half the L2 (they stay there between launches),
    else the HBM rate."""
    in_l2 = resident_bytes <= torch.cuda.get_device_properties(0).L2_cache_size / 2
    rate = l2_rate if in_l2 else HBM_BYTES_PER_S
    t_bytes, t_ops = n_bytes / rate, n_ops / FP32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_per_s=rate, hbm_bound_ms=max(n_bytes / HBM_BYTES_PER_S, t_ops) * 1e3)


def check_equivalent(np, got, want, n: int, what: str, near_ties: bool = False) -> bool:
    """The two merge lists describe the same dendrogram (clusters equal,
    heights within RTOL/ATOL): True.  With ``near_ties``, two lists that
    part at a near-tie give False: the lowest cluster of each list that the
    other lacks have heights within RTOL/ATOL of each other, so two merges
    that float32 rounding orders either way came out in other orders (on
    continuous data, two exact engines differ only so).  Otherwise print
    the clusters that differ with their heights in both lists and raise."""
    from repro_torch.core.dendrogram import merge_leafsets, merges_equivalent

    if merges_equivalent(got, want, n=n, rtol=RTOL, atol=ATOL):
        return True
    hg = dict(zip(merge_leafsets(got, n), np.asarray(got)[:, 2]))
    hw = dict(zip(merge_leafsets(want, n), np.asarray(want)[:, 2]))
    only_g = sorted((float(hg[c]), len(c), min(c)) for c in set(hg) - set(hw))
    only_w = sorted((float(hw[c]), len(c), min(c)) for c in set(hw) - set(hg))
    if (near_ties and only_g and only_w
            and abs(only_g[0][0] - only_w[0][0]) <= ATOL + RTOL * abs(only_w[0][0])):
        return False
    worst = max((abs(float(hg[c]) - float(hw[c])), float(hg[c]), float(hw[c]))
                for c in set(hg) & set(hw))
    print(f"{what}: {len(only_g)} clusters only in the first list, {len(only_w)} only in the "
          f"second; (height, size, slot), lowest first: {only_g[:4]} vs {only_w[:4]}; "
          f"largest height gap on shared clusters (gap, first, second): {worst}", flush=True)
    raise AssertionError(f"{what}: the dendrograms differ")


def check_merges(np, got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got[:, :2], want[:, :2]):
        bad = np.flatnonzero((got[:, :2] != want[:, :2]).any(axis=1))
        raise AssertionError(f"{what}: merge slots differ, first at step {bad[:1]}")
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=RTOL, atol=ATOL, err_msg=what)


def mid_run_state(torch, n: int, squared: bool, seed: int):
    """A state as the loop holds it after 40% of its merges: dead slots,
    sizes that add up, and the real next candidate."""
    from repro_torch.core.api import build_distance_matrix
    from repro_torch.core.engine import symmetrize
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels.minscan import masked_argmin_plain

    X = gaussian_mixture(seed=seed, n=n, dim=DIM, return_labels=False)
    D = symmetrize(build_distance_matrix(X, "sqeuclidean" if squared else "euclidean"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    alive = torch.rand(n, generator=gen, device="cuda") > 0.4
    alive[:2] = True
    sizes = torch.where(alive, torch.randint(1, 9, (n,), generator=gen, device="cuda"), 0)
    v, flat = masked_argmin_plain(D, alive)
    r, c = int(flat) // n, int(flat) % n
    return D, alive, sizes.to(torch.float32), min(r, c), max(r, c), v


def phase_kernels(torch, n: int, l2_rate: float) -> dict:
    """Each kernel against its plain version at size n; times and bounds."""
    from repro_torch.kernels import minscan

    out = {}
    D, alive, sizes, i, j, _ = mid_run_state(torch, n, squared=False, seed=1)
    live = int(alive.sum())
    v, flat = minscan.masked_argmin(D, alive)
    vp, flatp = minscan.masked_argmin_plain(D, alive)
    if (float(v), int(flat)) != (float(vp), int(flatp)):
        raise AssertionError(f"masked_argmin n={n}: kernel {(float(v), int(flat))} "
                             f"!= plain {(float(vp), int(flatp))}")
    # read the live submatrix and alive, write one value and one index;
    # one compare a live cell; the timed launches keep touching D
    out["masked_argmin"] = dict(
        n=n, live=live, max_abs_err=abs(float(v) - float(vp)),
        ms=time_ms(torch, lambda: minscan.masked_argmin(D, alive)),
        plain_ms=time_ms(torch, lambda: minscan.masked_argmin_plain(D, alive)),
        **bound(torch, 4 * live * live + n + 12, live * live, 4 * n * n, l2_rate),
    )

    for method in ("complete", "ward"):
        state = mid_run_state(torch, n, squared=method == "ward", seed=2)
        out[f"lw_step/{method}"] = phase_step(torch, method, *state, l2_rate)
        out[f"lw_merge/{method}"] = phase_merge(torch, method, *state, l2_rate)
        del state
    out["lw_update/complete"] = phase_row_update(torch, n, l2_rate)
    return out


def step_bound(torch, n: int, live: float, l2_rate: float) -> dict:
    """The step's bound with ``live`` slots live after the merge: read the
    live submatrix, write row and column i, read the sizes and the
    liveness, write each row's (min, first column); a compare and a select
    a live cell, about a dozen operations for the recurrence of each lane.
    The timed launches keep touching D."""
    return bound(torch, 4 * live * live + 8 * live + 17 * n, 2 * live * live + 12 * n,
                 4 * n * n, l2_rate)


def phase_step(torch, method: str, D, alive, sizes, i: int, j: int, dmin, l2_rate: float) -> dict:
    """B2's per-row entry against its plain version on a mid-run state, bit
    for bit, and timed (each call applies the same merge to D again)."""
    from repro_torch.kernels import lw_step

    n = D.shape[0]
    ij = torch.tensor([i, j], device="cuda")
    n_ij = sizes.index_select(0, ij)

    def args(Dm):
        rows = Dm.index_select(0, ij)
        return (method, Dm, rows[0], rows[1], dmin.reshape(1), n_ij[0:1], n_ij[1:2],
                sizes, alive, ij[0:1], ij[1:2])

    Dk, Dp = D.clone(), D.clone()
    kargs, pargs = args(Dk), args(Dp)
    _, rmin_k, rarg_k = lw_step.lw_step(*kargs)
    _, rmin_p, rarg_p = lw_step.lw_step_plain(*pargs)
    torch.cuda.synchronize()
    for a, b, what in ((Dk, Dp, "D"), (rmin_k, rmin_p, "rmin"), (rarg_k, rarg_p, "rarg")):
        if not torch.equal(a, b):
            raise AssertionError(f"lw_step {method} n={n}: {what} differs from the plain version")
    live = int(alive.sum()) - 1      # j dies in the merge
    return dict(n=n, live=live, max_abs_err=float((Dk - Dp).abs().max()), bit_equal=True,
                ms=time_ms(torch, lambda: lw_step.lw_step(*kargs)),
                plain_ms=time_ms(torch, lambda: lw_step.lw_step_plain(*pargs)),
                library_ms=None, **step_bound(torch, n, live, l2_rate))


def time_merges(torch, merge, b0, b, batches: int = 5, reps: int = MERGE_REPS) -> float:
    """Median device ms of one call of ``merge`` (a merge, a chain trip or a
    graph replay): CUDA events around ``reps`` calls made from the state
    ``b0``, restored into the buffers ``b`` before each batch, queued
    behind a sleep kernel."""
    times = []
    for batch in range(batches + 1):      # the first batch warms up
        for dst, src in zip(b, b0):
            dst.copy_(src)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            merge(b)
        end.record()
        end.synchronize()
        if batch:
            times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_merge(torch, method: str, D, alive, sizes, i: int, j: int, dmin,
                l2_rate: float) -> dict:
    """B2's merge entry, the main path's, against its plain twin on a
    mid-run state: one merge, every buffer bit for bit; then timed over
    MERGE_REPS merges from that state, with the bytes of the live rows it
    reads (4 L' n) and the rate it reads them at."""
    from repro_torch.kernels import lw_step

    n = D.shape[0]
    cand = (torch.tensor(i, device="cuda"), torch.tensor(j, device="cuda"), dmin)
    b0 = lw_step.merge_buffers(D, alive, sizes, torch.zeros((n, 4), device="cuda"), cand, 0)
    bk, bp = (lw_step.MergeBuffers(*(t.clone() for t in b0)) for _ in range(2))
    lw_step.lw_merge(method, bk)
    lw_step.lw_merge_plain(method, bp)
    torch.cuda.synchronize()
    for name, a, b in zip(lw_step.MergeBuffers._fields, bk, bp):
        if name != "sync" and not torch.equal(a, b):
            raise AssertionError(f"lw_merge {method} n={n}: {name} differs from the plain twin")
    if not torch.equal(bk.sync, b0.sync):
        raise AssertionError(f"lw_merge {method} n={n}: the kernel left its key/ticket at {bk.sync}")
    err = float((bk.D - bp.D).abs().max())
    del bp
    ms = time_merges(torch, lambda b: lw_step.lw_merge(method, b), b0, bk)
    plain_ms = time_merges(torch, lambda b: lw_step.lw_merge_plain(method, b), b0, bk)
    live = int(alive.sum()) - 1
    live_mean = live - (MERGE_REPS - 1) / 2      # a timed merge kills one slot
    read = 4 * live_mean * n                     # the live rows, read whole
    return dict(n=n, live=live, max_abs_err=err, bit_equal=True, ms=ms, plain_ms=plain_ms,
                library_ms=None, read_bytes=read, read_bytes_per_s=read / (ms * 1e-3),
                **step_bound(torch, n, live_mean, l2_rate))


def phase_row_update(torch, n: int, l2_rate: float) -> dict:
    """The row update against its plain version on a mid-run state, for
    every method; ``complete`` timed, with the host's time to enqueue it."""
    from repro_torch.core.linkage import METHODS
    from repro_torch.kernels import lw_update

    D, alive, sizes, i, j, dmin = mid_run_state(torch, n, squared=False, seed=3)
    ij = torch.tensor([i, j], device="cuda")
    rows, n_ij = D.index_select(0, ij), sizes.index_select(0, ij)
    keep = alive.index_fill(0, ij, False)
    err, bit_equal = 0.0, True

    def args(method):
        return (method, rows[0], rows[1], dmin.reshape(1), n_ij[0:1], n_ij[1:2], sizes, keep)

    for method in METHODS:
        got, want = lw_update.lw_update(*args(method)), lw_update.lw_update_plain(*args(method))
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise AssertionError(f"lw_update {method} n={n}: kernel differs from plain")
        err = max(err, float((got - want).abs().max()))
        bit_equal &= torch.equal(got, want)
    a, live = args("complete"), int(keep.sum())
    n_bytes = lw_update_bytes("complete", n, live)
    return dict(n=n, live=live, methods_checked=len(METHODS), max_abs_err=err,
                bit_equal=bit_equal,
                ms=time_ms(torch, lambda: lw_update.lw_update(*a)),
                plain_ms=time_ms(torch, lambda: lw_update.lw_update_plain(*a)),
                library_ms=None,
                host_us=host_us(torch, lambda: lw_update.lw_update(*a)),
                plain_host_us=host_us(torch, lambda: lw_update.lw_update_plain(*a)),
                **bound(torch, n_bytes, 10 * live, n_bytes, l2_rate))


def lazy_state(torch, n: int, method: str):
    """B3's resident lazy merge on a mid-run state: every row's cached
    minimum and the candidate from them, as the loop's seed gives them."""
    from repro_torch.core import engine
    from repro_torch.kernels import lw_update

    D, alive, sizes, _, _, _ = mid_run_state(torch, n, method in ("centroid", "median", "ward"),
                                             seed=5)
    ks = torch.arange(n, device="cuda")
    rmin, rarg = engine._masked_row_mins(D, alive, ks, ks)
    cand = engine._cached_cand(alive, rmin, rarg, ks)
    return lw_update.lazy_buffers(D, alive, sizes, torch.zeros((n, 4), device="cuda"), cand,
                                  (rmin, rarg), 0)


def lazy_merge_bytes(n: int, stale, changed):
    """The bytes one resident lazy merge must move with ``stale`` rows to
    rescan and ``changed`` cache entries rewritten by its update (the
    columns whose cached minimum the invalidation lowers, and row i): rows
    i and j, alive, sizes and both caches read once (25 n), row and column
    i written (8 n), both caches written for each changed entry and each
    stale row (12 each), and each stale row read (4 n).  Where a kernel
    lists its stale rows is its own choice, and not counted.  Numbers, or
    tensors of a lane's."""
    return 33 * n + 12 * changed + stale * (4 * n + 12)


def lazy_cache_changes(torch, method: str, b, update, rescan, reps: int):
    """The cache entries that a lazy merge's update rewrites, a merge on
    average (a lane's, for batch buffers): the plain twin's ``update`` and
    ``rescan`` made ``reps`` times on a copy of the buffers ``b``, counting
    the entries of (rmin, rarg) that each update changes."""
    bp = type(b)(*(t.clone() for t in b))
    changed = 0
    for _ in range(reps):
        rmin, rarg = bp.rmin.clone(), bp.rarg.clone()
        update(method, bp)
        changed = changed + ((bp.rmin != rmin) | (bp.rarg != rarg)).sum(-1)
        rescan(bp)
    return changed.to(torch.float64) / reps


def phase_lazy_merge(torch, n: int, l2_rate: float) -> dict:
    """B3's resident lazy merge (two launches: the merge and the rescan)
    against its plain twin over LAZY_CHECKS successive merges from a
    mid-run state, every buffer bit for bit, for every method; then
    ``complete`` timed as the step kernel's merge entry is (MERGE_REPS
    merges from the state, restored before each batch), and as a graph
    replay of THRESHOLD_CHECK_TRIPS merges, with the stale rows it
    rescanned a merge."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS
    from repro_torch.core.linkage import METHODS
    from repro_torch.kernels import lw_step, lw_update

    err = 0.0
    for method in METHODS:
        bk = lazy_state(torch, n, method)
        bp = lw_update.LazyBuffers(*(t.clone() for t in bk))
        sync = bk.sync.clone()
        for _ in range(LAZY_CHECKS):
            lw_update.lazy_merge(method, bk)
            lw_update.lazy_merge_plain(method, bp)
        torch.cuda.synchronize()
        for name, a, b in zip(lw_update.LazyBuffers._fields, bk, bp):
            if name != "stale" and not torch.equal(a, b):
                raise AssertionError(f"lazy_merge {method} n={n}: {name} differs from the plain "
                                     f"twin after {LAZY_CHECKS} merges")
        if not torch.equal(bk.sync, sync):
            raise AssertionError(f"lazy_merge {method} n={n}: keys/tickets left at {bk.sync}")
        err = max(err, float((bk.rmin - bp.rmin).abs().nan_to_num().max()))
        del bk, bp
    b = lazy_state(torch, n, "complete")
    live = int(b.alive.sum()) - 1
    b0 = [t.clone() for t in b]
    ms = time_merges(torch, lambda b: lw_update.lazy_merge("complete", b), b0, b)
    plain_ms = time_merges(torch, lambda b: lw_update.lazy_merge_plain("complete", b), b0, b)
    for dst, src in zip(b, b0):
        dst.copy_(src)
    for _ in range(MERGE_REPS):
        lw_update.lazy_merge("complete", b)
    stale = (int(b.rescanned) - int(lw_update.LazyBuffers(*b0).rescanned)) / MERGE_REPS
    changed = float(lazy_cache_changes(torch, "complete", lw_update.LazyBuffers(*b0),
                                       lw_update._lazy_update_plain, lw_update.lazy_rescan_plain,
                                       MERGE_REPS))
    for dst, src in zip(b, b0):
        dst.copy_(src)
    graph = lw_step.MergeGraph("complete", b, THRESHOLD_CHECK_TRIPS, merge=lw_update.lazy_merge)
    replay_ms = time_merges(torch, lambda _: graph.replay(), b0, b, reps=1)
    n_bytes = lazy_merge_bytes(n, stale, changed)
    return dict(n=n, live=live, methods_checked=len(METHODS), checked_merges=LAZY_CHECKS,
                max_abs_err=err, bit_equal=True, ms=ms, plain_ms=plain_ms,
                graph_ms_per_merge=replay_ms / THRESHOLD_CHECK_TRIPS,
                stale_rows_per_merge=stale, changed_entries_per_merge=changed, library_ms=None,
                host_us=host_us(torch, lambda: lw_update.lazy_merge("complete", b)),
                **bound(torch, n_bytes, 12 * live + 2 * stale * n, 4 * n * n, l2_rate))


def batch_mid_state(torch, B: int, n: int, reps: int, seed: int, dead: float = 0.4):
    """A bucket of B lanes as the batched loop holds them mid-run: each
    lane a symmetric matrix of random points, a share ``dead`` of its slots
    dead at random (at least reps + 2 live), sizes that are not 1, its
    merge limit (live - 1), and its masked first minimum."""
    from repro_torch.core.engine import symmetrize
    from repro_torch.kernels.minscan import masked_argmin_batch_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, 8, generator=gen, device="cuda")
    D = symmetrize(torch.cdist(X, X))
    alive = torch.rand(B, n, generator=gen, device="cuda") >= dead
    alive[:, :reps + 2] = True
    sizes = torch.where(alive, torch.randint(1, 9, (B, n), generator=gen, device="cuda"), 0)
    v, flat = masked_argmin_batch_plain(D, alive)
    cand = (torch.div(flat, n, rounding_mode="floor"), flat % n, v)
    return D, alive, sizes.to(torch.float32), alive.sum(1) - 1, cand


def batch_seed_state(torch, B: int, n: int, ragged: bool, seed: int):
    """A bucket of B lanes as a stage's seed finds it: each lane a
    symmetric matrix of random points whose live slots are a prefix (the
    live rows and columns packed ascending into the front, as compact_batch
    leaves them): all n, or with ``ragged`` n/2 + 1 to n at random (the
    sizes that a bucket of n holds)."""
    from repro_torch.core.engine import symmetrize

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, n, 8, generator=gen, device="cuda")
    D = symmetrize(torch.cdist(X, X))
    live = (torch.randint(n // 2 + 1, n + 1, (B,), generator=gen, device="cuda") if ragged
            else torch.full((B,), n, device="cuda"))
    return D, torch.arange(n, device="cuda") < live[:, None]


def argmin_read_bytes(torch, alive, plan) -> float:
    """The matrix bytes B1's batch form reads on the liveness ``alive``
    under ``plan`` (None: a tree whose batch form reads every live row
    whole): each lane's live rows over its live span, from its first live
    slot to one past its last; a warp-owned lane reads the span's rows
    whole, the bulk copies read the span rounded out to 16 bytes where that
    is 128 columns or more, and rows in registers read it from the first
    live slot's bitmask word (a multiple of 32 columns) on."""
    B, n = alive.shape
    live = alive.sum(1).to(torch.float64)
    if plan is None:
        return float((4 * live * n).sum())
    ks = torch.arange(n, device=alive.device)
    lo = torch.where(alive, ks, n).amin(1)
    hi = torch.where(alive, ks + 1, 0).amax(1)
    width = (hi - lo).clamp_min(0).to(torch.float64)
    if plan.group == 0:
        return float((4 * width * n).sum())
    width4 = ((hi + 3) // 4 * 4 - lo // 4 * 4).to(torch.float64)
    width32 = (hi - lo // 32 * 32).clamp_min(0).to(torch.float64)
    bulk = (width4 >= 128) & (hi > lo) & (plan.unroll == 0)
    return float((4 * live * torch.where(bulk, width4, width32)).sum())


def check_batch_buffers(torch, got, want, what: str, skip=("stale",)) -> None:
    for name, a, b in zip(type(got)._fields, got, want):
        if name not in skip and not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")


def check_against_single(torch, bk, single_buffers, single_merge, method, reps: int,
                         fields, what: str) -> None:
    """Each lane of the batch buffers ``bk`` after ``reps`` lockstep merges
    against the single-problem entry launched on that lane alone as many
    times as its limit allows, field by field, bit for bit."""
    for b in range(bk.D.shape[0]):
        one = single_buffers(b)
        for _ in range(min(reps, int(bk.limit[b]))):
            single_merge(method, one)
        for name in fields:
            if not torch.equal(getattr(one, name).reshape(-1), getattr(bk, name)[b].reshape(-1)):
                raise AssertionError(f"{what}: lane {b}'s {name} differs from its single launches")


def resource_report(torch) -> dict:
    """Registers and local (spilled) bytes a thread of every instantiation
    of B2's entries and B3's batch form, for each method, and of B1's batch
    form, and the batch forms' blocks an SM: ``{entry: {"B=.. n=..": {method:
    [regs, local_bytes, blocks_per_sm]}}}`` (B1's keyed by "-"), the batch
    forms' keys with their plan.  A tree whose B1 batch form has no plan
    reports none for it."""
    from repro_torch.core.linkage import METHODS
    from repro_torch.kernels import lw_step, lw_update, minscan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {"lw_merge_batch": lw_step.merge_batch_plan,
             "lazy_merge_batch": lw_update.lazy_batch_plan,
             "masked_argmin_batch": getattr(minscan, "argmin_batch_plan", None)}

    def resources(method, n, entry, B):
        if entry == "lazy_merge_batch":
            return lw_update.lazy_batch_resources(method, n, lanes=B)
        if entry == "masked_argmin_batch":
            return minscan.argmin_batch_resources(n, lanes=B, aligned=n % 4 == 0)
        return lw_step.kernel_resources(method, n, entry, lanes=B)

    out = {}
    for entry, shapes in RESOURCE_SHAPES.items():
        if entry in plans and plans[entry] is None:
            continue
        methods = ("-",) if entry == "masked_argmin_batch" else METHODS
        for B, n in shapes:
            plan = plans[entry](B, n, sms) if entry in plans else None
            key = f"B={B} n={n}" + (f" {plan}" if plan is not None else "")
            out.setdefault(entry, {})[key] = {
                m: list(resources(m, n, entry, B).values()) for m in methods}
    return out


def phase_batch_kernels(torch, B: int, n: int, reps: int, l2_rate: float,
                        kernels=BATCH_ALL) -> dict:
    """The batch-grid forms named in ``kernels`` (B1 "argmin", B2's merge
    entry "merge", B3's lazy merge "lazy") on a mid-run bucket of B lanes:
    each against its plain twin and against one single-problem launch a
    lane (per merge entry: ``reps`` lockstep merges against each lane's own
    merges), bit for bit; then timed as phase 2 times the single-problem
    entries, with their bounds summed over the lanes."""
    out, method = {}, "complete"
    D, alive, sizes, limit, cand = batch_mid_state(torch, B, n, reps, seed=11)
    live = alive.sum(1).to(torch.float64)
    resident = 4 * B * n * n
    if "argmin" in kernels:
        out["masked_argmin_batch"] = batch_argmin_row(torch, D, alive, live, resident, l2_rate)
    if "merge" in kernels:
        out["lw_merge_batch/complete"] = batch_merge_row(torch, method, D, alive, sizes, limit,
                                                         cand, live, reps, resident, l2_rate)
    if "lazy" in kernels:
        out["lazy_merge_batch/complete"] = batch_lazy_row(torch, method, D, alive, sizes, limit,
                                                          live, reps, resident, l2_rate)
    return out


def argmin_plan(torch, B: int, n: int):
    """The plan B1's batch form takes over B lanes of n slots (None for a
    tree whose batch form has no plan)."""
    from repro_torch.kernels import minscan

    plan_fn = getattr(minscan, "argmin_batch_plan", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return None if plan_fn is None else plan_fn(B, n, sms)


def batch_argmin_row(torch, D, alive, live, resident: float, l2_rate: float) -> dict:
    """B1's batch form against its plain twin and its single entry, bit for
    bit, timed; with the plan it took, the matrix bytes it reads
    (:func:`argmin_read_bytes`) and its rate on them."""
    from repro_torch.kernels import minscan

    B, n = alive.shape
    plan = argmin_plan(torch, B, n)
    v, flat = minscan.masked_argmin_batch(D, alive)
    vp, flatp = minscan.masked_argmin_batch_plain(D, alive)
    if not (torch.equal(v, vp) and torch.equal(flat, flatp)):
        raise AssertionError(f"masked_argmin_batch B={B} n={n}: kernel differs from plain")
    single = [minscan.masked_argmin(D[b], alive[b]) for b in range(B)]
    if not (torch.equal(torch.stack([s[0] for s in single]), v)
            and torch.equal(torch.stack([s[1] for s in single]), flat)):
        raise AssertionError(f"masked_argmin_batch B={B} n={n}: differs from single launches")
    ms = time_ms(torch, lambda: minscan.masked_argmin_batch(D, alive))
    read = argmin_read_bytes(torch, alive, plan)
    return dict(
        B=B, n=n, path=str(plan) if plan else "row blocks and a reduction pass",
        live_mean=float(live.mean()), max_abs_err=float((v - vp).abs().nan_to_num().max()),
        bit_equal=True, single_checked=B, ms=ms,
        plain_ms=time_ms(torch, lambda: minscan.masked_argmin_batch_plain(D, alive)),
        library_ms=None, read_bytes=read, read_bytes_per_s=read / (ms * 1e-3),
        **bound(torch, float((4 * live * live + n + 12).sum()), float((live * live).sum()),
                resident, l2_rate))


def phase_argmin_seed(torch, B: int, n: int, ragged: bool, l2_rate: float) -> dict:
    """B1's batch form on a seed state (:func:`batch_seed_state`), as
    :func:`batch_argmin_row` holds and times it."""
    D, alive = batch_seed_state(torch, B, n, ragged, seed=13)
    return dict(batch_argmin_row(torch, D, alive, alive.sum(1).to(torch.float64), 4 * B * n * n,
                                 l2_rate), ragged=ragged)


def batch_merge_row(torch, method: str, D, alive, sizes, limit, cand, live, reps: int,
                    resident: float, l2_rate: float) -> dict:
    """B2's batch form over ``reps`` lockstep merges against its plain twin
    and its single merge entry, bit for bit, timed; with the ownership path
    it took and the rate at which it read the live rows."""
    from repro_torch.kernels import lw_step

    B, n = alive.shape
    b0 = lw_step.merge_batch_buffers(D, alive, sizes, torch.zeros((B, n, 4), device="cuda"),
                                     cand, 0, limit)
    bk, bp = (lw_step.MergeBatchBuffers(*(t.clone() for t in b0)) for _ in range(2))
    for _ in range(reps):
        lw_step.lw_merge_batch(method, bk)
        lw_step.lw_merge_batch_plain(method, bp)
    torch.cuda.synchronize()
    check_batch_buffers(torch, bk, bp, f"lw_merge_batch B={B} n={n}", skip=("sync",))
    if not torch.equal(bk.sync, b0.sync):
        raise AssertionError(f"lw_merge_batch B={B} n={n}: keys/tickets left at {bk.sync}")
    check_against_single(
        torch, bk, lambda b: lw_step.merge_buffers(
            b0.D[b].clone(), b0.alive[b].clone(), b0.sizes[b].clone(),
            torch.zeros((n, 4), device="cuda"), (cand[0][b], cand[1][b], cand[2][b]), 0),
        lw_step.lw_merge, method, reps,
        ("D", "alive", "bits", "sizes", "merges", "cand", "dmin", "rmin", "rarg"),
        f"lw_merge_batch B={B} n={n}")
    err = float((bk.D - bp.D).abs().max())
    del bp
    ms = time_merges(torch, lambda b: lw_step.lw_merge_batch(method, b), b0, bk, reps=reps)
    plain_ms = time_merges(torch, lambda b: lw_step.lw_merge_batch_plain(method, b), b0, bk,
                           reps=reps)
    live_mean = live - 1 - (reps - 1) / 2          # a timed merge kills one slot a lane
    read = float((4 * live_mean * n).sum())        # each lane's live rows, read whole
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(
        B=B, n=n, path=str(lw_step.merge_batch_plan(B, n, sms)),
        live_mean=float(live_mean.mean()), max_abs_err=err, bit_equal=True,
        single_checked=B, merges_checked=reps, ms=ms, plain_ms=plain_ms, library_ms=None,
        read_bytes=read, read_bytes_per_s=read / (ms * 1e-3),
        **bound(torch, float((4 * live_mean ** 2 + 8 * live_mean + 17 * n).sum()),
                float((2 * live_mean ** 2 + 12 * n).sum()), resident, l2_rate))


def batch_lazy_row(torch, method: str, D, alive, sizes, limit, live, reps: int,
                   resident: float, l2_rate: float) -> dict:
    """B3's batch lazy merge against its plain twin and the single lazy
    merge, bit for bit, timed; with the plan it took, its kernel's
    registers, local bytes and blocks an SM, and the bytes a merge must move
    at the rate it reached."""
    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch
    from repro_torch.kernels import lw_update

    B, n = alive.shape
    live_mean = live - 1 - (reps - 1) / 2
    rmin, rarg = masked_row_mins_batch(D, alive)
    lcand = cached_cand_batch(alive, rmin, rarg)
    b0 = lw_update.lazy_batch_buffers(D, alive, sizes, torch.zeros((B, n, 4), device="cuda"),
                                      lcand, (rmin, rarg), 0, limit)
    bk, bp = (lw_update.LazyBatchBuffers(*(t.clone() for t in b0)) for _ in range(2))
    for _ in range(reps):
        lw_update.lazy_merge_batch(method, bk)
        lw_update.lazy_merge_batch_plain(method, bp)
    torch.cuda.synchronize()
    check_batch_buffers(torch, bk, bp, f"lazy_merge_batch B={B} n={n}")
    check_against_single(
        torch, bk, lambda b: lw_update.lazy_buffers(
            b0.D[b].clone(), b0.alive[b].clone(), b0.sizes[b].clone(),
            torch.zeros((n, 4), device="cuda"), (lcand[0][b], lcand[1][b], lcand[2][b]),
            (b0.rmin[b].clone(), b0.rarg[b].clone()), 0),
        lw_update.lazy_merge, method, reps,
        ("D", "alive", "sizes", "merges", "cand", "dmin", "rmin", "rarg", "rescanned"),
        f"lazy_merge_batch B={B} n={n}")
    err = float((bk.rmin - bp.rmin).abs().nan_to_num().max())
    stale = (bk.rescanned - b0.rescanned).to(torch.float64) / reps     # a lane's rows a merge
    del bp
    changed = lazy_cache_changes(torch, method, b0, lw_update._lazy_update_batch_plain,
                                 lw_update.lazy_rescan_batch_plain, reps)
    ms = time_merges(torch, lambda b: lw_update.lazy_merge_batch(method, b), b0, bk, reps=reps)
    plain_ms = time_merges(torch, lambda b: lw_update.lazy_merge_batch_plain(method, b), b0, bk,
                           reps=reps)
    n_bytes = float(lazy_merge_bytes(n, stale, changed).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(
        B=B, n=n, path=str(lw_update.lazy_batch_plan(B, n, sms)),
        live_mean=float(live_mean.mean()), max_abs_err=err, bit_equal=True, single_checked=B,
        merges_checked=reps, stale_rows_per_merge=float(stale.mean()),
        changed_entries_per_merge=float(changed.mean()), ms=ms, plain_ms=plain_ms,
        library_ms=None, bytes_per_s=n_bytes / (ms * 1e-3),
        **lw_update.lazy_batch_resources(method, n, lanes=B),
        **bound(torch, n_bytes, float((12 * live_mean + 2 * stale * n).sum()), resident, l2_rate))


def lw_update_bytes(method: str, n: int, live: int) -> int:
    """The bytes one row update must move for ``method`` with ``live`` kept
    lanes of ``n``: the bool mask read and the row written on every lane;
    rows i and j (and, for ward, the sizes) read on the kept lanes only; and
    of the merge scalars only those the method's coefficients use (D(i,j)
    always, n_i and n_j for the size-weighted methods).  About ten
    operations a kept lane."""
    per_kept = 12 if method == "ward" else 8
    scalars = 12 if method in ("average", "centroid", "ward") else 4
    return 5 * n + per_kept * live + scalars


def phase_row(torch, m: int, d: int, l2_rate: float) -> dict:
    """The row kernel against its plain version at (m, d), with the time
    of the one PyTorch call that gives the same row (``cdist``, which also
    takes the square root), and each one's host time to enqueue a call."""
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import pairwise

    Y = torch.as_tensor(gaussian_mixture(seed=3, n=m, dim=d, return_labels=False),
                        dtype=torch.float32, device="cuda")
    x = Y[m // 3]
    got = pairwise.row_sq_euclidean(x, Y)
    want = pairwise.row_sq_euclidean_plain(x, Y)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise AssertionError(f"row_sq_euclidean m={m} d={d}: kernel differs from plain")
    # read Y and x once, write the row; a subtract, a multiply and an add an element
    n_bytes = 4 * (m * d + m + d)
    return dict(m=m, d=d, max_abs_err=float((got - want).abs().max()),
                ms=time_ms(torch, lambda: pairwise.row_sq_euclidean(x, Y)),
                plain_ms=time_ms(torch, lambda: pairwise.row_sq_euclidean_plain(x, Y)),
                library_ms=time_ms(torch, lambda: torch.cdist(x[None], Y)),
                host_us=host_us(torch, lambda: pairwise.row_sq_euclidean(x, Y)),
                plain_host_us=host_us(torch, lambda: pairwise.row_sq_euclidean_plain(x, Y)),
                **bound(torch, n_bytes, 3 * m * d, n_bytes, l2_rate))


def trip_bytes(m: int, d: int) -> float:
    """The bytes one chain trip must move at (m, d): the summaries read
    once, ward's one per-slot scalar (the sizes; u for average and
    weighted), the liveness bitmask, and O(d) for the tip and a merge's
    two rows read and one written."""
    return 4 * m * d + 4 * m + m / 8 + 16 * d


def phase_trip(torch, m: int, d: int, l2_rate: float) -> dict:
    """B5's trip entry, the matrix-free chain's main path, against its
    plain twin on the card: TRIP_CHECKS trips from the first state of a
    ward run on one mixture's points, the same decisions (every count,
    slot, size and liveness equal) and the summaries within the row's
    float error.  Then timed from the state those trips reach: MERGE_REPS
    trips launched one by one, and one graph replay of CHAIN_GRAPH_TRIPS
    trips; with ``cdist``'s row as the library call."""
    from repro_torch.core.nnchain import CHAIN_GRAPH_TRIPS
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import pairwise

    X = torch.as_tensor(gaussian_mixture(seed=3, n=m, dim=d, return_labels=False),
                        dtype=torch.float32, device="cuda")

    def fresh():
        return pairwise.chain_buffers(X.clone(), torch.zeros(m, device="cuda"),
                                      torch.ones(m, dtype=torch.bool, device="cuda"),
                                      torch.ones(m, device="cuda"), m - 1)

    bk, bp = fresh(), fresh()
    for _ in range(TRIP_CHECKS):
        pairwise.chain_trip("ward", bk)
        pairwise.chain_trip_plain("ward", bp)
    torch.cuda.synchronize()
    for name in ("alive", "bits", "sizes", "chain", "count"):
        if not torch.equal(getattr(bk, name), getattr(bp, name)):
            raise AssertionError(f"chain_trip m={m} d={d}: {name} differs from the plain twin")
    if not torch.equal(bk.merges[:, [0, 1, 3]], bp.merges[:, [0, 1, 3]]):
        raise AssertionError(f"chain_trip m={m} d={d}: merge slots differ from the plain twin")
    if bk.sync[:2].tolist() != [-1, 0]:
        raise AssertionError(f"chain_trip m={m} d={d}: the kernel left its key/ticket at {bk.sync}")
    err = 0.0
    for a, b in ((bk.W, bp.W), (bk.u, bp.u), (bk.merges, bp.merges)):
        if not torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise AssertionError(f"chain_trip m={m} d={d}: summaries or heights differ "
                                 "from the plain twin")
        err = max(err, float((a - b).abs().max()))
    length, merged, _, _ = bk.count.tolist()
    b0 = [t.clone() for t in bk[:9]]
    ms = time_merges(torch, lambda _: pairwise.chain_trip("ward", bk), b0, bk[:9])
    plain_ms = time_merges(torch, lambda _: pairwise.chain_trip_plain("ward", bk), b0, bk[:9])
    for dst, src in zip(bk[:9], b0):
        dst.copy_(src)
    graph = pairwise.TripGraph("ward", bk, CHAIN_GRAPH_TRIPS)
    replay_ms = time_merges(torch, lambda _: graph.replay(), b0, bk[:9], reps=1)
    x = X[m // 3]
    n_bytes = trip_bytes(m, d)
    return dict(m=m, d=d, checked_trips=TRIP_CHECKS, merges_in_check=merged, chain_length=length,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                graph_ms_per_trip=replay_ms / CHAIN_GRAPH_TRIPS,
                library_ms=time_ms(torch, lambda: torch.cdist(x[None], X)),
                host_us=host_us(torch, lambda: pairwise.chain_trip("ward", bk)),
                **bound(torch, n_bytes, 3 * m * d + 8 * m, n_bytes, l2_rate))


def pairwise_atol(X, Y) -> float:
    """The pairwise kernel's absolute tolerance: PAIRWISE_ATOL_SCALE times
    the largest ``|x|^2 + |y|^2``, the scale of the Gram form's
    cancellation (its relative tolerance is PAIRWISE_RTOL)."""
    return PAIRWISE_ATOL_SCALE * (float((X * X).sum(1).max()) + float((Y * Y).sum(1).max()))


def phase_pairwise(torch, n: int, m: int, d: int, l2_rate: float) -> dict:
    """The pairwise kernel against its plain version at (n, m, d) on points
    of one mixture, with the time of the one PyTorch call that gives the
    same matrix (``cdist``, which also takes the square root) and each
    one's host time to enqueue a call."""
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import pairwise

    P = torch.as_tensor(gaussian_mixture(seed=4, n=n + m, dim=d, return_labels=False),
                        device="cuda")
    X, Y = P[:n], P[n:]
    got = pairwise.pairwise_sq_euclidean(X, Y)
    want = pairwise.pairwise_sq_euclidean_plain(X, Y)
    torch.cuda.synchronize()
    atol = pairwise_atol(X, Y)
    if not torch.allclose(got, want, rtol=PAIRWISE_RTOL, atol=atol):
        raise AssertionError(f"pairwise_sq_euclidean {(n, m, d)}: kernel differs from plain")
    err = float((got - want).abs().max())
    del got, want
    # read X and Y once, write the matrix; a multiply and an add per element
    # of the product (the norms and the epilogue are O(n m + (n + m) d) more)
    n_bytes = 4 * (n * d + m * d + n * m)
    return dict(n=n, m=m, d=d, max_abs_err=err, rtol=PAIRWISE_RTOL, atol=atol,
                ms=time_ms(torch, lambda: pairwise.pairwise_sq_euclidean(X, Y), reps=5),
                plain_ms=time_ms(torch, lambda: pairwise.pairwise_sq_euclidean_plain(X, Y), reps=5),
                library_ms=time_ms(torch, lambda: torch.cdist(X, Y), reps=5),
                host_us=host_us(torch, lambda: pairwise.pairwise_sq_euclidean(X, Y)),
                plain_host_us=host_us(torch, lambda: pairwise.pairwise_sq_euclidean_plain(X, Y)),
                **bound(torch, n_bytes, 2 * n * m * d, n_bytes, l2_rate))


def plain_engine_merges(torch, X, method: str, n_steps: int):
    """The same problem through the engine with the plain step functions."""
    from repro_torch.core import engine
    from repro_torch.core.api import build_distance_matrix
    from repro_torch.kernels import lw_step, minscan

    D = engine.symmetrize(build_distance_matrix(X, "euclidean"))
    n = D.shape[0]
    ops = engine._fused_ops(method, n, minscan.masked_argmin_plain, lw_step.lw_merge_plain)
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    state = engine.run_merge_loop(ops, engine._init_state(D, alive, n_steps), n_steps)
    return state.merges.cpu().numpy()


def reset_counters() -> None:
    from repro_torch.kernels import lw_step, lw_update, minscan, pairwise

    minscan.masked_argmin.launches = minscan.masked_argmin_batch.launches = 0
    lw_step.lw_step.launches = 0
    lw_step.lw_merge.launches = lw_step.MergeGraph.replays = 0
    lw_step.lw_merge_batch.launches = 0
    lw_update.lw_update.launches = 0
    lw_update.lazy_merge.launches = lw_update.lazy_rescan.launches = 0
    lw_update.lazy_merge_batch.launches = 0
    pairwise.row_sq_euclidean.launches = 0
    pairwise.chain_trip.launches = pairwise.TripGraph.replays = 0
    pairwise.pairwise_sq_euclidean.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels import lw_step, lw_update, minscan, pairwise

    return {"masked_argmin": minscan.masked_argmin.launches, "lw_step": lw_step.lw_step.launches,
            "lw_merge": lw_step.lw_merge.launches, "lw_update": lw_update.lw_update.launches,
            "lazy_merge": lw_update.lazy_merge.launches,
            "lazy_rescan": lw_update.lazy_rescan.launches,
            "masked_argmin_batch": minscan.masked_argmin_batch.launches,
            "lw_merge_batch": lw_step.lw_merge_batch.launches,
            "lazy_merge_batch": lw_update.lazy_merge_batch.launches,
            "row_sq_euclidean": pairwise.row_sq_euclidean.launches,
            "chain_trip": pairwise.chain_trip.launches,
            "pairwise_sq_euclidean": pairwise.pairwise_sq_euclidean.launches}


def check_trips(stats: dict, iters: int | None, what: str) -> None:
    """The resident chain's launches in a run that :func:`timed` read: only
    trip launches, all from whole graph replays, and (given the trips
    made) at least the trips and less than one replay more."""
    from repro_torch.core.nnchain import CHAIN_GRAPH_TRIPS

    launches = stats["launches"]["chain_trip"]
    check_launches(stats["launches"], {"chain_trip": launches}, what)
    if not launches or launches != stats["trip_replays"] * CHAIN_GRAPH_TRIPS:
        raise AssertionError(f"{what}: {launches} trip launches from {stats['trip_replays']} "
                             f"replays of {CHAIN_GRAPH_TRIPS}")
    if iters is not None and not iters <= launches < iters + CHAIN_GRAPH_TRIPS:
        raise AssertionError(f"{what}: {launches} trip launches for {iters} trips")


def check_launches(got: dict, want: dict, what: str) -> None:
    if got != {**NO_LAUNCHES, **want}:
        raise AssertionError(f"{what}: launches {got}, want {want} and no others")


def lw_plan(backend: str, n: int, n_steps: int, compaction=True) -> tuple:
    """The compaction stages ``((size, steps), ...)`` that a ``cluster()``
    LW run on ``backend`` follows (one stage when it runs unstaged)."""
    from repro_torch.core import engine

    floor = engine.KERNEL_MIN_STAGE if backend == "kernel" else engine.MIN_STAGE_N
    if engine.resolve_compaction(compaction, n, n_steps, min_stage=floor):
        return engine.plan_stages(n, n_steps, min_stage=floor)
    return ((n, n_steps),)


def stage_trips(plan: tuple, stop: int | None = None) -> list:
    """The merges each stage launches: all its steps, but in the stage that
    holds merge ``stop`` (the first above a threshold) up to the end of
    its chunk of THRESHOLD_CHECK_TRIPS; later stages run none."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS as k

    trips, start = [], 0
    for _, steps in plan:
        if stop is not None and stop < start + steps:
            return trips + [min(((stop - start) // k + 1) * k, steps)]
        trips.append(steps)
        start += steps
    return trips


def check_lw_run(stats: dict, backend: str, variant: str, n: int, what: str,
                 compaction=True, stop: int | None = None) -> None:
    """A ``cluster()`` LW run's launches and graph replays against its
    stage plan: the serial backend launches no kernel; on the kernel
    backend each stage run seeds once (B1; ``lazy``: the masked row minima
    in torch) and each merge is one B2 merge launch (``lazy``: one B3 lazy
    merge and one rescan), each stage replaying whole chunks of
    THRESHOLD_CHECK_TRIPS from its own graph.  Adds the plan to ``stats``."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS

    plan = lw_plan(backend, n, n - 1, compaction)
    trips = stage_trips(plan, stop)
    merges, replays = sum(trips), sum(t // THRESHOLD_CHECK_TRIPS for t in trips)
    if backend == "serial":
        want, replays = {}, 0
    elif variant == "lazy":
        want = {"lazy_merge": merges, "lazy_rescan": merges}
    else:
        want = {"masked_argmin": len(trips), "lw_merge": merges}
    check_launches(stats["launches"], want, what)
    if stats["merge_replays"] != replays:
        raise AssertionError(f"{what}: {stats['merge_replays']} graph replays, want {replays} "
                             f"(stage trips {trips})")
    stats.update(stages=len(plan), stage_sizes=[size for size, _ in plan], stage_trips=trips)


def check_bit_equal(np, got, want, what: str) -> None:
    """A staged run against the same run unstaged: every merge, bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).any(axis=1)) if got.shape == want.shape else []
        raise AssertionError(f"{what}: merges differ, first at step {bad[:1]}")


#: What a phase line reports of each of its LW runs, staged and unstaged.
LW_RUN_KEYS = ("wall_s", "warm_wall_s", "device_busy_s", "idle_share", "warm_idle_share",
               "peak_gib", "stages", "stage_sizes", "stage_trips", "launches", "merge_replays")


def lw_run_numbers(stats: dict) -> dict:
    return {k: stats[k] for k in LW_RUN_KEYS if k in stats}


def timed(torch, call):
    """One run of ``call`` with the counters set to 0 just before it: wall
    seconds, peak memory, launches, and the LW loop's and the chain's graph
    replays."""
    from repro_torch.kernels.lw_step import MergeGraph
    from repro_torch.kernels.pairwise import TripGraph

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, dict(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     launches=read_counters(), trip_replays=TripGraph.replays,
                     merge_replays=MergeGraph.replays)


def run_cluster(torch, X, **knobs):
    """The LW loop on the kernel backend, as phases 3 and 4 drive it:
    :func:`timed`, then the device's busy time over a second run of the
    same call, then a third, unprofiled run's wall (``warm_wall_s``: the
    first call of a size also pays one-time costs, such as the first graph
    capture of the process)."""
    from repro_torch.core import cluster

    def call():
        return cluster(X, "complete", algorithm="lw", backend="kernel", keep_inputs=False,
                       **knobs)

    res, stats = timed(torch, call)
    stats.update(device_busy(torch, call, stats["wall_s"], stats["launches"])[1])
    warm = timed(torch, call)[1]
    check_launches(warm["launches"], stats["launches"], "warm LW run")
    stats.update(warm_wall_s=warm["wall_s"],
                 warm_idle_share=1 - stats["device_busy_s"] / warm["wall_s"])
    return res, stats


def per_step(stats: dict, steps: int, unit: str) -> dict:
    """A run's time per step (a chain trip, a lazy merge): each step reads
    one small tensor back, so the host waits for the card once a step; the
    host's share is the wall the device spends idle."""
    wall, busy = stats["wall_s"], stats["device_busy_s"]
    return {f"{unit}s": steps, f"ms_per_{unit}": wall / steps * 1e3,
            f"device_ms_per_{unit}": busy / steps * 1e3,
            f"host_ms_per_{unit}": (wall - busy) / steps * 1e3}


def device_busy(torch, call, wall_s: float, launches: dict):
    """Device busy seconds over a whole run of ``call``, summed from the
    profiler's records of every kernel, copy and fill on the card (one
    stream, so they do not overlap); the idle share is the rest of the
    unprofiled run's wall time.  The profiler must have seen the launches
    that the counters saw: none more, and none fewer but in a run of
    PROFILER_MISS_MIN launches or more, where it may miss
    PROFILER_MISS_SHARE of them (CUPTI dropped a few of ~98k records;
    misses are reported as ``profiler_missed``).  A profiler that saw
    fewer runs the call again, profiled, up to PROFILER_TRIES times in
    all (CUPTI drops whole sessions' records at random: ``run_child``),
    with the counters set to 0 before each run; ``profiler_tries`` says
    how many it took.  ``launches`` None takes the counters as each
    profiled run leaves them (a service run, whose batching and so its
    launches vary from run to run), and ``wall_s`` None the profiled run's
    wall.  Returns what the last run of ``call`` returned, and the
    numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    expected = launches
    for tries in range(1, PROFILER_TRIES + 1):
        reset_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            profiled_wall = time.perf_counter() - t0
        launches = read_counters() if expected is None else expected
        busy_ns = 0
        kernel_ns, kernel_n = dict.fromkeys(KERNEL_SYMBOLS, 0), dict.fromkeys(KERNEL_SYMBOLS, 0)
        # the raw records: building prof.events() costs ~70 us a record
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            ns, name = e.duration_ns(), e.name()
            busy_ns += ns
            for kernel, symbols in KERNEL_SYMBOLS.items():
                if any(sym in name for sym in symbols):
                    kernel_ns[kernel] += ns
                    kernel_n[kernel] += symbols[0] in name
        missed = {k: launches[k] - kernel_n[k] for k in kernel_n}
        allowed = {k: PROFILER_MISS_SHARE * n if n >= PROFILER_MISS_MIN else 0
                   for k, n in launches.items()}
        seen = f"the profiler saw launches {kernel_n}, the counters {launches}"
        if any(m < 0 for m in missed.values()):        # more than launched: never retried
            raise AssertionError(seen)
        if all(m <= allowed[k] for k, m in missed.items()):
            break
        if tries == PROFILER_TRIES:
            raise AssertionError(seen)
        print(f"{seen}: profiling the run again", flush=True)
    busy_s = busy_ns / 1e9
    return res, dict(device_busy_s=busy_s, idle_share=1 - busy_s / (wall_s or profiled_wall),
                     profiled_wall_s=profiled_wall, profiler_missed=missed,
                     profiler_tries=tries,
                     kernel_ms_mean={k: kernel_ns[k] / 1e6 / max(kernel_n[k], 1)
                                     for k in kernel_ns},
                     kernel_busy_share={k: kernel_ns[k] / busy_ns for k in kernel_ns})


def host_device_split(torch, X) -> dict:
    """Host and device ms per merge over SPLIT_REPLAYS graph replays of
    THRESHOLD_CHECK_TRIPS merges each, after the first replay (which
    captures the graph).

    A sleep kernel holds the stream while the host enqueues the replays, so
    the host time has no waits in it and the device time no gaps.  A loop
    that synced with the card would wait out the sleep: the host time
    staying under the sleep shows that it does not.
    """
    from repro_torch.core import engine
    from repro_torch.core.api import build_distance_matrix

    D = engine.symmetrize(build_distance_matrix(X, "euclidean"))
    n = D.shape[0]
    k = engine.THRESHOLD_CHECK_TRIPS
    ops = engine.kernel_ops("complete", n, device="cuda")
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    state = ops.replay(ops.seed(engine._init_state(D, alive, (SPLIT_REPLAYS + 1) * k)))
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    held.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(SPLIT_REPLAYS):
        state = ops.replay(state)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    sleep_ms = held.elapsed_time(start)
    if host_ms >= sleep_ms:
        raise AssertionError(f"enqueueing {SPLIT_REPLAYS} replays took {host_ms:.1f} ms, "
                             f"longer than the {sleep_ms:.1f} ms the stream was held")
    merges = SPLIT_REPLAYS * k
    return dict(split_merges=merges, host_ms_per_merge=host_ms / merges,
                device_ms_per_merge=start.elapsed_time(end) / merges, stream_held_ms=sleep_ms)


def stage_floor_walls(torch, X) -> dict:
    """Phase 3's stage floor: the walls of the kernel backend's LW loop
    alone (``engine.run_kernel``, complete) on phase 3's matrix, unstaged
    and with the kernel plan's floor (``KERNEL_MIN_STAGE``) at each of
    STAGE_FLOORS, FLOOR_REPS runs each in turns after a round that warms
    up; the median and the range of each, with its stages.  Every run
    captures its stages' graphs anew, as every ``cluster()`` call does."""
    from repro_torch.core import engine
    from repro_torch.core.api import build_distance_matrix

    D0 = engine.symmetrize(build_distance_matrix(X, "euclidean"))
    n = D0.shape[0]
    floor0, walls = engine.KERNEL_MIN_STAGE, {f: [] for f in STAGE_FLOORS}
    try:
        for _ in range(FLOOR_REPS + 1):
            for floor in STAGE_FLOORS:
                engine.KERNEL_MIN_STAGE = floor or floor0
                D, alive = D0.clone(), torch.ones(n, dtype=torch.bool, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.run_kernel(D, alive, method="complete", n_steps=n - 1,
                                  compaction=floor is not None)
                torch.cuda.synchronize()
                walls[floor].append(time.perf_counter() - t0)
    finally:
        engine.KERNEL_MIN_STAGE = floor0
    return {str(floor or "unstaged"): dict(
                stages=len(engine.plan_stages(n, n - 1, min_stage=floor)) if floor else 1,
                wall_s=statistics.median(w[1:]), wall_range_s=[min(w[1:]), max(w[1:])])
            for floor, w in walls.items()}


def phase_paper(torch, np) -> dict:
    import scipy.cluster.hierarchy as sch

    from repro_torch.core.dendrogram import validate_merges
    from repro_torch.data.synthetic import gaussian_mixture

    n = PAPER_N
    X = gaussian_mixture(seed=0, n=n, dim=DIM, return_labels=False)
    res, stats = run_cluster(torch, X)
    check_lw_run(stats, "kernel", "baseline", n, "paper run")
    off_res, off = run_cluster(torch, X, compaction=False)
    check_lw_run(off, "kernel", "baseline", n, "paper run, unstaged", compaction=False)
    check_bit_equal(np, res.merges, off_res.merges, "paper run, staged vs unstaged")
    stats["unstaged"] = lw_run_numbers(off)
    stats["stage_floor"] = stage_floor_walls(torch, X)
    validate_merges(res.merges, n=n)
    check_merges(np, res.merges, plain_engine_merges(torch, X, "complete", n - 1),
                 "paper run vs plain engine")
    want = np.sort(sch.linkage(X.astype(np.float64), "complete")[:, 2])
    np.testing.assert_allclose(np.sort(res.heights()), want, rtol=RTOL, err_msg="vs scipy")
    stats.update(host_device_split(torch, X))

    # the default knobs: the dense NN chain, the same dendrogram
    from repro_torch.core import cluster

    chain, chain_stats = timed(torch, lambda: cluster(X, "complete"))
    stats["chain_wall_s"] = chain_stats["wall_s"]
    check_launches(chain_stats["launches"], {}, "paper chain run")
    if (chain.algorithm, chain.backend) != ("nnchain", "serial"):
        raise AssertionError(f"default knobs ran {chain.algorithm}/{chain.backend}, want nnchain")
    check_equivalent(np, chain.merges, res.merges, n, "paper chain vs LW loop")
    # kept for phase 10's exemplar index, on the host: out of later peaks
    chain.distances = chain.distances.cpu()
    return X, res.merges, chain, stats


def phase_full(torch, np) -> dict:
    from repro_torch.core.dendrogram import is_monotone, validate_merges
    from repro_torch.data.synthetic import gaussian_mixture

    n = FULL_N
    X = gaussian_mixture(seed=0, n=n, dim=DIM, return_labels=False)
    res, stats = run_cluster(torch, X)
    check_lw_run(stats, "kernel", "baseline", n, "full run")
    off_res, off = run_cluster(torch, X, compaction=False)
    check_lw_run(off, "kernel", "baseline", n, "full run, unstaged", compaction=False)
    check_bit_equal(np, res.merges, off_res.merges, "full run, staged vs unstaged")
    stats["unstaged"] = lw_run_numbers(off)
    del off_res
    validate_merges(res.merges, n=n)
    if not is_monotone(res.merges):
        raise AssertionError("complete-linkage heights are not monotone")
    check_merges(np, res.merges[:PREFIX], plain_engine_merges(torch, X, "complete", PREFIX),
                 f"first {PREFIX} merges vs plain engine")

    stats.update(host_device_split(torch, X))
    return X, res.merges, stats


def phase_dense_chain(torch, np, X):
    """``cluster(X, "complete")`` with default knobs: the dense chain, held
    against the LW loop on the kernel backend on the same points.  Returns
    the LW merges and the chain's numbers."""
    from repro_torch.core import cluster
    from repro_torch.core.api import build_distance_matrix
    from repro_torch.core.dendrogram import validate_merges
    from repro_torch.core.nnchain import nn_chain

    n = X.shape[0]
    lw, lw_stats = timed(torch, lambda: cluster(X, "complete", algorithm="lw", backend="kernel",
                                                keep_inputs=False))
    check_lw_run(lw_stats, "kernel", "baseline", n, f"LW run n={n}")
    lw_merges = lw.merges
    res, stats = timed(torch, lambda: cluster(X, "complete"))
    check_launches(stats["launches"], {}, "dense chain run")
    if (res.algorithm, res.backend) != ("nnchain", "serial") or res.distances is None:
        raise AssertionError(f"default knobs ran {res.algorithm}/{res.backend}, want the dense chain")
    validate_merges(res.merges, n=n)
    check_equivalent(np, res.merges, lw_merges, n, f"dense chain vs LW loop n={n}")
    del res
    # busy time and trips: the chain alone, profiled, on the same matrix
    # (the distance build it leaves out is one matrix product)
    D = build_distance_matrix(X, "euclidean")
    chain, busy = device_busy(torch, lambda: nn_chain(D, "complete"), stats["wall_s"], NO_LAUNCHES)
    if chain.n_merges != n - 1:
        raise AssertionError(f"dense chain recorded {chain.n_merges} merges, want {n - 1}")
    stats.update(busy)
    stats.update(per_step(stats, chain.iters, "trip"))
    stats["lw_wall_s"] = lw_stats["wall_s"]
    return lw_merges, stats


def points_chain(torch, X, method: str, row_sq):
    """The matrix-free chain loop on the card, its row built by ``row_sq``."""
    from repro_torch.core import nnchain

    W = torch.as_tensor(X, dtype=torch.float32, device="cuda").clone()
    n = W.shape[0]
    state = nnchain._init_state((W, torch.zeros(n, device="cuda")), n, "cuda")
    ops = nnchain._points_nnchain_ops(method, row_sq)
    return nnchain._chain_loop(ops, state, n - 1)


def phase_points_chain(torch, np) -> dict:
    """``cluster(X, "ward")`` with default knobs at n = 32768, d = 128: the
    resident chain, then the host-driven loop with the plain row."""
    from repro_torch.core import cluster
    from repro_torch.core.dendrogram import canonical_order, is_monotone, validate_merges
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels.pairwise import row_sq_euclidean_plain

    n = CHAIN_N
    X = gaussian_mixture(seed=0, n=n, dim=CHAIN_DIM, return_labels=False)
    res, stats = timed(torch, lambda: cluster(X, "ward"))
    if (res.algorithm, res.backend, res.distances) != ("nnchain", "serial", None):
        raise AssertionError(f"default knobs ran {res.algorithm}/{res.backend} with distances "
                             f"{type(res.distances)}, want the matrix-free chain")
    if stats["peak_gib"] >= PEAK_LIMIT_GIB:
        raise AssertionError(f"matrix-free peak memory {stats['peak_gib']:.4f} GiB, "
                             f"limit {PEAK_LIMIT_GIB} GiB")
    validate_merges(res.merges, n=n)
    if not is_monotone(res.merges):
        raise AssertionError("ward heights are not monotone")

    # busy time and trips: the chain alone, profiled in a process of its
    # own (cluster() adds the upload of the points and the canonical order
    # on the host); the profiler must see every launch
    busy = run_child(torch, PROFILE_CHAIN_FLAG, dict(wall_s=stats["wall_s"],
                                                    launches=stats["launches"]))
    check_trips(stats, busy["iters"], "matrix-free cluster run")
    stats.update({k: busy[k] for k in ("device_busy_s", "idle_share", "profiled_wall_s",
                                       "profiler_missed", "profiler_tries", "kernel_ms_mean",
                                       "kernel_busy_share")})
    stats.update(per_step(stats, busy["iters"], "trip"))

    # the host-driven loop with the plain row: the dendrogram reference and
    # the wall before the resident chain
    plain, s = timed(torch, lambda: points_chain(torch, X, "ward", row_sq_euclidean_plain))
    check_launches(s["launches"], {}, "plain-row chain loop")
    stats.update(host_loop_wall_s=s["wall_s"], host_loop_trips=plain.iters)
    check_equivalent(np, res.merges, canonical_order(plain.merges.cpu().numpy(), n=n), n,
                     f"matrix-free chain vs plain-row chain n={n}")
    return res, stats


def phase_cross(torch, np, n: int, d: int) -> dict:
    """At (n, d): the matrix-free ward chain against the LW loop on the
    kernel backend (Gram-form matrix) — two engines, one dendrogram."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=0, n=n, dim=d, return_labels=False)
    chain, chain_stats = timed(torch, lambda: cluster(X, "ward", matrix_free=True))
    if (chain.algorithm, chain.distances) != ("nnchain", None):
        raise AssertionError(f"n={n} ward ran {chain.algorithm}")
    check_trips(chain_stats, None, f"n={n} chain")
    lw, lw_stats = timed(torch, lambda: cluster(X, "ward", algorithm="lw", backend="kernel",
                                                keep_inputs=False))
    check_lw_run(lw_stats, "kernel", "baseline", n, f"n={n} LW run")
    check_equivalent(np, chain.merges, lw.merges, n, f"matrix-free chain vs LW loop n={n}")
    return dict(n=n, d=d, chain_wall_s=chain_stats["wall_s"],
                launches=chain_stats["launches"], trip_replays=chain_stats["trip_replays"],
                lw_wall_s=lw_stats["wall_s"])


def timed_busy(torch, call, what: str, check) -> tuple:
    """:func:`timed`, ``check(stats)`` on its launches, then the device's
    busy time over a second, profiled run of the same call."""
    res, stats = timed(torch, call)
    check(stats)
    stats.update(device_busy(torch, call, stats["wall_s"], stats["launches"])[1])
    return res, stats


def phase_serial(torch, np, X, paper_X, paper_merges) -> dict:
    """``cluster(X, "centroid")`` with default knobs: the serial LW
    backend, staged, against the same call unstaged (bit for bit) and
    against the kernel backend; then the serial ``rowmin`` and ``lazy``
    variants at n = 1968 against phase 3."""
    from repro_torch.core import cluster
    from repro_torch.core.dendrogram import validate_merges

    n = X.shape[0]
    runs = {}
    for compaction in (True, False):
        def call(compaction=compaction):
            return cluster(X, "centroid", compaction=compaction, keep_inputs=False)

        what = f"serial centroid run, compaction={compaction}"
        runs[compaction] = timed_busy(torch, call, what, lambda st, what=what, c=compaction:
                                      check_lw_run(st, "serial", "baseline", n, what, c))
    (res, stats), (off_res, off) = runs[True], runs[False]
    if (res.algorithm, res.backend) != ("lw", "serial"):
        raise AssertionError(f"centroid default knobs ran {res.algorithm}/{res.backend}, "
                             "want the serial LW loop")
    check_bit_equal(np, res.merges, off_res.merges, f"serial centroid n={n}, staged vs unstaged")
    stats["unstaged"] = lw_run_numbers(off)
    validate_merges(res.merges, n=n)
    kernel, kernel_stats = timed(torch, lambda: cluster(X, "centroid", algorithm="lw",
                                                         backend="kernel", keep_inputs=False))
    check_lw_run(kernel_stats, "kernel", "baseline", n, "kernel centroid run")
    check_merges(np, res.merges, kernel.merges, f"serial vs kernel backend, centroid n={n}")
    stats["kernel_wall_s"] = kernel_stats["wall_s"]
    for variant in ("rowmin", "lazy"):
        r, s = timed(torch, lambda: cluster(paper_X, "complete", algorithm="lw", variant=variant,
                                            keep_inputs=False))
        check_lw_run(s, "serial", variant, PAPER_N, f"serial {variant} run")
        if r.backend != "serial":
            raise AssertionError(f"serial {variant} run reported {r.backend}")
        check_merges(np, r.merges, paper_merges, f"serial {variant} vs phase 3, n={PAPER_N}")
        stats[f"paper_{variant}_wall_s"] = s["wall_s"]
    return stats


def phase_lazy(torch, np, X, lw_merges, paper_X, paper_merges) -> dict:
    """The kernel backend's ``lazy`` variant (B3's resident merge, two
    launches a merge, replayed from graphs), staged and unstaged (bit for
    bit), against phase 5's LW merges on the same points, with the mean
    count of stale rows a merge from the engine's buffers; ``rowmin`` and
    ``lazy`` at n = 1968 against phase 3."""
    from repro_torch.core import cluster, engine
    from repro_torch.core.api import build_distance_matrix

    n = X.shape[0]
    runs = {}
    for compaction in (True, False):
        def call(compaction=compaction):
            return cluster(X, "complete", algorithm="lw", backend="kernel", variant="lazy",
                           compaction=compaction, keep_inputs=False)

        what = f"kernel lazy run, compaction={compaction}"
        res, stats = runs[compaction] = timed_busy(
            torch, call, what,
            lambda st, what=what, c=compaction: check_lw_run(st, "kernel", "lazy", n, what, c))
        stats.update(per_step(stats, n - 1, "merge"))
    (res, stats), (off_res, off) = runs[True], runs[False]
    check_bit_equal(np, res.merges, off_res.merges, f"kernel lazy n={n}, staged vs unstaged")
    check_merges(np, res.merges, lw_merges, f"kernel lazy vs phase 5's LW run, n={n}")
    stats["unstaged"] = dict(lw_run_numbers(off), **per_step(off, n - 1, "merge"))
    # the engine alone on the same matrix, unstaged: its buffers count the stale rows
    D = engine.symmetrize(build_distance_matrix(X, "euclidean"))
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    state = engine.run_merge_loop(engine.kernel_ops("complete", n, "lazy", device="cuda"),
                                  engine._init_state(D, alive, n - 1), n - 1)
    check_merges(np, state.merges.cpu().numpy(), lw_merges, "lazy engine run vs phase 5")
    stats["stale_rows_per_merge"] = int(state.cache.rescanned) / (n - 1)
    del D, state
    for variant in ("rowmin", "lazy"):
        r, s = timed(torch, lambda: cluster(paper_X, "complete", algorithm="lw", backend="kernel",
                                            variant=variant, keep_inputs=False))
        check_lw_run(s, "kernel", variant, PAPER_N, f"kernel {variant} run n={PAPER_N}")
        check_merges(np, r.merges, paper_merges, f"kernel {variant} vs phase 3, n={PAPER_N}")
        stats[f"paper_{variant}_wall_s"] = s["wall_s"]
    return stats


def phase_threshold(torch, np, paper_X, paper_merges) -> dict:
    """``distance_threshold`` on both LW backends, staged and unstaged (bit
    for bit): at the median merge height of phase 3's run, where the stop
    falls on the first merge of the kernel plan's second stage (complete
    linkage: monotone heights, so the merges at or below it are a prefix),
    and at the height of merge THRESHOLD_STAGE2_MERGE, inside its third.
    The loop checks the heights once every ``THRESHOLD_CHECK_TRIPS``
    merges of a stage, so a kernel run launches the step kernel up to the
    end of the chunk that holds the stop, and seeds the stages it ran."""
    from repro_torch.core import cluster

    n = paper_X.shape[0]
    out = {}
    for label, thr in (("median", float(np.median(paper_merges[:, 2]))),
                       ("stage2", float(paper_merges[THRESHOLD_STAGE2_MERGE, 2]))):
        k = int(np.sum(paper_merges[:, 2] <= np.float32(thr)))
        row = out[label] = dict(threshold=thr, merges_at_or_below=k)
        for backend in ("serial", "kernel"):
            merges = {}
            for compaction in (True, False):
                what = f"{backend} threshold run at the {label}, compaction={compaction}"
                r, s = timed(torch, lambda: cluster(paper_X, "complete", algorithm="lw",
                                                    backend=backend, distance_threshold=thr,
                                                    compaction=compaction, keep_inputs=False))
                check_lw_run(s, backend, "baseline", n, what, compaction, stop=k)
                if r.n_merges != k:
                    raise AssertionError(f"{what}: kept {r.n_merges} merges, want {k}")
                check_merges(np, r.merges, paper_merges[:k], f"{what} vs phase 3 prefix")
                merges[compaction] = r.merges
                tag = "" if compaction else "_unstaged"
                row[f"{backend}{tag}_wall_s"] = s["wall_s"]
                row[f"{backend}{tag}_stage_trips"] = s["stage_trips"]
            check_bit_equal(np, merges[True], merges[False], f"{backend} threshold at the {label}")
    return out


def check_labels(torch, np, got, want, Q, reps, what: str) -> dict:
    """Labels from two routes agree on every row whose top-two gap exceeds
    the pairwise kernel's tolerance (twice it: both distances carry it);
    rows under it are near-ties, which may go either way.  Returns the
    counts of near-tie rows and of rows that differ."""
    from repro_torch.kernels.pairwise import pairwise_sq_euclidean_plain

    Qt = torch.as_tensor(Q, device="cuda")
    R = torch.as_tensor(reps, device="cuda")
    D = pairwise_sq_euclidean_plain(Qt, R)
    atol = pairwise_atol(Qt, R)
    if R.shape[0] >= 2:
        top2 = torch.topk(D, 2, dim=1, largest=False).values
        near = (top2[:, 1] - top2[:, 0]) <= 2 * (PAIRWISE_RTOL * top2[:, 1] + atol)
    else:
        near = torch.zeros(D.shape[0], dtype=torch.bool, device="cuda")
    del D
    near = near.cpu().numpy()
    differ = np.asarray(got) != np.asarray(want)
    if np.any(differ & ~near):
        bad = np.flatnonzero(differ & ~near)
        raise AssertionError(f"{what}: {bad.size} labels differ away from any near-tie, "
                             f"first at row {bad[:3]}")
    return dict(near_tie_rows=int(near.sum()), differing_rows=int(differ.sum()))


def build_indexes(paper_chain, points_res) -> dict:
    """Phase 10's indexes: the centroids of phase 6's fit at k = 4096 and
    the exemplars of phase 3's chain fit at k = 64."""
    from repro_torch.service.assign import build_index

    t0 = time.perf_counter()
    indexes = {"centroid": build_index(points_res, CENTROID_K, kind="centroid"),
               "exemplar": build_index(paper_chain, EXEMPLAR_K, kind="exemplar")}
    return dict(indexes=indexes, index_build_s=time.perf_counter() - t0)


def phase_assign(torch, np, indexes: dict, index_build_s: float) -> dict:
    """Streaming assignment on phase 10's two indexes, each labeling
    QUERY_N fresh points of its fit's mixture (the same seed draws the
    same centers first) through the kernel and the Gram builder."""
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.service.assign import assign

    out = {"index_build_s": index_build_s}
    for kind, idx in indexes.items():
        Q = gaussian_mixture(seed=0, n=QUERY_N, dim=idx.reps.shape[1], return_labels=False)
        row = dict(k=idx.k, d=idx.reps.shape[1], queries=QUERY_N)
        labels = {}
        for backend, want in (("kernel", {"pairwise_sq_euclidean": 1}), ("auto", {})):
            def call():
                return assign(idx, Q, backend=backend)

            labels[backend], s = timed(torch, call)
            check_launches(s["launches"], want, f"{kind} index, backend={backend}")
            s.update(device_busy(torch, call, s["wall_s"], s["launches"])[1])
            row[backend] = {key: s[key] for key in ("wall_s", "device_busy_s", "idle_share",
                                                    "peak_gib", "launches")}
            row[backend]["pairwise_profiled_ms"] = s["kernel_ms_mean"]["pairwise_sq_euclidean"]
        row.update(check_labels(torch, np, labels["kernel"], labels["auto"], Q, idx.reps,
                                f"{kind} index: kernel vs auto labels"))
        out[kind] = row
    return out


def phase_landmark(torch, np) -> dict:
    """``cluster(X, "ward", algorithm="landmark")`` at n = 131072, d = 128;
    then B4 on the run's own landmark index; then at n = 8192 the landmark
    run against the exact chain."""
    from repro_torch.core import cluster, count_distance_queries
    from repro_torch.core.dendrogram import (
        adjusted_rand_index, cut, cut_label_agreement, is_monotone, validate_merges)
    from repro_torch.core.landmark import default_landmark_count, landmark_cluster
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.service.assign import AssignIndex, assign

    n, k = LANDMARK_N, LANDMARK_K
    if default_landmark_count(n) != k:
        raise AssertionError(f"default landmark count {default_landmark_count(n)}, want {k}")
    X, truth = gaussian_mixture(seed=0, n=n, dim=CHAIN_DIM)
    with count_distance_queries() as budget:
        res, stats = timed(torch, lambda: cluster(X, "ward", algorithm="landmark"))
    q, tags = budget.queries, budget.by_tag
    if not (q <= 3 * (n * k + k * k) and q < n * n and tags["sq_euclidean"] == (n - k) * k
            and tags["landmark_chain"] % k == 0 and tags["landmark_chain"] <= (4 * k + 8) * k):
        raise AssertionError(f"landmark budget fails the reference's gates: {budget}")
    trips = tags["landmark_chain"] // k
    check_trips(stats, trips, "landmark run")
    if (res.algorithm, res.backend, res.distances) != ("landmark", "serial", None):
        raise AssertionError(f"landmark run ran {res.algorithm}/{res.backend}")
    if stats["peak_gib"] >= LANDMARK_PEAK_LIMIT_GIB:
        raise AssertionError(f"landmark peak memory {stats['peak_gib']:.3f} GiB, "
                             f"limit {LANDMARK_PEAK_LIMIT_GIB} GiB")
    validate_merges(res.merges, n=n)
    if not is_monotone(res.merges):
        raise AssertionError("landmark merges are not monotone")
    ari = adjusted_rand_index(res.labels(CUT_K), truth)
    if ari < QUALITY_MIN:
        raise AssertionError(f"landmark ARI at the {CUT_K}-cut {ari:.4f} < {QUALITY_MIN}")
    stats.update(queries=q, queries_by_tag=dict(tags), k=k, trips=trips, ari=ari)

    # the tier alone, profiled: the same merges (seeded determinism)
    lm, busy = device_busy(torch, lambda: landmark_cluster(X, "ward"), stats["wall_s"],
                           stats["launches"])
    if not np.array_equal(lm.merges, res.merges):
        raise AssertionError("the profiled landmark run gave other merges")
    stats.update(busy)

    # B4 on the run's own landmark index: the groups of the non-landmarks
    rest = np.setdiff1d(np.arange(n), lm.landmarks)
    idx = AssignIndex(reps=X[lm.landmarks], metric="sqeuclidean", kind="landmark")
    labels, s = timed(torch, lambda: assign(idx, X[rest], backend="kernel"))
    check_launches(s["launches"], {"pairwise_sq_euclidean": 1}, "landmark index assignment")
    stats["kernel_assign"] = dict(queries=int(rest.size), wall_s=s["wall_s"],
                                  peak_gib=s["peak_gib"],
                                  **check_labels(torch, np, labels, lm.group_labels[rest],
                                                 X[rest], idx.reps,
                                                 "kernel labels vs the landmark groups"))
    del res, lm, labels, X

    # against the exact chain at n = 8192
    n8 = LANDMARK_CROSS_N
    X8, truth8 = gaussian_mixture(seed=0, n=n8, dim=CHAIN_DIM)
    approx, s_lm = timed(torch, lambda: cluster(X8, "ward", algorithm="landmark"))
    exact, s_ex = timed(torch, lambda: cluster(X8, "ward"))
    if exact.algorithm != "nnchain" or exact.distances is not None:
        raise AssertionError(f"n={n8} ward ran {exact.algorithm}, want the matrix-free chain")
    agree = cut_label_agreement(approx.merges, exact.merges, CUT_K, n=n8)
    ari8 = adjusted_rand_index(cut(approx.merges, CUT_K, n=n8), truth8)
    if agree < QUALITY_MIN or ari8 < QUALITY_MIN:
        raise AssertionError(f"n={n8}: landmark vs exact agreement {agree:.4f}, ARI {ari8:.4f}")
    stats["cross"] = dict(n=n8, landmark_wall_s=s_lm["wall_s"], exact_wall_s=s_ex["wall_s"],
                          cut_label_agreement=agree, ari=ari8)
    return stats


def phase_rmsd(torch, np) -> dict:
    """The paper's protein mode at its size: ``cluster(C, "complete",
    metric="rmsd")`` builds the rmsd matrix on the card and runs the
    default knobs' dense chain on it.  Its matrix is held against the one
    the plain rmsd builds on the CPU, and its dendrogram against the
    serial LW backend's on the same matrix.  (On the CPU's matrix the
    dendrogram differs by float noise: ~330 conformations of one fold lie
    at RMSD ~0.34 from each other, so merge heights tie within the two
    builds' ~1e-5 difference; the count of clusters that differ there is
    printed, not gated.)"""
    from repro_torch.core import build_distance_matrix, cluster
    from repro_torch.core.dendrogram import merge_leafsets
    from repro_torch.data.synthetic import conformations

    n = RMSD_N
    C, _ = conformations(seed=0, n=n, atoms=RMSD_ATOMS)
    res, stats = timed(torch, lambda: cluster(C, "complete", metric="rmsd"))
    check_launches(stats["launches"], {}, "rmsd run")
    if (res.algorithm, res.backend, res.metric) != ("nnchain", "serial", "rmsd"):
        raise AssertionError(f"rmsd run ran {res.algorithm}/{res.backend}/{res.metric}")
    D_card = res.distances.cpu()
    t0 = time.perf_counter()
    D_cpu = build_distance_matrix(C, "rmsd", device="cpu")
    stats["cpu_build_s"] = time.perf_counter() - t0
    _, s = timed(torch, lambda: build_distance_matrix(C, "rmsd"))
    stats["card_build_s"] = s["wall_s"]
    err = float((D_card - D_cpu).abs().max())
    if not torch.allclose(D_card, D_cpu, rtol=RTOL, atol=RMSD_ATOL):
        r, c = divmod(int((D_card - D_cpu).abs().argmax()), n)
        raise AssertionError(f"rmsd matrix on the card differs from the CPU's by {err} at ({r}, "
                             f"{c}): {float(D_card[r, c])} against {float(D_cpu[r, c])}")
    serial, s = timed(torch, lambda: cluster(D_card.numpy(), "complete", algorithm="lw",
                                             backend="serial", keep_inputs=False))
    check_equivalent(np, res.merges, serial.merges, n, "rmsd chain vs serial LW, one matrix")
    on_cpu_matrix = cluster(D_cpu.numpy(), "complete", algorithm="lw", backend="serial",
                            keep_inputs=False)
    differ = len(set(merge_leafsets(res.merges, n)) - set(merge_leafsets(on_cpu_matrix.merges, n)))
    stats.update(n=n, atoms=RMSD_ATOMS, matrix_max_abs_err=err, serial_wall_s=s["wall_s"],
                 clusters_differing_on_cpu_matrix=differ)
    return stats


def batch_launches(backend: str, variant: str, buckets, compaction=True) -> dict:
    """The launches and graph replays a ``cluster_batch`` LW run makes on
    ``backend``: for each bucket of ``bucket_n`` slots, its kernel plan's
    stages (``stop_at_k`` = 1), each seeding once (B1's batch form;
    ``lazy``: the masked row minima in torch) and making its steps as
    lockstep merges (one B2 batch launch each; ``lazy``: one B3 batch
    launch each, the update and the rescan), whole chunks of
    THRESHOLD_CHECK_TRIPS from its graph.
    The serial backend launches no kernel."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS

    seeds = merges = replays = 0
    for bucket in buckets:
        trips = stage_trips(lw_plan(backend, bucket, bucket - 1, compaction))
        seeds, merges = seeds + len(trips), merges + sum(trips)
        replays += sum(t // THRESHOLD_CHECK_TRIPS for t in trips)
    if backend == "serial":
        return dict(launches={}, replays=0)
    if variant == "lazy":
        return dict(launches={"lazy_merge_batch": merges}, replays=replays)
    return dict(launches={"masked_argmin_batch": seeds, "lw_merge_batch": merges}, replays=replays)


def check_batch_run(stats: dict, backend: str, variant: str, buckets, what: str,
                    compaction=True) -> None:
    want = batch_launches(backend, variant, buckets, compaction)
    check_launches(stats["launches"], want["launches"], what)
    if stats["merge_replays"] != want["replays"]:
        raise AssertionError(f"{what}: {stats['merge_replays']} graph replays, want "
                             f"{want['replays']}")


def batch_run(torch, call, check, warm=True) -> tuple:
    """A ``cluster_batch`` call as the batch phase drives it: :func:`timed`
    with its launches checked, the busy time over a profiled run, and
    (``warm``) a third run's wall; problems per second of the warm wall,
    and the host seconds that building every result's linkage matrix takes
    again (``ClusterResult`` builds one a problem, a Python loop a merge)."""
    from repro_torch.core.dendrogram import to_linkage_matrix

    res, stats = timed_busy(torch, call, "batch run", check)
    t0 = time.perf_counter()
    for r in res:
        to_linkage_matrix(r.merges, n=r.n)
    stats["host_linkage_s"] = time.perf_counter() - t0
    if warm:
        w = timed(torch, call)[1]
        check_launches(w["launches"], stats["launches"], "warm batch run")
        stats.update(warm_wall_s=w["wall_s"],
                     warm_idle_share=1 - stats["device_busy_s"] / w["wall_s"])
    stats["problems_per_s"] = len(res) / stats.get("warm_wall_s", stats["wall_s"])
    return res, stats


BATCH_RUN_KEYS = ("wall_s", "warm_wall_s", "device_busy_s", "idle_share", "warm_idle_share",
                  "problems_per_s", "host_linkage_s", "peak_gib", "launches", "merge_replays",
                  "profiler_tries")


def batch_numbers(stats: dict) -> dict:
    return {k: stats[k] for k in BATCH_RUN_KEYS if k in stats}


def check_lanes_equal(np, got, want, what: str) -> None:
    for b, (g, w) in enumerate(zip(got, want)):
        check_bit_equal(np, g.merges, w, f"{what}, problem {b}")


def batch_bench(torch, np) -> dict:
    """The reference's benchmarks/bench_batch.py setting: B = 64 matrices
    of n = 128 random points in 8-D, complete, algorithm "lw", on both
    backends against a loop of single-problem calls on the card."""
    from repro_torch.core import cluster, cluster_batch

    B, n, d = BATCH_BENCH
    X = np.random.default_rng(0).normal(size=(B, n, d))
    mats = [np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32) for x in X]
    out = {}
    for backend in ("serial", "kernel"):
        what = f"batch bench {backend}"
        res, stats = batch_run(
            torch, lambda: cluster_batch(mats, "complete", algorithm="lw", backend=backend),
            lambda st: check_batch_run(st, backend, "baseline", (n,), what))
        loop, loop_stats = timed(torch, lambda: [
            cluster(m, "complete", algorithm="lw", backend=backend, keep_inputs=False).merges
            for m in mats])
        check_lanes_equal(np, res, loop, what)
        out[backend] = dict(batch_numbers(stats), loop_wall_s=loop_stats["wall_s"],
                            buckets=res.stats.buckets)
    return out


def b2_read_bytes(n: int, lanes: int, plan) -> float:
    """Σ 4·L'·S over the lanes and lockstep merges of full lanes of ``n``
    slots: each merge reads the live rows (L' = n − 1 − t after merge t)
    of its stage's size S."""
    total, t = 0.0, 0
    for size, steps in plan:
        total += 4 * size * sum(n - 1 - k for k in range(t, t + steps))
        t += steps
    return lanes * total


def batch_full(torch, np) -> dict:
    """Full width: B = 256 problems of n = 1024 points in 64-D
    (``gaussian_mixture(seed=b)``), complete, one bucket of 1 GiB of
    matrices: kernel staged (1024 → 512 → 256) and unstaged, serial staged,
    and kernel lazy on the first 64; staged equals unstaged bit for bit,
    the kernel's slots the serial's, lazy's the kernel baseline's."""
    from repro_torch.core import cluster_batch
    from repro_torch.data.synthetic import gaussian_mixture

    B, n, d = BATCH_FULL
    pts = [gaussian_mixture(seed=b, n=n, dim=d, return_labels=False) for b in range(B)]
    runs = {}
    for name, backend, variant, compaction, probs in (
            ("kernel", "kernel", "baseline", True, pts),
            ("kernel_unstaged", "kernel", "baseline", False, pts),
            ("serial", "serial", "baseline", True, pts),
            ("kernel_lazy", "kernel", "lazy", True, pts[:BATCH_LAZY_B])):
        what = f"batch full {name}"
        res, stats = batch_run(
            torch, lambda: cluster_batch(probs, "complete", algorithm="lw", backend=backend,
                                         variant=variant, compaction=compaction),
            lambda st: check_batch_run(st, backend, variant, (n,), what, compaction),
            warm=name == "kernel")
        plan = lw_plan(backend, n, n - 1, compaction)
        stats.update(stage_sizes=[size for size, _ in plan])
        if backend == "kernel" and variant == "baseline":
            stats.update(b2_read_bytes=b2_read_bytes(n, B, plan),
                         b2_launches=stats["launches"]["lw_merge_batch"])
        runs[name] = (res, stats)
        torch.cuda.empty_cache()
    kernel = runs["kernel"][0]
    check_lanes_equal(np, kernel, [r.merges for r in runs["kernel_unstaged"][0]],
                      "batch full kernel, staged vs unstaged")
    for b, (k, s) in enumerate(zip(kernel, runs["serial"][0])):
        check_merges(np, k.merges, s.merges, f"batch full kernel vs serial, problem {b}")
    for b, (z, k) in enumerate(zip(runs["kernel_lazy"][0], kernel)):
        check_merges(np, z.merges, k.merges, f"batch full kernel lazy vs baseline, problem {b}")
    return {name: batch_numbers(st) | {k: st[k] for k in ("stage_sizes", "b2_read_bytes",
                                                          "b2_launches") if k in st}
            for name, (_, st) in runs.items()}


def batch_ragged(torch, np) -> dict:
    """The batch_dedup traffic: 4096 problems of 16 to 512 random points in
    16-D (buckets 16 … 512), complete, on the kernel backend; a sample of
    64 problems against their single-problem runs on the card.  The metric
    is named: a set of 16 points in 16-D is square, which would otherwise
    read as a distance matrix."""
    from repro_torch.core import cluster, cluster_batch
    from repro_torch.core.batched import bucket_n

    count, lo, hi, d = BATCH_RAGGED
    rng = np.random.default_rng(1)
    pts = [rng.normal(size=(k, d)).astype(np.float32) for k in rng.integers(lo, hi + 1, count)]
    buckets = sorted({bucket_n(len(p)) for p in pts})
    res, stats = batch_run(
        torch, lambda: cluster_batch(pts, "complete", metric="euclidean", algorithm="lw",
                                     backend="kernel"),
        lambda st: check_batch_run(st, "kernel", "baseline", buckets, "batch ragged"), warm=False)
    for i in rng.choice(count, BATCH_SAMPLE, replace=False):
        want = cluster(pts[i], "complete", metric="euclidean", algorithm="lw", backend="kernel",
                       keep_inputs=False)
        check_bit_equal(np, res[i].merges, want.merges, f"batch ragged problem {i}")
    return dict(batch_numbers(stats), buckets=res.stats.buckets,
                padded_problems=res.stats.padded_problems, pad_waste=res.stats.pad_waste,
                sample_checked=BATCH_SAMPLE)


def batch_points(torch, np) -> dict:
    """B = 256 ward point sets of n = 256 in 64-D with default knobs: the
    buckets go to the batched matrix-free chain (plain torch, no kernel),
    whose dendrograms equal the LW batch's on the same inputs but where the
    two part at a near-tie (counted; :func:`check_equivalent`); the chain's
    trips from a second run of the chain alone."""
    from repro_torch.core import cluster_batch
    from repro_torch.core.nnchain import CHAIN_GRAPH_TRIPS as k
    from repro_torch.core.nnchain import nn_chain_batched_from_points
    from repro_torch.data.synthetic import gaussian_mixture

    B, n, d = BATCH_POINTS
    pts = [gaussian_mixture(seed=1000 + b, n=n, dim=d, return_labels=False) for b in range(B)]
    res, stats = batch_run(torch, lambda: cluster_batch(pts, "ward"),
                           lambda st: check_launches(st["launches"], {}, "batch points chain"),
                           warm=False)
    if {r.algorithm for r in res} != {"nnchain"}:
        raise AssertionError(f"default knobs ran {sorted({r.algorithm for r in res})}")
    lw, lw_stats = timed(torch, lambda: cluster_batch(pts, "ward", algorithm="lw",
                                                      backend="kernel"))
    check_batch_run(lw_stats, "kernel", "baseline", (n,), "batch points, LW batch")
    near_tie = [b for b, (c, w) in enumerate(zip(res, lw))
                if not check_equivalent(np, c.merges, w.merges, n,
                                        f"batch points chain vs LW, problem {b}", near_ties=True)]
    chain, chain_stats = timed(torch, lambda: nn_chain_batched_from_points(
        np.stack(pts), [n] * B, "ward"))
    return dict(batch_numbers(stats), lw_wall_s=lw_stats["wall_s"],
                lanes_equivalent=B - len(near_tie), lanes_near_tie=near_tie,
                chain_alone_wall_s=chain_stats["wall_s"],
                trips_max=int(chain.iters.max()), trips_mean=float(chain.iters.float().mean()),
                lockstep_trips=k * max(-(-(n - 1) // k), -(-int(chain.iters.max()) // k)))


def phase_batch(torch, np, spec: dict) -> dict:
    """Phase 13, in a process of its own (``run_child``): ``cluster_batch``
    at the bench, full-width, ragged and points settings."""
    out = {}
    for name, run in (("bench", batch_bench), ("full", batch_full), ("ragged", batch_ragged),
                      ("points", batch_points)):
        out[name] = run(torch, np)
        say(f"phase 13 batch {name}: " + json.dumps(out[name]))
        torch.cuda.empty_cache()
    return out


#: Phase 14's traffic mixes: each a service configuration, the problems it
#: is sent (real sizes drawn uniformly, points in ``dim`` dimensions, sent
#: as matrices unless ``points``), the rate a closed loop of ``closed_s``
#: seconds sustains on a service of its own, and the open-loop rate:
#: ``rate`` req/s, or ``None`` for 0.8 of the closed loop's.  The open loop
#: runs ``duration_s`` seconds, or longer where that rate would send fewer
#: than SERVICE_MIN_REQUESTS requests.
SERVICE_MIXES = {
    # the reference load driver's defaults (repro.service.server main)
    "default": dict(config=dict(method="complete", engine="serial", bucket_ns=(8, 16, 32),
                                max_batch=8, max_delay_ms=2.0),
                    sizes=(5, 8, 12, 20, 27), dim=8, points=False, rate=200.0,
                    closed_s=3.0, duration_s=3.0),
    # batch_dedup's sizes at card scale, on the batch kernels
    "card": dict(config=dict(method="complete", engine="kernel", bucket_ns=(128, 256, 512),
                             max_batch=64, max_delay_ms=5.0),
                 sizes=tuple(range(100, 513)), dim=16, points=False, rate=None,
                 closed_s=3.0, duration_s=5.0),
    # ward point sets that default knobs send to the batched chain
    "points": dict(config=dict(method="ward", engine="serial", algorithm="auto",
                               points_dim=64, bucket_ns=(64, 128, 256), max_batch=32,
                               max_delay_ms=5.0),
                   sizes=tuple(range(33, 257)), dim=64, points=True, rate=None,
                   closed_s=3.0, duration_s=3.0),
}
SERVICE_SAMPLE = 64            # responses a mix holds against cluster_batch
SERVICE_MIN_REQUESTS = 3 * SERVICE_SAMPLE   # an open loop's least requests (its p99's base)


def builds() -> tuple[int, int]:
    """Bucket programs built and CUDA graphs captured in this process."""
    from repro_torch.core.batched import BucketProgram
    from repro_torch.kernels.lw_step import MergeGraph
    from repro_torch.kernels.pairwise import TripGraph

    return BucketProgram.built, MergeGraph.captures + TripGraph.captures


def classify(futures) -> dict:
    """Resolved futures by their typed outcome; unresolved ones apart."""
    from repro_torch.service import DeadlineExceeded, ServiceOverloaded

    out = dict(completed=0, failed=0, shed=0, expired=0, unresolved=0)
    for f in futures:
        exc = f.exception() if f.done() else None
        key = ("unresolved" if not f.done() else "completed" if exc is None
               else "shed" if isinstance(exc, ServiceOverloaded)
               else "expired" if isinstance(exc, DeadlineExceeded) else "failed")
        out[key] += 1
    return out


def service_load(torch, svc, mix: dict, rate: float, duration: float, seed: int) -> tuple:
    """One open-loop run of ``duration`` seconds on a warmed service with
    the counters set to 0 just before it: its futures, and the run's
    numbers (elapsed, outcomes,
    requests a second, builds and captures during it, launches, graph
    replays, the buckets dispatched)."""
    from repro_torch.kernels.lw_step import MergeGraph
    from repro_torch.obs import spans_by_name
    from repro_torch.service.server import run_load

    torch.cuda.synchronize()
    built0, compiles0 = builds(), svc.cache.stats.compiles
    n_events = len(spans_by_name(svc.tracer.events(), "bucket"))
    reset_counters()
    futures, elapsed, drained = run_load(svc, rate_hz=rate, duration_s=duration,
                                         sizes=mix["sizes"], seed=seed, dim=mix["dim"],
                                         as_points=mix["points"])
    torch.cuda.synchronize()
    launches, replays = read_counters(), MergeGraph.replays
    built = builds()
    buckets = [int(e.args["signature"].split("/n")[1].split("/")[0])
               for e in spans_by_name(svc.tracer.events(), "bucket")[n_events:]]
    outcome = classify(futures)
    return futures, dict(elapsed_s=elapsed, drained=drained, submitted=len(futures), **outcome,
                         rps=outcome["completed"] / elapsed,
                         steady_builds=built[0] - built0[0] + svc.cache.stats.compiles
                         - compiles0, steady_captures=built[1] - built0[1],
                         launches=launches, merge_replays=replays, buckets=len(buckets),
                         bucket_ns=buckets)


def check_service_samples(torch, np, mix: dict, futures, what: str) -> dict:
    """SERVICE_SAMPLE responses against ``cluster_batch`` of the same
    problems with the same engine and knobs, on the card: LW lists bit for
    bit, chain lists as dendrograms (``merges_equivalent``)."""
    from repro_torch.core import cluster_batch

    cfg = mix["config"]
    done = [f.result() for f in futures if f.done() and f.exception() is None]
    if len(done) < SERVICE_SAMPLE:
        raise AssertionError(f"{what}: {len(done)} responses, fewer than the "
                             f"{SERVICE_SAMPLE} to sample")
    picks = np.random.default_rng(7).choice(len(done), SERVICE_SAMPLE, replace=False)
    got = [done[i] for i in picks]
    inputs = [r.points if r.points is not None else r.distances for r in got]
    want = cluster_batch(inputs, cfg["method"], backend=cfg["engine"],
                         algorithm=cfg.get("algorithm", "auto"), is_distance=not mix["points"])
    chain = 0
    for r, w, i in zip(got, want, picks):
        if r.algorithm != w.algorithm:
            raise AssertionError(f"{what}: response {i} ran {r.algorithm}, cluster_batch "
                                 f"{w.algorithm}")
        if r.algorithm == "nnchain":
            check_equivalent(np, r.merges, w.merges, r.n, f"{what}, response {i}")
            chain += 1
        else:
            check_bit_equal(np, r.merges, w.merges, f"{what}, response {i}")
    return dict(sampled=len(got), sampled_chain=chain)


def service_mix(torch, np, name: str, mix: dict) -> dict:
    """One traffic mix (phase 14): a closed-loop probe on a service of its
    own, then a fresh service warmed and driven open loop
    at the mix's rate, checked, and driven again for its base window under
    the profiler for the busy time.  Gates: no build and no capture after
    warmup, no request failed, shed, expired or left unresolved, the
    sampled responses equal ``cluster_batch``'s, and on the kernel engine
    the launches of the dispatched buckets' plans."""
    from repro_torch.obs import Tracer
    from repro_torch.service import ClusteringService, ServiceConfig
    from repro_torch.service.server import run_closed_loop

    cfg = ServiceConfig(**mix["config"])
    torch.cuda.reset_peak_memory_stats()
    with ClusteringService(cfg) as probe:
        probe.warmup()
        capacity = run_closed_loop(probe, duration_s=mix["closed_s"], sizes=mix["sizes"],
                                   seed=1, dim=mix["dim"], as_points=mix["points"],
                                   concurrency=max(2 * cfg.max_batch, 8))
    rate = mix["rate"] or 0.8 * capacity
    duration = max(mix["duration_s"], SERVICE_MIN_REQUESTS / rate)
    out = dict(closed_loop_rps=capacity, window_s=duration)
    torch.cuda.empty_cache()
    with ClusteringService(cfg, tracer=Tracer(max_events=1_000_000)) as svc:
        built0 = builds()
        t0 = time.perf_counter()
        warmed = svc.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        built = builds()
        progs = svc.cache.programs()
        out.update(rate_rps=rate, warmup_s=warm_s, warmup_programs=warmed,
                   warmup_programs_counted=built[0] - built0[0],
                   warmup_captures=built[1] - built0[1],
                   program_bytes={f"n{p.sig.bucket_n}/B{p.sig.bucket_B}": p.nbytes
                                  for p in progs},
                   programs_gib=sum(p.nbytes for p in progs) / 2**30)
        futures, run = service_load(torch, svc, mix, rate, duration, seed=2)
        snap = svc.metrics.snapshot(svc.cache)
        out.update(run, p50_ms=snap.p50_ms, p99_ms=snap.p99_ms, pad_waste=snap.pad_waste,
                   mean_batch=snap.mean_batch_size, cache_hit_rate=snap.cache_hit_rate)
        what = f"service {name}"
        bad = {k: run[k] for k in ("failed", "shed", "expired", "unresolved") if run[k]}
        if bad or not run["drained"]:
            raise AssertionError(f"{what}: requests not served at {rate:.6g} req/s: {bad}")
        if run["steady_builds"] or run["steady_captures"]:
            raise AssertionError(f"{what}: steady traffic built {run['steady_builds']} programs "
                                 f"and captured {run['steady_captures']} graphs")
        if cfg.engine == "kernel":
            check_batch_run(run, "kernel", cfg.variant, run["bucket_ns"], what)
        else:
            check_launches(run["launches"], {}, what)
        out.update(check_service_samples(torch, np, mix, futures, what))

        # the mix's base window again, profiled: its busy time and idle share
        # (a window stretched to SERVICE_MIN_REQUESTS is not: the points
        # mix's ~10^6 plain-torch launch records would take a minute to read)
        def again():
            return service_load(torch, svc, mix, rate, mix["duration_s"], seed=3)[1]

        second, busy = device_busy(torch, again, None, None)
        if second["steady_builds"] or second["steady_captures"] or second["completed"] != \
                second["submitted"]:
            raise AssertionError(f"{what}, profiled run: {second}")
        out.update(profiled_rps=second["rps"],
                   device_busy_s=busy["device_busy_s"],
                   idle_share=1 - busy["device_busy_s"] / second["elapsed_s"],
                   profiler_tries=busy["profiler_tries"])
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del out["bucket_ns"]
    return out


def phase_service(torch, np, spec: dict) -> dict:
    """Phase 14, in a process of its own (``run_child``): the clustering
    service on the card under each of SERVICE_MIXES."""
    out = {}
    for name, mix in SERVICE_MIXES.items():
        out[name] = service_mix(torch, np, name, mix)
        say(f"phase 14 service {name}: " + json.dumps(out[name]))
        torch.cuda.empty_cache()
    return out


LATER_PHASES_FLAG, PROFILE_CHAIN_FLAG = "--later-phases", "--profile-chain"
BATCH_FLAG = "--batch"
SERVICE_FLAG = "--service"


def run_child(torch, flag: str, spec: dict) -> dict:
    """``python3 chip_smoke.py <flag>`` in a fresh process, ``spec``
    pickled on its standard input: phase 6's profiled chain run
    (``--profile-chain``, :func:`profile_chain`) and phases 10-12
    (``--later-phases``).

    After a profiling session of some 10^5 records, later sessions of the
    same process lose records at random (on an H100 80GB HBM3 with torch
    2.11: a session of one assign call, five device records, saw none of
    them in about half the tries, and the resident chain's profiled run
    at n = 32768 missed 1.2% of its 98304 trip launches after phases 3-5,
    while the first sessions of a process saw every record).  The child
    prints its phase lines and, last, one JSON object of their numbers; it
    is waited for."""
    torch.cuda.empty_cache()
    spec = dict(spec, elapsed=time.perf_counter() - T0)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag],
                          input=pickle.dumps(spec), stdout=subprocess.PIPE, timeout=1100)
    lines = proc.stdout.decode().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        print("\n".join(lines[-1:]), flush=True)
        raise AssertionError(f"{flag} failed (exit code {proc.returncode})")
    return json.loads(lines[-1])


def profile_chain(torch, np, spec: dict) -> dict:
    """Phase 6's chain alone, profiled, in a process of its own: busy time,
    trips, and the profiler's count of trip launches against the
    counters'.  A small run first loads the trip kernel."""
    from repro_torch.core.nnchain import nn_chain_from_points
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels.pairwise import TripGraph

    nn_chain_from_points(gaussian_mixture(seed=1, n=300, dim=CHAIN_DIM, return_labels=False),
                         "ward")
    X = gaussian_mixture(seed=0, n=CHAIN_N, dim=CHAIN_DIM, return_labels=False)
    chain, busy = device_busy(torch, lambda: nn_chain_from_points(X, "ward"), spec["wall_s"],
                              spec["launches"])
    stats = dict(launches=read_counters(), trip_replays=TripGraph.replays)
    check_trips(stats, chain.iters, "matrix-free chain, profiled")
    return dict(busy, iters=chain.iters, n_merges=chain.n_merges, **stats)


def phases_10_to_12(torch, np, spec: dict) -> dict:
    # 10. streaming assignment
    assigned = phase_assign(torch, np, spec["indexes"], spec["index_build_s"])
    say(f"phase 10 streaming assignment of {QUERY_N} queries: " + json.dumps(assigned))
    torch.cuda.empty_cache()

    # 11. the landmark tier
    landmark = phase_landmark(torch, np)
    say(f"phase 11 landmark tier n={LANDMARK_N} d={CHAIN_DIM} ward: " + json.dumps(landmark))
    torch.cuda.empty_cache()

    # 12. rmsd
    rmsd = phase_rmsd(torch, np)
    say(f"phase 12 rmsd n={RMSD_N} atoms={RMSD_ATOMS} complete: " + json.dumps(rmsd))
    return dict(assigned=assigned, landmark=landmark, rmsd=rmsd)


CHILDREN = {LATER_PHASES_FLAG: phases_10_to_12, PROFILE_CHAIN_FLAG: profile_chain,
            BATCH_FLAG: phase_batch, SERVICE_FLAG: phase_service}


def child(flag: str) -> int:
    """A child of :func:`run_child`."""
    import numpy as np
    import torch

    global T0
    spec = pickle.load(sys.stdin.buffer)
    T0 = time.perf_counter() - spec["elapsed"]
    if not torch.cuda.is_available():
        raise AssertionError(f"{flag}: no CUDA device")
    print(json.dumps(CHILDREN[flag](torch, np, spec)), flush=True)
    return 0


def summary(kernels: dict, paper: dict, full: dict, dense: dict, points: dict,
            serial: dict, lazy: dict, assigned: dict, landmark: dict, rmsd: dict,
            batch: dict, service: dict) -> str:
    """The numbers a reader checks first, on one line near the end."""
    def g(x):
        return f"{x:.6g}"

    parts = [f"{name} n={n} ms {g(r['ms'])} bound {g(r['bound_ms'])} plain {g(r['plain_ms'])}"
             + (f" read {g(r['read_bytes_per_s'] / 1e12)} TB/s" if "read_bytes" in r else "")
             + (f" graph {g(r['graph_ms_per_trip'])}" if "graph_ms_per_trip" in r else "")
             + (f" graph {g(r['graph_ms_per_merge'])}" if "graph_ms_per_merge" in r else "")
             for (name, n), r in kernels.items()]
    for label, s in (("paper", paper), ("full", full)):
        u = s["unstaged"]
        parts.append(f"{label} wall_s {g(s['wall_s'])} (warm {g(s['warm_wall_s'])}) busy_s "
                     f"{g(s['device_busy_s'])} idle {g(s['idle_share'])} (warm "
                     f"{g(s['warm_idle_share'])}) stages {s['stage_sizes']} "
                     f"peak_gib {g(s['peak_gib'])}; unstaged wall_s {g(u['wall_s'])} (warm "
                     f"{g(u['warm_wall_s'])}) busy_s {g(u['device_busy_s'])} idle "
                     f"{g(u['idle_share'])} peak_gib {g(u['peak_gib'])}; unstaged host/device ms "
                     f"per merge {g(s['host_ms_per_merge'])}/{g(s['device_ms_per_merge'])}")
    parts.append("paper stage floor walls (median s): " + ", ".join(
        f"{floor} ({r['stages']} stages) {g(r['wall_s'])}" for floor, r in paper["stage_floor"].items()))
    for label, s in ((f"dense chain n={MID_N}", dense), ("matrix-free chain", points)):
        parts.append(f"{label} wall_s {g(s['wall_s'])} trips {s['trips']} busy_s "
                     f"{g(s['device_busy_s'])} idle {g(s['idle_share'])} host/device ms per trip "
                     f"{g(s['host_ms_per_trip'])}/{g(s['device_ms_per_trip'])} "
                     f"peak_gib {g(s['peak_gib'])}")
    parts.append(f"matrix-free chain, host-driven plain-row loop wall_s "
                 f"{g(points['host_loop_wall_s'])} trips {points['host_loop_trips']}; resident "
                 f"trip launches {points['launches']['chain_trip']} in "
                 f"{points['trip_replays']} replays")
    for label, s in ((f"serial centroid n={MID_N}", serial), (f"kernel lazy n={MID_N}", lazy)):
        u = s["unstaged"]
        parts.append(f"{label} wall_s {g(s['wall_s'])} busy_s {g(s['device_busy_s'])} idle "
                     f"{g(s['idle_share'])} stages {s['stage_sizes']} peak_gib {g(s['peak_gib'])}; "
                     f"unstaged wall_s {g(u['wall_s'])} busy_s {g(u['device_busy_s'])} idle "
                     f"{g(u['idle_share'])} peak_gib {g(u['peak_gib'])}")
    parts.append(f"serial centroid: kernel backend wall_s {g(serial['kernel_wall_s'])}; "
                 f"kernel lazy: host/device ms per merge {g(lazy['host_ms_per_merge'])}/"
                 f"{g(lazy['device_ms_per_merge'])} stale rows per merge "
                 f"{g(lazy['stale_rows_per_merge'])}")
    for kind in ("centroid", "exemplar"):
        a = assigned[kind]
        parts.append(f"assign {kind} k={a['k']} kernel wall_s {g(a['kernel']['wall_s'])} busy_s "
                     f"{g(a['kernel']['device_busy_s'])} idle {g(a['kernel']['idle_share'])}; "
                     f"auto wall_s {g(a['auto']['wall_s'])} busy_s {g(a['auto']['device_busy_s'])}; "
                     f"near-tie rows {a['near_tie_rows']} differing {a['differing_rows']}")
    parts.append(f"landmark n={LANDMARK_N} k={landmark['k']} wall_s {g(landmark['wall_s'])} "
                 f"busy_s {g(landmark['device_busy_s'])} idle {g(landmark['idle_share'])} "
                 f"trips {landmark['trips']} queries {landmark['queries']} ari {g(landmark['ari'])} "
                 f"peak_gib {g(landmark['peak_gib'])}; kernel assign wall_s "
                 f"{g(landmark['kernel_assign']['wall_s'])} near-tie rows "
                 f"{landmark['kernel_assign']['near_tie_rows']}; n={landmark['cross']['n']} "
                 f"agreement {g(landmark['cross']['cut_label_agreement'])}")
    parts.append(f"rmsd n={rmsd['n']} wall_s {g(rmsd['wall_s'])} card build_s "
                 f"{g(rmsd['card_build_s'])} cpu build_s {g(rmsd['cpu_build_s'])} matrix err "
                 f"{g(rmsd['matrix_max_abs_err'])} clusters differing on the CPU's matrix "
                 f"{rmsd['clusters_differing_on_cpu_matrix']}")
    for label, s in (*((f"batch bench {k}", v) for k, v in batch["bench"].items()),
                     *((f"batch full {k}", v) for k, v in batch["full"].items()),
                     ("batch ragged", batch["ragged"]), ("batch points chain", batch["points"])):
        parts.append(f"{label} wall_s {g(s['wall_s'])}"
                     + (f" (warm {g(s['warm_wall_s'])})" if "warm_wall_s" in s else "")
                     + f" busy_s {g(s['device_busy_s'])} idle {g(s['idle_share'])} problems/s "
                     f"{g(s['problems_per_s'])} peak_gib {g(s['peak_gib'])}"
                     + (f" B2 reads {g(s['b2_read_bytes'] / 1e12)} TB in {s['b2_launches']} "
                        f"launches" if "b2_read_bytes" in s else ""))
    parts.append(f"batch ragged buckets {batch['ragged']['buckets']} pad_waste "
                 f"{g(batch['ragged']['pad_waste'])}; batch points trips max "
                 f"{batch['points']['trips_max']} mean {g(batch['points']['trips_mean'])}")
    for name, s in service.items():
        parts.append(f"service {name} at {g(s['rate_rps'])} req/s"
                     + f" (closed loop {g(s['closed_loop_rps'])})"
                     + f": served {s['completed']}/{s['submitted']} rps {g(s['rps'])} p50_ms "
                     f"{g(s['p50_ms'])} p99_ms {g(s['p99_ms'])} pad_waste {g(s['pad_waste'])} "
                     f"busy_s {g(s['device_busy_s'])} idle {g(s['idle_share'])} warmup "
                     f"{s['warmup_programs']} programs {s['warmup_captures']} graphs, steady "
                     f"{s['steady_builds']}/{s['steady_captures']} peak_gib {g(s['peak_gib'])}")
    return "summary: " + "; ".join(parts)


def kernel_inventory(kernels: dict, full: dict, lazy: dict, points: dict, assigned: dict,
                     batch: dict, service: dict) -> list:
    """The ``{"kernels": [...]}`` line: each TPU kernel's CUDA counterpart
    with its main-path entry's numbers first and every entry listed."""
    src = {"masked_argmin": ("src/repro_torch/csrc/minscan.cu", "src/repro/kernels/minscan.py:71"),
           "lw_step": ("src/repro_torch/csrc/lw_step.cu", "src/repro/kernels/lw_step.py:154"),
           "lw_update": ("src/repro_torch/csrc/lw_update.cu", "src/repro/kernels/lw_update.py:72"),
           "row_sq_euclidean": ("src/repro_torch/csrc/row_sq.cu",
                                "src/repro/kernels/pairwise.py:148"),
           "pairwise_sq_euclidean": ("src/repro_torch/csrc/pairwise.cu",
                                     "src/repro/kernels/pairwise.py:60")}
    # B2, B3 and B5 launch through their second entries on the main path (the
    # merge, the lazy merge, the chain trip): a kernel's line gives that
    # entry's launches and times, and lists every entry under "entries"
    # "stages": the compaction stages of the LW run the launches were
    # counted in (null for the chains and the labeler, which do not stage)
    def numbers(key, path, entry):
        row = kernels[key]
        return dict(launches=path["launches"][entry], max_abs_err=row["max_abs_err"],
                    ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row.get("library_ms"), n=key[1],
                    bound_bytes_per_s=row["bound_bytes_per_s"], stages=path.get("stages"))

    # the batch entries: times at the full-width bucket, launches from its runs
    full_b = BATCH_FULL[:2]
    b_kernel, b_lazy = batch["full"]["kernel"], batch["full"]["kernel_lazy"]
    inventory = []
    for name, entries in (
            ("masked_argmin", [("masked_argmin", ("masked_argmin", FULL_N), full),
                               ("masked_argmin_batch", ("masked_argmin_batch/seed", full_b),
                                b_kernel)]),
            ("lw_step", [("lw_merge", ("lw_merge/complete", FULL_N), full),
                         ("lw_step", ("lw_step/complete", FULL_N), full),
                         ("lw_merge_batch", ("lw_merge_batch/complete", full_b), b_kernel)]),
            ("lw_update", [("lazy_merge", ("lazy_merge/complete", MID_N), lazy),
                           ("lw_update", ("lw_update/complete", FULL_N), lazy),
                           ("lazy_merge_batch", ("lazy_merge_batch/complete", full_b),
                            b_lazy)]),
            ("row_sq_euclidean", [("chain_trip", ("chain_trip", CHAIN_N), points),
                                  ("row_sq_euclidean", ("row_sq_euclidean", CHAIN_N), points)]),
            ("pairwise_sq_euclidean", [("pairwise_sq_euclidean",
                                        ("pairwise_sq_euclidean", QUERY_N),
                                        assigned["centroid"]["kernel"])])):
        listed = [dict(entry=entry, **numbers(key, path, entry)) for entry, key, path in entries]
        for row in listed:                        # the single lazy merge's second launch
            if row["entry"] in service["card"]["launches"] and row["entry"].endswith("_batch"):
                row["service_launches"] = service["card"]["launches"][row["entry"]]
            if row["entry"] == "lazy_merge":
                row["rescan_launches"] = lazy["launches"]["lazy_rescan"]
        for row in listed[1:]:                    # an entry in a source of its own
            row["source"] = ENTRY_SOURCES.get(row["entry"], src[name][0])
        inventory.append(dict(name=name, route="cuda", source=src[name][0],
                              replaces=src[name][1], **listed[0], entries=listed))
    return inventory


T0 = time.perf_counter()


def say(line: str) -> None:
    """Print one phase's line with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:.1f} s] {line}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import _build

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    card = gpu_line()
    say(f"phase 1 build: {build_s:.2f} s; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {card}")
    resources = resource_report(torch)
    say("phase 1 B1, B2 and B3 batch registers and local bytes a thread: "
        + json.dumps(resources))
    for entry in ("masked_argmin_batch", "lw_merge_batch", "lazy_merge_batch"):
        spilled = {shape: row for shape, row in resources[entry].items()
                   if any(numbers[1] for numbers in row.values())}
        if spilled:
            raise AssertionError(f"{entry} spills: {spilled}")

    # 2. kernels against their plain versions
    l2_rate = l2_read_rate(torch)
    say(f"phase 2 L2 read rate: {l2_rate:.6g} bytes/s; L2 "
        f"{torch.cuda.get_device_properties(0).L2_cache_size} bytes")
    kernels = {}
    for n in (PAPER_N, FULL_N):
        for name, row in phase_kernels(torch, n, l2_rate).items():
            say(f"phase 2 {name} n={n}: " + json.dumps(row))
            kernels[(name, n)] = row
        torch.cuda.empty_cache()
    for m, d in ROW_SHAPES:
        row = phase_row(torch, m, d, l2_rate)
        say(f"phase 2 row_sq_euclidean m={m} d={d}: " + json.dumps(row))
        kernels[("row_sq_euclidean", m)] = row
    for m, d in TRIP_SHAPES:
        row = phase_trip(torch, m, d, l2_rate)
        say(f"phase 2 chain_trip m={m} d={d}: " + json.dumps(row))
        kernels[("chain_trip", m)] = row
    torch.cuda.empty_cache()
    for n, m, d in PAIRWISE_SHAPES:
        row = phase_pairwise(torch, n, m, d, l2_rate)
        say(f"phase 2 pairwise_sq_euclidean n={n} m={m} d={d}: " + json.dumps(row))
        kernels[("pairwise_sq_euclidean", n)] = row
        torch.cuda.empty_cache()
    for n in LAZY_SHAPES:
        row = phase_lazy_merge(torch, n, l2_rate)
        say(f"phase 2 lazy_merge n={n}: " + json.dumps(row))
        kernels[("lazy_merge/complete", n)] = row
        torch.cuda.empty_cache()
    for B, n, reps, at in BATCH_KERNEL_SHAPES:
        for name, row in phase_batch_kernels(torch, B, n, reps, l2_rate, at).items():
            say(f"phase 2 {name} B={B} n={n}: " + json.dumps(row))
            kernels[(name, (B, n))] = row
        torch.cuda.empty_cache()
    for B, n, ragged in ARGMIN_SEED_SHAPES:
        row = phase_argmin_seed(torch, B, n, ragged, l2_rate)
        say(f"phase 2 masked_argmin_batch seed B={B} n={n}: " + json.dumps(row))
        kernels[("masked_argmin_batch/seed", (B, n))] = row
        torch.cuda.empty_cache()

    # 3. the paper's configuration
    X_paper, paper_merges, paper_chain, paper = phase_paper(torch, np)
    say(f"phase 3 paper n={PAPER_N} complete: " + json.dumps(paper))
    torch.cuda.empty_cache()

    # 4. full size
    X_full, lw_merges, full = phase_full(torch, np)
    say(f"phase 4 full n={FULL_N} complete: " + json.dumps(full))
    torch.cuda.empty_cache()

    # 5. the dense chain on the first MID_N of phase 4's points
    X_mid = X_full[:MID_N]
    del X_full, lw_merges
    mid_merges, dense = phase_dense_chain(torch, np, X_mid)
    say(f"phase 5 dense chain n={MID_N} complete: " + json.dumps(dense))
    torch.cuda.empty_cache()

    # 6. the matrix-free chain, and against the LW loop at n = 4096
    points_res, points = phase_points_chain(torch, np)
    say(f"phase 6 matrix-free chain n={CHAIN_N} d={CHAIN_DIM} ward: " + json.dumps(points))
    for n, d in CROSS_SHAPES:
        cross = phase_cross(torch, np, n, d)
        say(f"phase 6 matrix-free chain vs LW loop n={n} d={d} ward: " + json.dumps(cross))
    torch.cuda.empty_cache()

    # 7. the serial LW backend
    serial = phase_serial(torch, np, X_mid, X_paper, paper_merges)
    say(f"phase 7 serial LW backend n={MID_N} centroid: " + json.dumps(serial))
    torch.cuda.empty_cache()

    # 8. the kernel backend's lazy variant
    lazy = phase_lazy(torch, np, X_mid, mid_merges, X_paper, paper_merges)
    say(f"phase 8 kernel lazy n={MID_N} complete: " + json.dumps(lazy))
    del X_mid, mid_merges
    torch.cuda.empty_cache()

    # 9. distance_threshold on both LW backends
    threshold = phase_threshold(torch, np, X_paper, paper_merges)
    say(f"phase 9 distance_threshold n={PAPER_N} complete: " + json.dumps(threshold))

    # 10-12 and 13 run in processes of their own (run_child says why)
    later = run_child(torch, LATER_PHASES_FLAG, build_indexes(paper_chain, points_res))
    assigned, landmark, rmsd = later["assigned"], later["landmark"], later["rmsd"]
    del paper_chain, points_res
    batch = run_child(torch, BATCH_FLAG, {})
    service = run_child(torch, SERVICE_FLAG, {})

    # 15. inventory, card, result
    inventory = kernel_inventory(kernels, full, lazy, points, assigned, batch, service)
    print(summary(kernels, paper, full, dense, points, serial, lazy, assigned, landmark, rmsd,
                  batch, service))
    print(json.dumps({"kernels": inventory}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


SINGLE_TIMES_FLAG = "--single-kernel-times"


def single_kernel_times(src: str | None) -> int:
    """``python3 chip_smoke.py --single-kernel-times [SRC]``: phase 2's rows of
    the single-problem entries of B1, B2 and B3 (their checks included) for
    the ``repro_torch`` under ``SRC`` (default: this checkout's), one JSON
    line each.  Run it for two trees in one call, in the order A, B, B, A,
    to compare their kernels on one card."""
    import torch

    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    from repro_torch.kernels import _build

    _build.build_all()
    l2_rate = l2_read_rate(torch)
    rows = {}
    for n in (PAPER_N, FULL_N):
        for name, row in phase_kernels(torch, n, l2_rate).items():
            rows[f"{name} n={n}"] = row["ms"]
        torch.cuda.empty_cache()
    for n in LAZY_SHAPES:
        rows[f"lazy_merge/complete n={n}"] = phase_lazy_merge(torch, n, l2_rate)["ms"]
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]), "ms": rows,
                      "card": gpu_line()}))
    return 0


BATCH_TIMES_FLAG = "--batch-kernel-times"


def batch_kernel_times(src: str | None) -> int:
    """``python3 chip_smoke.py --batch-kernel-times [SRC]``: the register and
    spill report (with ptxas's lines for B1's kernels), and phase 2's rows
    of B1's, B2's and B3's batch forms at every BATCH_KERNEL_SHAPES bucket
    that times them (checks included), with their plan sweeps, for the
    ``repro_torch`` under ``SRC``; one JSON line.  B1's rows add its seed
    states (ARGMIN_SEED_SHAPES), lanes of two live slots
    (ARGMIN_FLOOR_SHAPES) and, like B2's, a torch reduction's read rate over
    the bucket; B2's an all-live bucket; B3's the device µs a lockstep merge
    of each kernel it launches (the profiler's records) and torch's store
    yardsticks.  Run it for two trees in one call, in the order A, B, B, A,
    to compare their batch forms on one card."""
    import torch

    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    from repro_torch.kernels import _build

    logs = _build.build_all()
    ptxas = [line.strip() for name in ("minscan", "argmin_batch") for line in
             logs.get(name, "").splitlines() if "registers" in line or "spill" in line]
    l2_rate = l2_read_rate(torch)
    rows = {"masked_argmin_batch": {}, "lw_merge_batch": {}, "lazy_merge_batch": {}}
    sweep = {"masked_argmin_batch": {}, "lw_merge_batch": {}, "lazy_merge_batch": {}}

    def argmin_rows(key, D, alive, resident):
        row = batch_argmin_row(torch, D, alive, alive.sum(1).to(torch.float64), resident,
                               l2_rate)
        rows["masked_argmin_batch"][key] = {k: row[k] for k in (
            "path", "live_mean", "ms", "bound_ms", "read_bytes", "read_bytes_per_s")}
        rows["masked_argmin_batch"][key]["amin_bucket_bytes_per_s"] = (
            resident / (time_ms(torch, lambda: torch.amin(D, dim=-1)) * 1e-3))
        B, n = alive.shape
        if argmin_plan(torch, B, n) is not None and (n > 64 or n <= 32):
            sweep["masked_argmin_batch"][key] = argmin_plan_sweep(torch, D, alive)

    for B, n, reps, at in BATCH_KERNEL_SHAPES:
        key = f"B={B} n={n}"
        D, alive, sizes, limit, cand = batch_mid_state(torch, B, n, reps, seed=11)
        live, resident = alive.sum(1).to(torch.float64), 4 * B * n * n
        if "argmin" in at:
            argmin_rows(key, D, alive, resident)
        if "merge" in at:
            row = batch_merge_row(torch, "complete", D, alive, sizes, limit, cand, live, reps,
                                  resident, l2_rate)
            rows["lw_merge_batch"][key] = {k: row[k] for k in ("path", "ms", "bound_ms",
                                                               "read_bytes_per_s")}
            # a yardstick of the card's read rate: one torch reduction over the whole bucket
            rows["lw_merge_batch"][key]["amin_bucket_bytes_per_s"] = (
                resident / (time_ms(torch, lambda: torch.amin(D, dim=-1)) * 1e-3))
            if n > 128:
                sweep["lw_merge_batch"][key] = plan_sweep(torch, D, alive, sizes, limit, cand,
                                                          reps)
        if "lazy" in at:
            row = batch_lazy_row(torch, "complete", D, alive, sizes, limit, live, reps,
                                 resident, l2_rate)
            rows["lazy_merge_batch"][key] = dict(
                {k: row[k] for k in ("path", "stale_rows_per_merge", "ms", "bound_ms",
                                     "bytes_per_s", "regs", "local_bytes")},
                kernel_us=lazy_kernel_split(torch, D, alive, sizes, limit, reps))
            if n > 128:
                sweep["lazy_merge_batch"][key] = lazy_plan_sweep(torch, D, alive, sizes, limit,
                                                                 reps)
            rows["lazy_merge_batch"][key].update(store_yardsticks(torch, D, reps))   # writes D
        del D, alive, sizes, limit, cand
        torch.cuda.empty_cache()
    # the full-width bucket all live: whole matrices, no dead row skipped
    B, n, reps, _ = BATCH_KERNEL_SHAPES[0]
    D, alive, sizes, limit, cand = batch_mid_state(torch, B, n, reps, seed=11, dead=0.0)
    row = batch_merge_row(torch, "complete", D, alive, sizes, limit, cand,
                          alive.sum(1).to(torch.float64), reps, 4 * B * n * n, l2_rate)
    rows["lw_merge_batch"][f"B={B} n={n} all live"] = {
        k: row[k] for k in ("path", "ms", "read_bytes_per_s")}
    del D, alive, sizes, limit, cand
    torch.cuda.empty_cache()
    for B, n, ragged in ARGMIN_SEED_SHAPES:    # B1 on the seed states the main path gives it
        D, alive = batch_seed_state(torch, B, n, ragged, seed=13)
        argmin_rows(f"B={B} n={n} seed" + (" ragged" if ragged else ""), D, alive,
                    4 * B * n * n)
        del D, alive
        torch.cuda.empty_cache()
    for B, n in ARGMIN_FLOOR_SHAPES:           # a lane's fixed cost
        D, alive = batch_seed_state(torch, B, n, False, seed=13)
        alive[:, 2:] = False
        argmin_rows(f"B={B} n={n} two live", D, alive, 4 * B * n * n)
        del D, alive
    print(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]), "rows": rows,
                      "plan_sweep_ms": sweep, "resources": resource_report(torch),
                      "ptxas_b1": ptxas, "card": gpu_line()}))
    return 0


def store_yardsticks(torch, D, reps: int) -> dict:
    """Yardsticks of a lockstep merge's stores over the bucket ``D`` (which
    they overwrite), each one torch copy a call: into column c of every lane
    (n scattered 4-byte stores a lane, each into another row), into columns
    c … c + 7 (a whole 32-byte sector a row), and into row c; each call on
    the next sector's columns or the next row."""
    import itertools

    B, n, _ = D.shape
    src, src8 = torch.rand(B, n, device="cuda"), torch.rand(B, n, 8, device="cuda")
    cols, rows = itertools.cycle(range(0, n, 8)), itertools.cycle(range(n))
    sectors = itertools.cycle(range(0, n - 7, 8))
    return dict(column_store_ms=time_ms(torch, lambda: D[:, :, next(cols)].copy_(src), reps=reps),
                sector_store_ms=time_ms(
                    torch, lambda: D[:, :, (c := next(sectors)):c + 8].copy_(src8), reps=reps),
                row_store_ms=time_ms(torch, lambda: D[:, next(rows), :].copy_(src), reps=reps))


def lazy_kernel_split(torch, D, alive, sizes, limit, reps: int) -> dict:
    """Device µs a lockstep merge of each kernel that B3's batch form
    launches, from the profiler's records of ``reps`` merges of a fresh
    mid-run bucket."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch
    from repro_torch.kernels import lw_update

    B, n = alive.shape
    rmin, rarg = masked_row_mins_batch(D, alive)
    b = lw_update.lazy_batch_buffers(D.clone(), alive.clone(), sizes.clone(),
                                     torch.zeros((B, n, 4), device="cuda"),
                                     cached_cand_batch(alive, rmin, rarg), (rmin, rarg), 0, limit)
    lw_update.lazy_merge_batch("complete", b)     # loads the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            lw_update.lazy_merge_batch("complete", b)
        torch.cuda.synchronize()
    ns = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA and "lazy" in name:
            key = next(w for w in name.replace("(", " ").replace("<", " ").split()
                       if "lazy" in w).split("::")[-1]
            ns[key] = ns.get(key, 0) + e.duration_ns()
    return {k: v / 1e3 / reps for k, v in ns.items()}


def sweep_plans(module, plan_fn: str, plans, measure) -> dict:
    """``measure(plan)``, the ms of a batch form with its checks, under each
    of ``plans``, ``module``'s plan function ``plan_fn`` patched to return
    it."""
    planned, out = getattr(module, plan_fn), {}
    try:
        for plan in plans:
            setattr(module, plan_fn, lambda *args, plan=plan, **kwargs: plan)
            out[str(plan)] = measure(plan)
    finally:
        setattr(module, plan_fn, planned)
    return out


def merge_measure(torch, merge, b0, bp, reps: int, what: str):
    """:func:`sweep_plans`' ``measure`` of a batch merge entry: ``merge``
    ("complete") timed as phase 2 times it over ``reps`` merges from the
    buffers ``b0``, then held against the plain twin's buffers ``bp`` after
    as many (its stale list and sync words aside)."""
    def measure(plan):
        bk = type(b0)(*(t.clone() for t in b0))
        ms = time_merges(torch, lambda b: merge("complete", b), b0, bk, reps=reps)
        check_batch_buffers(torch, bk, bp, f"{what} {plan}", skip=("stale", "sync"))
        return ms
    return measure


def plan_sweep(torch, D, alive, sizes, limit, cand, reps: int) -> dict:
    """B2's batch form with 1, 2, 4 and 8 blocks a lane (as many as give each
    block a bitmask word of rows); on the bulk-copy path with wider row
    groups, with rows in registers instead (a warp a row, 8 float4 a
    thread) and, for rows in chunks, with 256 threads a block: the
    measurement behind merge_batch_plan's cuts (:func:`sweep_plans`)."""
    from repro_torch.kernels import lw_step

    B, n = alive.shape
    b0 = lw_step.merge_batch_buffers(D, alive, sizes, torch.zeros((B, n, 4), device="cuda"),
                                     cand, 0, limit)
    bp = lw_step.MergeBatchBuffers(*(t.clone() for t in b0))
    for _ in range(reps):
        lw_step.lw_merge_batch_plain("complete", bp)
    planned = lw_step.merge_batch_plan(B, n,
                                       torch.cuda.get_device_properties(0).multi_processor_count)
    plans = [planned._replace(blocks=k) for k in (1, 2, 4, 8) if 32 * k <= n]
    if planned.unroll == 0:
        plans += [planned._replace(group=g) for g in (8, 16, 32) if g > planned.group]
        plans.append(lw_step.BatchPlan(32, 8, 256, planned.blocks))
        if n > 1024:
            plans.append(planned._replace(threads=256))
    return sweep_plans(lw_step, "merge_batch_plan", plans,
                       merge_measure(torch, lw_step.lw_merge_batch, b0, bp, reps,
                                     f"lw_merge_batch B={B} n={n}"))


def lazy_plan_sweep(torch, D, alive, sizes, limit, reps: int) -> dict:
    """B3's batch form with 1, 2, 4 and 8 blocks a lane (as many as give
    each block 32 columns or more): the measurement behind
    lazy_batch_plan's cut (:func:`sweep_plans`)."""
    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch
    from repro_torch.kernels import lw_update

    B, n = alive.shape
    rmin, rarg = masked_row_mins_batch(D, alive)
    b0 = lw_update.lazy_batch_buffers(D, alive, sizes, torch.zeros((B, n, 4), device="cuda"),
                                      cached_cand_batch(alive, rmin, rarg), (rmin, rarg), 0,
                                      limit)
    bp = lw_update.LazyBatchBuffers(*(t.clone() for t in b0))
    for _ in range(reps):
        lw_update.lazy_merge_batch_plain("complete", bp)
    planned = lw_update.lazy_batch_plan(B, n,
                                        torch.cuda.get_device_properties(0).multi_processor_count)
    plans = [planned._replace(blocks=k) for k in (1, 2, 4, 8) if 32 * k <= n]
    return sweep_plans(lw_update, "lazy_batch_plan", plans,
                       merge_measure(torch, lw_update.lazy_merge_batch, b0, bp, reps,
                                     f"lazy_merge_batch B={B} n={n}"))


def argmin_plan_sweep(torch, D, alive) -> dict:
    """B1's batch form under the plans around the one it takes, each held
    against its plain twin bit for bit (:func:`sweep_plans`): on the warp
    path a block a lane in registers instead; else 1, 2, 4 and 8 blocks a
    lane (as many as give each block a bitmask word of rows); from 65 to 256 slots
    one pass in registers against bulk copies; on the bulk-copy path wider
    row groups, rows in registers instead (a warp a row, 8 float4 a thread)
    and, for rows in chunks, 256 threads a block: the measurement behind
    argmin_batch_plan's cuts."""
    from repro_torch.kernels import minscan

    B, n = alive.shape
    want = minscan.masked_argmin_batch_plain(D, alive)
    planned = argmin_plan(torch, B, n)
    if planned.group == 0:
        plans = [planned, minscan.ArgminPlan(4, 4, 256, 1)]
    else:
        plans = [planned._replace(blocks=k) for k in (1, 2, 4, 8) if 32 * k <= n]
        if 64 < n <= 256 and n % 4 == 0:
            group = 4 if n <= 128 else 8
            plans += [minscan.ArgminPlan(group, 8, 512, planned.blocks),
                      minscan.ArgminPlan(group, 0, 256, planned.blocks)]
        if planned.unroll == 0:
            plans += [planned._replace(group=g) for g in (8, 16, 32) if g > planned.group]
            plans.append(minscan.ArgminPlan(32, 8, 256, planned.blocks))
            if n > 1024:
                plans.append(planned._replace(threads=256))

    def measure(plan):
        got = minscan.masked_argmin_batch(D, alive)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"masked_argmin_batch B={B} n={n} {plan}: differs from plain")
        return time_ms(torch, lambda: minscan.masked_argmin_batch(D, alive))
    return sweep_plans(minscan, "argmin_batch_plan", plans, measure)


if __name__ == "__main__":
    if sys.argv[1:2] == [SINGLE_TIMES_FLAG]:
        sys.exit(single_kernel_times((sys.argv[2:3] or [None])[0]))
    if sys.argv[1:2] == [BATCH_TIMES_FLAG]:
        sys.exit(batch_kernel_times((sys.argv[2:3] or [None])[0]))
    sys.exit(child(sys.argv[1]) if sys.argv[1:2] and sys.argv[1] in CHILDREN else main())
