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
   the row update checked for all 7 methods; B1's single entry also on
   the all-live state a stage's seed finds), the row kernel at
   (m, d) = (1968, 64), (8192, 128) and (32768, 128) (phase 16's shard
   shapes), and there its vote entry (a rank's vote of a sharded trip) bit
   for bit the composition it replaces (the row entry, then the torch
   epilogue), timed beside it, its trip entry (a whole chain trip,
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
   16 MiB buffer), else the HBM rate.  Every bound counts its kernel's work
   with ``repro_torch.roofline.cost`` and takes the card's peaks from
   ``repro_torch.roofline.hw``.
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
    service (programs built, graphs captured, each program's bytes and
    cost profile: its analytic flops and bytes a dispatch, one for every
    cached program), runs
    open loop (requests a second, p50/p99 latency, pad waste) and again
    under the profiler (busy time and idle share of the steady window).
    Gates: no program built and no graph captured after warmup; no
    request failed, shed, expired or unresolved; 64 sampled responses
    equal ``cluster_batch`` of the same problems (LW bit for bit, the
    chain as dendrograms); on the kernel engine, the launches of the
    dispatched buckets' plans.
15. The paper's distributed LW loop (``repro_torch.core.distributed``) on a
    world-size-1 NCCL group, the card's machine holding one GPU: at the
    paper's configuration ``distributed_lance_williams`` for ``baseline``,
    ``rowmin`` and ``lazy``, staged and unstaged, each equal bit for bit
    to the serial backend's run on the card (whose slots are phase 3's),
    with its wall (the staged ``baseline`` run also with busy time, idle
    share, host and device ms a merge over a profiled second run; the
    staged ``rowmin`` and ``lazy`` runs in ``--distributed-full``), the
    collectives it launched (two a merge, one a stage's seed and one a
    boundary) and its block at each stage; ``cluster(...,
    backend="distributed")``; the born-sharded rmsd build of phase 12's
    conformations against the CPU's; and ``cluster_batch(...,
    backend="distributed")`` at the bench setting against the serial
    batch.  It launches no kernel; the group is torn down at the end.
    ``python3 chip_smoke.py --distributed-full`` runs the full size
    (n = 16384, staged) alone: the wall, the peak memory and the block's
    bytes at each stage, the slots the kernel backend's.
16. The sharded matrix-free NN chain (``distributed_nn_chain_from_points``)
    on a world-size-1 NCCL group, B5's vote entry launched once a trip (the
    trips), no other kernel, three collectives a trip: at the paper's size
    (n = 1968, d = 64) for ward, average and weighted, bit for bit the
    host-driven chain loop with B5's row entry on the card, with its wall
    (ward's with busy time, idle share and host and device ms a trip over a
    profiled window of 500 merges, in a process of its own); the
    ward run again segmented (segments of 500 merges, a shard lost at
    segment 1, a straggler deadline), equal to the unsegmented one, with
    its restarts, stragglers and segments; ``cluster(...,
    algorithm="nnchain", backend="distributed")``.  The runs at n = 8192,
    d = 128 and the full-width one (phase 6's n = 32768, d = 128 ward
    points: wall, trips, peak memory under 0.25 GiB, the resident chain's
    dendrogram, host and device ms a trip over a profiled window of 500
    merges), each with busy time, idle share and host and device ms a trip
    over a profiled window (the same points' first 500 merges, run again
    in a process of its own: later profiling sessions of a process lost
    kernel records), are ``--distributed-full``, for the smoke's time.
17. The two-phase tier (``two_phase_from_points``), B5's trip entry in
    both phases and no other kernel: on phase 11's points (n = 131072,
    d = 128, ward, 8 shards of 16384, 1024 summaries) n - 1 merges in the
    global slot convention, a valid dendrogram with monotone heights, ARI
    >= 0.95 at the 8-cut against the mixture's labels, peak memory under
    0.25 GiB, trip launches = 256 x the replays of all nine chains (at
    least their trips), the profiler agreeing; wall, busy time, idle
    share, each phase's trips and host and device ms a trip, the host
    seconds of the replays and the canonicalisations.  B5's trip entry
    against its plain twin from phase 2's seed (1024 summaries of sizes
    other than 1; ``u`` other than 0 for average and weighted), timed
    with its bound and ``cdist``'s row.  At n = 32768, d = 128 against the
    exact chain: the 8-cuts agree (ARI >= 0.95) on phase 6's points, and
    merge-set agreement >= 0.5 on the reference's own benchmark data.  At
    the paper's n = 1968 the card's run equals the CPU's for ward, average
    and weighted.  ``cluster(..., algorithm="twophase")`` reports the
    serial backend, and the distributed one on a world-size-1 NCCL group,
    with the same merges.  The entry points (ENTRY_POINTS: the quickstart
    and protein examples, ``repro_torch.launch.cluster_run`` in both
    modes) each exit 0 at their defaults, their lines carried here.
18. The paper's baselines (``repro_torch.core.baselines``), no kernel of
    the port: ``kmeans`` (50 Lloyd iterations) on the paper's points
    (n = 1968, d = 64, k = 8) and on 65536 points in 128-D at k = 64: wall,
    busy, idle, peak, inertia; the same seed gives the same result bit for
    bit; each of the CPU's 50 Lloyd steps from the card's seeds against the
    card's step from the same centroids (labels equal but on near-ties,
    new centroids within rtol/atol 1e-5 of the CPU's update of the card's
    labels), and the CPU's final inertia within rtol 1e-4 of the card's
    run; a Lloyd iteration's ms against its roofline.  ``mst_single_linkage`` on phase
    3's and phase 4's matrices (n = 1968 and 16384): wall, peak, launches
    (busy and idle at n = 1968); its merges the CPU's bit for bit, the LW
    loop's single linkage on the card its sorted heights (rtol 1e-4 / atol
    1e-5) and its cuts at every k (a run of merges tied within twice the
    largest height gap between the two ends on the same partition).
19. The LM stack's serving path (``repro_torch.launch.serve``: prefill,
    then greedy decode), no kernel of the port launched: (a) gemma3-1b at
    full width and all 26 layers in float32, weights from a seeded
    generator, 4 prompts of 1024 tokens (past the 512 window) and 16 new
    tokens, each step's logits within rtol/atol 2e-3 of the full forward's
    at that position, and the cache's ``cur`` and ``kv_pos`` advancing; (b)
    the same weights cut to 2 layers on the card and on the CPU, TF32 off:
    prefill logits and 4 decode steps within rtol/atol 1e-4; (c) gemma3-1b's
    own config in bf16 serving 16 requests in batches of 8 (prompts of 1024,
    64 new tokens): from a run that keeps no logits, prefill ms, decode ms
    a step, tokens a second and peak memory; the busy time and idle share
    of a window of the decode loop (LM_LOOP_STEPS steps of the first batch,
    profiled); prefill's ``model_flops`` over the bf16 peak; from a second
    run that keeps every step's logits, every logit finite and every
    request answered, and the first token's logits against the float32
    run's (gap and top-1 agreement, reported); (d) chatglm3-6b and
    deepseek-coder-33b (2 layers) and llama3-405b (1 layer) at full width
    in float32, 2 prompts of 256, 4 decode steps.  With the spec's init
    the float32 gaps to the full forward are reported (its attention is a
    hard argmax at these widths: ``lm_unit_attention``), and the check is
    gated in float64, every op of the model in float64
    (``lm_float64_witness``), where the model fits the card so, else in
    float32; then, with the attention weights rescaled to a true fan-in,
    each float32 step within 2e-3 of the full forward.
20. One line ``{"kernels": [...]}`` with each kernel's numbers (the batch
    entries beside the others, with their launches in the service's card
    mix; B5's vote entry with its launches in phase 16, its row entry with
    those of phase 16's host-driven reference loop; B5's trip entry
    from phase 17's summary seeds), the card's ``nvidia-smi`` line, and
    last ``{"ok": true, "device": {...}}``.

Every path is driven with the launch counters set to 0 just before it
and read just after.  Phase 6's profiled chain run (``--profile-chain``),
phases 10-12 (``--later-phases``), phase 13 (``--batch``), phase 14
(``--service``), phase 15 (``--distributed``), phase 16
(``--sharded-chain``), phase 17 (``--two-phase``), phase 18
(``--baselines``) and phase 19 (``--lm-serve``) run in child processes of
this script, for the profiler's sake (``run_child``).

Needs one CUDA device and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import contextlib
import json
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

L2_PROBE_MIB, L2_PROBE_REPS = 16, 16   # the L2 probe reads a 16 MiB buffer 16 times a launch
PAPER_N, FULL_N, DIM = 1968, 16384, 64
CHAIN_N, CHAIN_DIM = 32768, 128  # matrix-free run: 16 MiB of summaries, no 4 GiB matrix
CROSS_SHAPES = ((4096, 128), (1968, 64))   # matrix-free ward held against the LW loop
MID_N = 8192                   # phases 5, 7, 8: n = 16384 until the smoke outgrew 700 s
ROW_SHAPES = ((PAPER_N, DIM), (MID_N, CHAIN_DIM), (CHAIN_N, CHAIN_DIM))  # sharded chains: B5 a shard
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
SHARDED_METHODS = ("ward", "average", "weighted")  # phase 16 at PAPER_N; n = MID_N in
                                                   # --distributed-full
SHARDED_SEGMENT = 500          # phase 16's segmented run at the paper's size: 4 segments
SHARDED_WINDOW = 500           # merges of a sharded run's profiled window (~1500 trips)
TWO_PHASE_SHARDS = 8           # phase 17: shards of 16384 at n = LANDMARK_N, K = 1024 summaries
TWO_PHASE_AGREEMENT_MIN = 0.5  # on its data, benchmarks/bench_distributed.py:209-225
# phase 17: the entry points a user starts, each run at its defaults on the card
ENTRY_POINTS = {"quickstart": ("examples/quickstart_torch.py",),
                "protein": ("examples/protein_clustering_torch.py",),
                "cluster_run embed": ("-m", "repro_torch.launch.cluster_run", "--mode", "embed"),
                "cluster_run rmsd": ("-m", "repro_torch.launch.cluster_run", "--mode", "rmsd")}
RTOL, ATOL = 1e-4, 1e-5        # height tolerance of the JAX package's kernel tests
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
KERNEL_SYMBOLS = {             # wrapper -> its device functions, the first once a launch
    "masked_argmin": ("masked_row_min",),
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
    "chain_vote": ("chain_vote_kernel",),
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


def bound(torch, work, resident_bytes: float, l2_rate: float) -> dict:
    """The least ms the card could take for the ``work`` (a
    ``repro_torch.roofline.Cost``: its bytes and its float32 operations),
    what bounds it, and the byte rate taken: the L2 read rate when the
    ``resident_bytes`` that a timed run keeps touching fit in half the L2
    (they stay there between launches), else the HBM rate; and the bound
    at the HBM rate."""
    from repro_torch.roofline import analyze, hw

    in_l2 = resident_bytes <= hw.l2_bytes(0) / 2
    roof = analyze(work, byte_rate=l2_rate if in_l2 else hw.HBM_BW)
    return dict(bound_ms=roof.bound_s * 1e3,
                bound_by="bytes" if roof.memory_s >= roof.compute_s else "operations",
                bound_bytes_per_s=roof.byte_rate, hbm_bound_ms=analyze(work).bound_s * 1e3)


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
    out["masked_argmin"] = argmin_row(torch, D, alive, l2_rate)
    # the state a stage's seed finds: compaction leaves every slot live
    out["masked_argmin/seed"] = argmin_row(torch, D, torch.ones_like(alive), l2_rate)

    for method in ("complete", "ward"):
        state = mid_run_state(torch, n, squared=method == "ward", seed=2)
        out[f"lw_step/{method}"] = phase_step(torch, method, *state, l2_rate)
        out[f"lw_merge/{method}"] = phase_merge(torch, method, *state, l2_rate)
        del state
    out["lw_update/complete"] = phase_row_update(torch, n, l2_rate)
    return out


def argmin_row(torch, D, alive, l2_rate: float) -> dict:
    """B1's single entry against its plain version on ``(D, alive)``, bit
    for bit, and timed."""
    from repro_torch.kernels import minscan
    from repro_torch.roofline import cost

    n, live = D.shape[0], int(alive.sum())
    v, flat = minscan.masked_argmin(D, alive)
    vp, flatp = minscan.masked_argmin_plain(D, alive)
    if not (torch.equal(v, vp) and torch.equal(flat, flatp)):
        raise AssertionError(f"masked_argmin n={n} live={live}: kernel "
                             f"{(float(v), int(flat))} != plain {(float(vp), int(flatp))}")
    # read the live submatrix and alive, write one value and one index;
    # one compare a live cell; the timed launches keep touching D
    return dict(n=n, live=live, max_abs_err=abs(float(v) - float(vp)),
                ms=time_ms(torch, lambda: minscan.masked_argmin(D, alive)),
                plain_ms=time_ms(torch, lambda: minscan.masked_argmin_plain(D, alive)),
                host_us=host_us(torch, lambda: minscan.masked_argmin(D, alive)),
                **bound(torch, cost.masked_argmin(n, live), 4 * n * n, l2_rate))


def step_bound(torch, n: int, live: float, l2_rate: float) -> dict:
    """The step's bound with ``live`` slots live after the merge
    (``cost.lw_step``); the timed launches keep touching D."""
    from repro_torch.roofline import cost

    return bound(torch, cost.lw_step(n, live), 4 * n * n, l2_rate)


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
    from repro_torch.roofline import cost

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
    work = cost.lw_update("complete", n, live)
    return dict(n=n, live=live, methods_checked=len(METHODS), max_abs_err=err,
                bit_equal=bit_equal,
                ms=time_ms(torch, lambda: lw_update.lw_update(*a)),
                plain_ms=time_ms(torch, lambda: lw_update.lw_update_plain(*a)),
                library_ms=None,
                host_us=host_us(torch, lambda: lw_update.lw_update(*a)),
                plain_host_us=host_us(torch, lambda: lw_update.lw_update_plain(*a)),
                **bound(torch, work, work.bytes, l2_rate))


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
    from repro_torch.roofline import cost

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
    return dict(n=n, live=live, methods_checked=len(METHODS), checked_merges=LAZY_CHECKS,
                max_abs_err=err, bit_equal=True, ms=ms, plain_ms=plain_ms,
                graph_ms_per_merge=replay_ms / THRESHOLD_CHECK_TRIPS,
                stale_rows_per_merge=stale, changed_entries_per_merge=changed, library_ms=None,
                host_us=host_us(torch, lambda: lw_update.lazy_merge("complete", b)),
                **bound(torch, cost.lazy_merge(n, live, stale, changed), 4 * n * n, l2_rate))


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
    from repro_torch.roofline import cost

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
        **bound(torch, cost.masked_argmin_batch(n, live), resident, l2_rate))


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
    from repro_torch.roofline import cost

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
        **bound(torch, cost.lw_merge_batch(n, live_mean), resident, l2_rate))


def batch_lazy_row(torch, method: str, D, alive, sizes, limit, live, reps: int,
                   resident: float, l2_rate: float) -> dict:
    """B3's batch lazy merge against its plain twin and the single lazy
    merge, bit for bit, timed; with the plan it took, its kernel's
    registers, local bytes and blocks an SM, and the bytes a merge must move
    at the rate it reached."""
    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch
    from repro_torch.kernels import lw_update
    from repro_torch.roofline import cost

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
    work = cost.lazy_merge_batch(n, live_mean, stale, changed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(
        B=B, n=n, path=str(lw_update.lazy_batch_plan(B, n, sms)),
        live_mean=float(live_mean.mean()), max_abs_err=err, bit_equal=True, single_checked=B,
        merges_checked=reps, stale_rows_per_merge=float(stale.mean()),
        changed_entries_per_merge=float(changed.mean()), ms=ms, plain_ms=plain_ms,
        library_ms=None, bytes_per_s=work.bytes / (ms * 1e-3),
        **lw_update.lazy_batch_resources(method, n, lanes=B),
        **bound(torch, work, resident, l2_rate))


def phase_row(torch, m: int, d: int, l2_rate: float) -> dict:
    """The row kernel against its plain version at (m, d), with the time
    of the one PyTorch call that gives the same row (``cdist``, which also
    takes the square root), and each one's host time to enqueue a call."""
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import pairwise
    from repro_torch.roofline import cost

    Y = torch.as_tensor(gaussian_mixture(seed=3, n=m, dim=d, return_labels=False),
                        dtype=torch.float32, device="cuda")
    x = Y[m // 3]
    got = pairwise.row_sq_euclidean(x, Y)
    want = pairwise.row_sq_euclidean_plain(x, Y)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise AssertionError(f"row_sq_euclidean m={m} d={d}: kernel differs from plain")
    work = cost.row_sq_euclidean(m, d)
    return dict(m=m, d=d, max_abs_err=float((got - want).abs().max()),
                ms=time_ms(torch, lambda: pairwise.row_sq_euclidean(x, Y)),
                plain_ms=time_ms(torch, lambda: pairwise.row_sq_euclidean_plain(x, Y)),
                library_ms=time_ms(torch, lambda: torch.cdist(x[None], Y)),
                host_us=host_us(torch, lambda: pairwise.row_sq_euclidean(x, Y)),
                plain_host_us=host_us(torch, lambda: pairwise.row_sq_euclidean_plain(x, Y)),
                **bound(torch, work, work.bytes, l2_rate))


def phase_vote(torch, m: int, d: int, l2_rate: float) -> dict:
    """B5's vote entry at phase 16's block shape (m, d), one NCCL rank's
    whole block, on the first state of a ward run (unit sizes, every slot
    live; the tip m // 3, prev m // 2): bit for bit the composition it
    replaces (B5's row entry, then the torch epilogue), and timed beside
    it (``composition_ms``, the "before") and beside the plain twin; each
    one's host time to enqueue a call.  Then both again with half the
    slots dead, as a run finds them half way (``half_dead_ms``)."""
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import pairwise
    from repro_torch.roofline import cost

    W = torch.as_tensor(gaussian_mixture(seed=3, n=m, dim=d, return_labels=False),
                        dtype=torch.float32, device="cuda")
    u, sizes = torch.zeros(m, device="cuda"), torch.ones(m, device="cuda")
    alive = torch.ones(m, dtype=torch.bool, device="cuda")
    top, prev = m // 3, m // 2
    tip = W[top].clone()
    buf, ref = pairwise.vote_buffers("cuda"), pairwise.vote_buffers("cuda")
    args = ("ward", tip, W, u, sizes, alive, top, prev, 0)

    def vote():
        return pairwise.chain_vote(*args, buf)

    def composed():
        return pairwise.chain_vote_plain(*args, ref, row_sq=pairwise.row_sq_euclidean)

    got, want = vote().clone(), composed().clone()
    plain = pairwise.chain_vote_plain(*args, pairwise.vote_buffers("cuda"))
    if not torch.equal(got, want):
        raise AssertionError(f"chain_vote m={m} d={d}: {got.tolist()} != the composition's "
                             f"{want.tolist()}")
    values = [0, 2]         # the plain row sums in torch's order: its slot may part at a near-tie
    if not torch.allclose(got[values], plain[values], rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise AssertionError(f"chain_vote m={m} d={d}: {got.tolist()} far from the plain "
                             f"twin's {plain.tolist()}")
    if buf.sync[:2].tolist() != [-1, 0]:
        raise AssertionError(f"chain_vote m={m} d={d}: left its key/ticket at {buf.sync}")
    work = cost.chain_vote(m, d)
    return dict(m=m, d=d, max_abs_err=float((got[values] - plain[values]).abs().max()),
                ms=time_ms(torch, vote), composition_ms=time_ms(torch, composed),
                plain_ms=time_ms(torch, lambda: pairwise.chain_vote_plain(*args, ref)),
                library_ms=None, host_us=host_us(torch, vote),
                composition_host_us=host_us(torch, composed),
                **bound(torch, work, work.bytes, l2_rate),
                **half_dead_vote(torch, args, buf, ref))


def half_dead_vote(torch, args, buf, ref) -> dict:
    """:func:`phase_vote`'s vote and composition with every other slot
    dead (the tip and prev live), bit for bit and timed."""
    from repro_torch.kernels import pairwise

    method, tip, W, u, sizes, alive, top, prev, offset = args
    alive = alive.clone()
    alive[1::2] = False
    alive[[top, prev]] = True
    args = (method, tip, W, u, torch.where(alive, sizes, 0.0), alive, top, prev, offset)
    got = pairwise.chain_vote(*args, buf).clone()
    want = pairwise.chain_vote_plain(*args, ref, row_sq=pairwise.row_sq_euclidean)
    if not torch.equal(got, want):
        raise AssertionError(f"chain_vote, half dead: {got.tolist()} != the composition's "
                             f"{want.tolist()}")
    return dict(half_dead_ms=time_ms(torch, lambda: pairwise.chain_vote(*args, buf)),
                half_dead_composition_ms=time_ms(torch, lambda: pairwise.chain_vote_plain(
                    *args, ref, row_sq=pairwise.row_sq_euclidean)))


def phase_trip(torch, m: int, d: int, l2_rate: float) -> dict:
    """B5's trip entry, the matrix-free chain's main path, from the first
    state of a ward run on one mixture's points (:func:`trip_row`)."""
    from repro_torch.data.synthetic import gaussian_mixture

    X = torch.as_tensor(gaussian_mixture(seed=3, n=m, dim=d, return_labels=False),
                        dtype=torch.float32, device="cuda")
    return trip_row(torch, "ward", X, torch.zeros(m, device="cuda"), torch.ones(m, device="cuda"),
                    f"chain_trip m={m} d={d}", l2_rate)


def trip_row(torch, method: str, W, u, sizes, what: str, l2_rate: float) -> dict:
    """B5's trip entry against its plain twin on the card, from the state
    of a run's first trip over the summaries ``(W, u, sizes)`` (a leaf's:
    unit sizes and ``u = 0``; phase 2's of the two-phase tier: whole
    clusters): TRIP_CHECKS trips, the same decisions (every count, slot,
    size and liveness equal) and the summaries within the row's float
    error.  Then timed from the state those trips reach: MERGE_REPS trips
    launched one by one, and one graph replay of CHAIN_GRAPH_TRIPS trips;
    with ``cdist``'s row as the library call."""
    from repro_torch.core.nnchain import CHAIN_GRAPH_TRIPS
    from repro_torch.kernels import pairwise
    from repro_torch.roofline import cost

    m, d = W.shape

    def fresh():
        return pairwise.chain_buffers(W.clone(), u.clone(),
                                      torch.ones(m, dtype=torch.bool, device="cuda"),
                                      sizes.clone(), m - 1)

    bk, bp = fresh(), fresh()
    for _ in range(TRIP_CHECKS):
        pairwise.chain_trip(method, bk)
        pairwise.chain_trip_plain(method, bp)
    torch.cuda.synchronize()
    for name in ("alive", "bits", "sizes", "chain", "count"):
        if not torch.equal(getattr(bk, name), getattr(bp, name)):
            raise AssertionError(f"{what}: {name} differs from the plain twin")
    if not torch.equal(bk.merges[:, [0, 1, 3]], bp.merges[:, [0, 1, 3]]):
        raise AssertionError(f"{what}: merge slots differ from the plain twin")
    if bk.sync[:2].tolist() != [-1, 0]:
        raise AssertionError(f"{what}: the kernel left its key/ticket at {bk.sync}")
    err = 0.0
    for a, b in ((bk.W, bp.W), (bk.u, bp.u), (bk.merges, bp.merges)):
        if not torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise AssertionError(f"{what}: summaries or heights differ from the plain twin")
        err = max(err, float((a - b).abs().max()))
    length, merged, _, _ = bk.count.tolist()
    b0 = [t.clone() for t in bk[:9]]
    ms = time_merges(torch, lambda _: pairwise.chain_trip(method, bk), b0, bk[:9])
    plain_ms = time_merges(torch, lambda _: pairwise.chain_trip_plain(method, bk), b0, bk[:9])
    for dst, src in zip(bk[:9], b0):
        dst.copy_(src)
    graph = pairwise.TripGraph(method, bk, CHAIN_GRAPH_TRIPS)
    replay_ms = time_merges(torch, lambda _: graph.replay(), b0, bk[:9], reps=1)
    x = W[m // 3]
    work = cost.chain_trip(m, d)
    return dict(m=m, d=d, method=method, checked_trips=TRIP_CHECKS, merges_in_check=merged,
                chain_length=length, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                graph_ms_per_trip=replay_ms / CHAIN_GRAPH_TRIPS,
                library_ms=time_ms(torch, lambda: torch.cdist(x[None], W)),
                host_us=host_us(torch, lambda: pairwise.chain_trip(method, bk)),
                **bound(torch, work, work.bytes, l2_rate))


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
    from repro_torch.roofline import cost

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
    work = cost.pairwise_sq_euclidean(n, m, d)
    return dict(n=n, m=m, d=d, max_abs_err=err, rtol=PAIRWISE_RTOL, atol=atol,
                ms=time_ms(torch, lambda: pairwise.pairwise_sq_euclidean(X, Y), reps=5),
                plain_ms=time_ms(torch, lambda: pairwise.pairwise_sq_euclidean_plain(X, Y), reps=5),
                library_ms=time_ms(torch, lambda: torch.cdist(X, Y), reps=5),
                host_us=host_us(torch, lambda: pairwise.pairwise_sq_euclidean(X, Y)),
                plain_host_us=host_us(torch, lambda: pairwise.pairwise_sq_euclidean_plain(X, Y)),
                **bound(torch, work, work.bytes, l2_rate))


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
    pairwise.chain_vote.launches = 0
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
            "chain_vote": pairwise.chain_vote.launches,
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


def device_busy(torch, call, wall_s: float, launches: dict, tail: dict | None = None):
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
    wall.  ``tail`` ``{kernel: k}`` also sums the device ms of each
    kernel's last ``k`` launches by start time (``tail_ms``: the end of a
    run that launches one kernel in two parts).  Returns what the last run
    of ``call`` returned, and the numbers."""
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
        starts = {k: [] for k in tail or {}}
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
                    if kernel in starts and symbols[0] in name:
                        starts[kernel].append((e.start_ns(), ns))
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
    tail_ms = {}
    for kernel, count in (tail or {}).items():
        last = sorted(starts[kernel])[max(len(starts[kernel]) - count, 0):]
        tail_ms[kernel] = sum(ns for _, ns in last) / 1e6
    return res, dict(device_busy_s=busy_s, idle_share=1 - busy_s / (wall_s or profiled_wall),
                     profiled_wall_s=profiled_wall, profiler_missed=missed,
                     profiler_tries=tries,
                     kernel_ms_mean={k: kernel_ns[k] / 1e6 / max(kernel_n[k], 1)
                                     for k in kernel_ns},
                     kernel_busy_share={k: kernel_ns[k] / busy_ns for k in kernel_ns},
                     tail_ms=tail_ms)


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


def phase_serial(torch, np, X, paper_X, paper_merges) -> tuple:
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
    paper_serial = {}
    for variant in ("rowmin", "lazy"):
        r, s = timed(torch, lambda: cluster(paper_X, "complete", algorithm="lw", variant=variant,
                                            keep_inputs=False))
        check_lw_run(s, "serial", variant, PAPER_N, f"serial {variant} run")
        if r.backend != "serial":
            raise AssertionError(f"serial {variant} run reported {r.backend}")
        check_merges(np, r.merges, paper_merges, f"serial {variant} vs phase 3, n={PAPER_N}")
        stats[f"paper_{variant}_wall_s"] = s["wall_s"]
        paper_serial[variant] = r.merges
    # the cached variants find the serial baseline's candidates exactly: one record
    check_bit_equal(np, paper_serial["rowmin"], paper_serial["lazy"], "serial rowmin vs lazy")
    return stats, paper_serial["rowmin"]


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


def kabsch64(np, a, b) -> float:
    """The Kabsch RMSD of two ``(atoms, 3)`` conformations in float64
    (numpy's SVD): the value a float32 build of the pair should round to."""
    a = np.asarray(a, np.float64) - np.asarray(a, np.float64).mean(0)
    b = np.asarray(b, np.float64) - np.asarray(b, np.float64).mean(0)
    H = a.T @ b
    s = np.linalg.svd(H, compute_uv=False)
    corr = s[0] + s[1] + np.sign(np.linalg.det(H)) * s[2]
    return float(np.sqrt(max(((a * a).sum() + (b * b).sum() - 2.0 * corr) / len(a), 0.0)))


def check_rmsd_matrix(torch, np, C, D_card, D_cpu, what: str) -> float:
    """Hold the card's rmsd matrix against the CPU's build (RTOL,
    RMSD_ATOL) and return the largest difference.  On a mismatch the
    error names the worst pair, both builds' values and the pair's
    float64 Kabsch RMSD, which tells which build is off."""
    err = float((D_card - D_cpu).abs().max())
    if not torch.allclose(D_card, D_cpu, rtol=RTOL, atol=RMSD_ATOL):
        r, c = divmod(int((D_card - D_cpu).abs().argmax()), D_card.shape[1])
        raise AssertionError(f"{what} differs from the CPU's by {err} at ({r}, {c}): "
                             f"{float(D_card[r, c])} against {float(D_cpu[r, c])}; float64 "
                             f"Kabsch {kabsch64(np, C[r], C[c])}")
    return err


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
    err = check_rmsd_matrix(torch, np, C, D_card, D_cpu, "rmsd matrix on the card")
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
                   programs_gib=sum(p.nbytes for p in progs) / 2**30,
                   cost_profiles=cost_profiles(svc.cache, progs, f"service {name}"))
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


def cost_profiles(cache, progs, what: str) -> dict:
    """Each warmed program's cost profile as the cache keeps it (its
    analytic flops, bytes and collective bytes for one dispatch at the
    bucket's full width), with its intensity and its bound at the HBM rate
    and the float32 peak; every program has one, and no other signature."""
    from repro_torch.roofline import Cost, analyze

    if set(cache.cost_profiles) != {p.sig for p in progs}:
        raise AssertionError(f"{what}: cost profiles for {len(cache.cost_profiles)} signatures, "
                             f"{len(progs)} programs cached")
    return {f"n{p.sig.bucket_n}/B{p.sig.bucket_B}": dict(
        flops=c.flops, bytes=c.bytes, coll_bytes=c.coll_bytes, intensity=c.intensity,
        hbm_bound_ms=analyze(Cost(c.flops, c.bytes, c.coll_bytes)).bound_s * 1e3)
        for p in progs for c in (cache.cost_profiles[p.sig],)}


def phase_service(torch, np, spec: dict) -> dict:
    """Phase 14, in a process of its own (``run_child``): the clustering
    service on the card under each of SERVICE_MIXES."""
    out = {}
    for name, mix in SERVICE_MIXES.items():
        out[name] = service_mix(torch, np, name, mix)
        say(f"phase 14 service {name}: " + json.dumps(out[name]))
        torch.cuda.empty_cache()
    return out


def sharded_collectives(stages: int, merges: int) -> int:
    """The collectives a distributed LW run launches: two a merge (the
    triples' ``all_gather``, the rows' ``all_reduce``), one ``all_gather``
    a stage's seed, and one ``reduce_scatter`` a stage boundary."""
    return 2 * merges + 2 * stages - 1


def distributed_run(torch, np, ring, D, variant: str, compaction: bool, want, what: str,
                    profile: bool = True) -> dict:
    """One ``distributed_lance_williams`` run of ``D`` (complete) on
    ``ring``, as phase 15 drives it: :func:`timed`, no kernel launched, the
    collectives and the rank's block at each stage as the plan says, the
    merges ``want`` bit for bit (``want`` None: not checked here); then,
    with ``profile``, the busy time over a second, profiled run, and the
    host's and the device's ms a merge.  Returns the result and the
    numbers."""
    from repro_torch.core import engine
    from repro_torch.core.distributed import distributed_lance_williams, pad_to_mesh

    def call():
        return distributed_lance_williams(D, "complete", ring, variant, compaction=compaction)

    res, stats = timed(torch, call)
    check_launches(stats["launches"], {}, what)
    n, p = D.shape[0], ring.size
    n_pad = pad_to_mesh(n, p)
    plan = engine.plan_stages(n_pad, n - 1, align=p) if compaction else ((n_pad, n - 1),)
    blocks = tuple((size // p, size) for size, _ in plan)
    if res.collectives != sharded_collectives(len(plan), n - 1) or res.blocks != blocks:
        raise AssertionError(f"{what}: {res.collectives} collectives and blocks {res.blocks}, "
                             f"want {sharded_collectives(len(plan), n - 1)} and {blocks}")
    if want is not None:
        check_bit_equal(np, res.merges.cpu().numpy(), want, f"{what} vs the serial backend")
    if profile:
        stats.update(device_busy(torch, call, stats["wall_s"], stats["launches"])[1])
        stats.update(per_step(stats, n - 1, "merge"))
    keep = ("wall_s", "device_busy_s", "idle_share", "host_ms_per_merge", "device_ms_per_merge",
            "peak_gib", "profiler_tries")
    return res, dict({k: stats[k] for k in keep if k in stats}, collectives=res.collectives,
                     stage_sizes=[size for size, _ in plan],
                     block_bytes=[rows * cols * 4 for rows, cols in res.blocks],
                     reshard_bytes=res.reshard_bytes)


def phase_distributed(torch, np, spec: dict) -> dict:
    """Phase 15, in a process of its own: the paper's distributed LW loop on
    a world-size-1 NCCL group (the card's machine holds one GPU).  At the
    paper's configuration (after the host's µs to enqueue a merge's two
    collectives and one small torch op) ``baseline``, ``rowmin`` and ``lazy``, staged and
    unstaged, each bit for bit phase 7's serial run on the card (whose
    slots are phase 3's; its ``rowmin`` and ``lazy`` runs are one record,
    the serial ``baseline``'s), and ``cluster(..., backend="distributed")``;
    the born-sharded rmsd build against the CPU's; ``cluster_batch`` on the
    distributed engine at the bench setting against the serial batch.  No
    kernel is launched; the group is torn down at the end.  The full-size
    run is ``--distributed-full`` (:func:`distributed_full`): in the smoke
    it took the phase past its time (~175 s with it)."""
    import torch.distributed as dist

    from repro_torch.core import build_distance_matrix, cluster, cluster_batch
    from repro_torch.core.distributed import distributed_pairwise, make_cluster_mesh
    from repro_torch.data.synthetic import conformations, gaussian_mixture

    ring = make_cluster_mesh()
    backend = str(dist.get_backend())
    if (ring.size, backend, ring.device.type) != (1, "nccl", "cuda"):
        raise AssertionError(f"ring of {ring.size} on {backend}/{ring.device}, want 1 on nccl")
    out = dict(backend=backend, world_size=ring.size)
    try:
        # the host's cost of a merge's two collectives, beside one small torch op's
        trips, rows = (torch.zeros(3, dtype=torch.float64, device=ring.device),
                       torch.zeros((2, PAPER_N), device=ring.device))
        out["host_us"] = dict(all_gather=host_us(torch, lambda: ring.all_gather(trips)),
                              all_reduce=host_us(torch, lambda: ring.all_reduce(rows)),
                              torch_add=host_us(torch, lambda: rows + 1))
        say("phase 15 host us a call: " + json.dumps(out["host_us"]))
        X = gaussian_mixture(seed=0, n=PAPER_N, dim=DIM, return_labels=False)
        D = build_distance_matrix(X, "euclidean")
        serial, paper = spec["paper_serial"], {}
        for variant in ("baseline", "rowmin", "lazy"):
            for compaction in (True, False):
                what = f"distributed {variant} n={PAPER_N}, compaction={compaction}"
                key = variant if compaction else f"{variant}_unstaged"
                paper[key] = distributed_run(torch, np, ring, D, variant, compaction, serial,
                                             what, profile=compaction and variant == "baseline")[1]
                say(f"phase 15 {what}: " + json.dumps(paper[key]))
        res, s = timed(torch, lambda: cluster(X, "complete", algorithm="lw",
                                              backend="distributed", keep_inputs=False))
        check_launches(s["launches"], {}, "cluster() on the distributed backend")
        if res.backend != "distributed":
            raise AssertionError(f"cluster(backend='distributed') reported {res.backend}")
        check_bit_equal(np, res.merges, serial, "cluster() distributed vs serial")
        out["paper"] = dict(paper, cluster_wall_s=s["wall_s"])
        say(f"phase 15 cluster(backend='distributed') n={PAPER_N}: wall_s {s['wall_s']}")
        del D
        torch.cuda.empty_cache()

        # the born-sharded rmsd build (the paper's parallel RMSD phase)
        C, _ = conformations(seed=0, n=RMSD_N, atoms=RMSD_ATOMS)
        built, s = timed(torch, lambda: distributed_pairwise(C, "rmsd", ring))
        check_launches(s["launches"], {}, "distributed rmsd build")
        D_card = built.gather().cpu()
        D_cpu = build_distance_matrix(C, "rmsd", device="cpu")
        err = check_rmsd_matrix(torch, np, C, D_card, D_cpu, "born-sharded rmsd matrix")
        single = build_distance_matrix(C, "rmsd").cpu()
        out["rmsd"] = dict(build_wall_s=s["wall_s"], max_abs_err_vs_cpu=err,
                           max_abs_diff_vs_single_device=float((D_card - single).abs().max()))
        say(f"phase 15 distributed rmsd build n={RMSD_N}: " + json.dumps(out["rmsd"]))

        # the distributed batch engine at the bench setting
        B, n, d = BATCH_BENCH
        pts = np.random.default_rng(0).normal(size=(B, n, d))
        mats = [np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)).astype(np.float32) for x in pts]
        def batch(backend):
            return cluster_batch(mats, "complete", algorithm="lw", backend=backend)

        batch("distributed")            # the first call of a process pays its set-up
        want, sw = timed(torch, lambda: batch("serial"))
        got, s = timed(torch, lambda: batch("distributed"))
        check_launches(s["launches"], {}, "distributed batch")
        if got.stats.engine != "distributed":
            raise AssertionError(f"the batch ran on {got.stats.engine}")
        check_lanes_equal(np, got, [w.merges for w in want], "distributed batch vs serial batch")
        out["batch"] = dict(wall_s=s["wall_s"], serial_wall_s=sw["wall_s"],
                            buckets=got.stats.buckets)
        say(f"phase 15 distributed batch {B} x {n}: " + json.dumps(out["batch"]))
    finally:
        dist.destroy_process_group()
    return out


def sharded_window(torch, ring, X, method: str, what: str) -> dict:
    """The host's and the device's ms a trip of the sharded chain on ``X``
    over a profiled window: a fresh state run up to its first
    SHARDED_WINDOW merges, timed, then again under the profiler.  A trip's
    work does not change along a run (each builds the rank's whole row), so
    the window's shares are the run's.  A trip gives the profiler ~19
    records (a whole run at n = 8192 4.7·10⁵), and a process's later
    profiling sessions lost some of B5's records (after a whole run, or
    windows of 1000 and 500 merges), its first never: phase 16 profiles
    each window in a process of its own (:func:`sharded_window_child`)."""
    from repro_torch.core import distributed as tdist

    Xt = torch.as_tensor(X)

    def window():
        s = tdist._chain_state(Xt, ring)
        tdist._run_sharded_chain(method, s, ring, SHARDED_WINDOW)
        return s

    s, stats = timed(torch, window)
    check_launches(stats["launches"], {"chain_vote": s.iters}, f"{what}, window")
    busy = device_busy(torch, window, stats["wall_s"], stats["launches"])[1]
    return dict(merges=len(s.pairs), wall_s=stats["wall_s"],
                device_busy_s=busy["device_busy_s"], idle_share=busy["idle_share"],
                profiler_tries=busy["profiler_tries"],
                vote_ms_mean=busy["kernel_ms_mean"]["chain_vote"],
                vote_busy_share=busy["kernel_busy_share"]["chain_vote"],
                **per_step(dict(stats, device_busy_s=busy["device_busy_s"]), s.iters, "trip"))


def sharded_chain_run(torch, np, ring, X, method: str, what: str, want=None,
                      **knobs) -> tuple:
    """One ``distributed_nn_chain_from_points`` run of ``X`` on ``ring``, as
    phase 16 drives it: :func:`timed`; B5's vote entry launched once a
    trip and no other kernel; three collectives a trip; every merge made; the
    merges ``want`` (the host-driven loop's) bit for bit when given.
    Returns the result and the numbers."""
    from repro_torch.core.distributed import distributed_nn_chain_from_points

    def call():
        return distributed_nn_chain_from_points(X, method, ring, **knobs)

    before = ring.collectives
    res, stats = timed(torch, call)
    collectives = ring.collectives - before
    check_launches(stats["launches"], {"chain_vote": res.iters}, what)
    n = X.shape[0]
    if res.n_merges != n - 1 or collectives != 3 * res.iters:
        raise AssertionError(f"{what}: {res.n_merges} merges and {collectives} collectives in "
                             f"{res.iters} trips, want {n - 1} and {3 * res.iters}")
    if want is not None:
        check_bit_equal(np, res.merges.cpu().numpy(), want, f"{what} vs the host-driven loop")
    out = dict(n=n, d=X.shape[1], wall_s=stats["wall_s"], peak_gib=stats["peak_gib"],
               trips=res.iters, collectives=collectives,
               launches={"chain_vote": res.iters},      # and no other kernel
               wall_ms_per_trip=stats["wall_s"] / res.iters * 1e3, restarts=res.restarts,
               stragglers=res.stragglers, segments=res.segments)
    return res, out


def sharded_chain_full(torch, np, ring) -> dict:
    """The sharded chain at the matrix-free chain's full width (phase 6's
    n = 32768, d = 128 ward points), once: its launches and collectives,
    its peak memory under PEAK_LIMIT_GIB (no (n, n) and no (n/p, n)
    tensor), its dendrogram equal to the resident chain's on the same
    points, and a profiled window in a process of its own (on an H100, a
    session after the whole run in the same process saw 1499 of the
    window's 1502 vote launches, three tries running)."""
    from repro_torch.core.dendrogram import canonical_order
    from repro_torch.core.nnchain import nn_chain_from_points
    from repro_torch.data.synthetic import gaussian_mixture

    n = CHAIN_N
    X = gaussian_mixture(seed=0, n=n, dim=CHAIN_DIM, return_labels=False)
    what = f"sharded chain n={n} d={CHAIN_DIM} ward"
    res, out = sharded_chain_run(torch, np, ring, X, "ward", what)
    if out["peak_gib"] >= PEAK_LIMIT_GIB:
        raise AssertionError(f"{what}: peak memory {out['peak_gib']:.4f} GiB, "
                             f"limit {PEAK_LIMIT_GIB} GiB")
    got = canonical_order(res.merges.cpu().numpy(), n=n)
    resident = canonical_order(nn_chain_from_points(X, "ward").merges.cpu().numpy(), n=n)
    check_equivalent(np, got, resident, n, f"{what} vs the resident chain")
    out["canonical_slots_equal"] = bool(np.array_equal(got[:, :2], resident[:, :2]))
    out["window"] = run_child(torch, SHARDED_WINDOW_FLAG, dict(method="ward", n=n, d=CHAIN_DIM))
    return out


def sharded_window_child(torch, np, spec: dict) -> dict:
    """Phase 16's profiled window (:func:`sharded_window`) for
    ``spec["method"]`` on its ``(n, d)`` points, in a process of its own on
    a world-size-1 NCCL group of its own."""
    import torch.distributed as dist

    from repro_torch.core.distributed import distributed_nn_chain_from_points, make_cluster_mesh
    from repro_torch.data.synthetic import gaussian_mixture

    method, n, d = spec["method"], spec["n"], spec["d"]
    ring = make_cluster_mesh()
    try:
        distributed_nn_chain_from_points(
            gaussian_mixture(seed=1, n=300, dim=d, return_labels=False), method, ring)
        X = gaussian_mixture(seed=0, n=n, dim=d, return_labels=False)
        return sharded_window(torch, ring, X, method, f"sharded chain n={n} d={d} {method}")
    finally:
        dist.destroy_process_group()


def sharded_methods(torch, np, ring, n: int, d: int, phase: str,
                    windows=SHARDED_METHODS) -> tuple:
    """The sharded chain on ``ring`` for each of SHARDED_METHODS at (n, d):
    bit for bit the host-driven chain loop with B5's row on the card; for
    the methods in ``windows``, busy and idle from a profiled window, each
    in a process of its own.  Returns each method's numbers and its
    chain-order merges."""
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels.pairwise import row_sq_euclidean

    X = gaussian_mixture(seed=0, n=n, dim=d, return_labels=False)
    out, merges = {}, {}
    for method in SHARDED_METHODS:
        host, hs = timed(torch, lambda: points_chain(torch, X, method, row_sq_euclidean))
        check_launches(hs["launches"], {"row_sq_euclidean": host.iters},
                       f"host-driven loop n={n} {method}")
        what = f"sharded chain n={n} d={d} {method}"
        res, out[method] = sharded_chain_run(torch, np, ring, X, method, what,
                                             want=host.merges.cpu().numpy())
        if method in windows:
            out[method]["window"] = run_child(torch, SHARDED_WINDOW_FLAG,
                                              dict(method=method, n=n, d=d))
        if res.iters != host.iters:
            raise AssertionError(f"{what}: {res.iters} trips, the host loop {host.iters}")
        out[method]["host_loop_wall_s"] = hs["wall_s"]
        out[method]["host_loop_launches"] = {"row_sq_euclidean": host.iters}
        merges[method] = res.merges.cpu().numpy()
        say(f"{phase} {what}: " + json.dumps(out[method]))
    torch.cuda.empty_cache()
    return out, merges


def phase_sharded_chain(torch, np, spec: dict) -> dict:
    """Phase 16, in a process of its own: the sharded matrix-free chain
    (``distributed_nn_chain_from_points``) on a world-size-1 NCCL group, B5's
    vote entry launched once a trip and B5's row entry never.  At the paper's
    size (n = 1968, d = 64) for ward, average and weighted
    (:func:`sharded_methods`): bit for bit the host-driven chain loop with
    B5's row on the card, ward with a profiled window of its own (host and
    device ms a trip; average's and weighted's windows are
    ``--distributed-full``'s); the ward run again segmented, with a lost shard at segment 1 and a straggler
    deadline, equal to the unsegmented run; and ``cluster(...,
    algorithm="nnchain", backend="distributed")``.  The group is torn down
    at the end.  The n = 8192 runs are ``--distributed-full``."""
    import torch.distributed as dist

    from repro_torch.core import cluster
    from repro_torch.core.dendrogram import canonical_order
    from repro_torch.core.distributed import distributed_nn_chain_from_points, make_cluster_mesh
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.distributed.fault import FailurePlan, StepDeadline

    ring = make_cluster_mesh()
    backend = str(dist.get_backend())
    if (ring.size, backend, ring.device.type) != (1, "nccl", "cuda"):
        raise AssertionError(f"ring of {ring.size} on {backend}/{ring.device}, want 1 on nccl")
    out = dict(backend=backend, world_size=ring.size)
    try:
        # loads B5's vote kernel and warms NCCL up
        distributed_nn_chain_from_points(
            gaussian_mixture(seed=1, n=300, dim=DIM, return_labels=False), "ward", ring)
        runs, merges = sharded_methods(torch, np, ring, PAPER_N, DIM, "phase 16",
                                       windows=("ward",))
        out.update(runs)
        whole = merges["ward"]

        # the paper's size: segmented, a shard lost at segment 1, a deadline
        Xp = gaussian_mixture(seed=0, n=PAPER_N, dim=DIM, return_labels=False)
        what = f"sharded chain n={PAPER_N} d={DIM} ward"
        events = []
        seg, sg = sharded_chain_run(torch, np, ring, Xp, "ward", f"{what}, segmented",
                                    want=whole, segment_steps=SHARDED_SEGMENT,
                                    failure_plan=FailurePlan(fail_at=(1,)),
                                    deadline=StepDeadline(factor=3.0, warmup=1),
                                    log=events.append)
        segments = -(-(PAPER_N - 1) // SHARDED_SEGMENT)
        if (seg.restarts, seg.segments, seg.iters) != (1, segments, out["ward"]["trips"]):
            raise AssertionError(f"{what}, segmented: {seg.restarts} restarts, {seg.segments} "
                                 f"segments, {seg.iters} trips; want 1, {segments}, "
                                 f"{out['ward']['trips']}")
        out["segmented"] = dict(sg, events=events)
        say(f"phase 16 {what}, segmented: " + json.dumps(out["segmented"]))

        res, cs = timed(torch, lambda: cluster(Xp, "ward", algorithm="nnchain",
                                               backend="distributed", keep_inputs=False))
        check_launches(cs["launches"], {"chain_vote": seg.iters},
                       "cluster() on the sharded chain")
        if (res.backend, res.algorithm, res.distances) != ("distributed", "nnchain", None):
            raise AssertionError(f"cluster() ran {res.algorithm}/{res.backend}")
        check_bit_equal(np, res.merges, canonical_order(whole, n=PAPER_N),
                        "cluster() sharded chain vs its canonical merges")
        out["cluster_wall_s"] = cs["wall_s"]
        say(f"phase 16 cluster(algorithm='nnchain', backend='distributed') n={PAPER_N}: "
            f"wall_s {cs['wall_s']}")
    finally:
        dist.destroy_process_group()
    return out


@contextlib.contextmanager
def recorded(module, name: str, log: list):
    """Within the block, each call of ``module.name`` appends a record to
    ``log``: its arguments, what it returned, its wall seconds and the
    trip graphs it replayed.  The callers look the name up in the module
    at each call, so they reach the wrapper; the launch counters are not
    touched."""
    from repro_torch.kernels.pairwise import TripGraph

    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        replays, t0 = TripGraph.replays, time.perf_counter()
        res = fn(*args, **kwargs)
        log.append(dict(args=args, result=res, seconds=time.perf_counter() - t0,
                        replays=TripGraph.replays - replays))
        return res

    setattr(module, name, wrapper)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def two_phase_run(torch, np, X, method: str, shards: int, what: str) -> tuple:
    """One ``two_phase_from_points`` run of ``X`` on the card, as phase 17
    drives it: :func:`timed`, with each chain (the resident chain of a
    shard, then of the summaries), each host replay and each
    canonicalisation recorded (:func:`recorded`).  Gates: B5's trip entry
    and no other kernel, launched from whole graph replays of the chains
    (at least each chain's trips and less than one replay more); n - 1
    merges, a valid dendrogram with monotone heights, slots ``i < j`` in
    the global convention.  Returns the result, :func:`timed`'s numbers
    and the records."""
    from repro_torch.core import dendrogram, distributed, nnchain

    logs = dict(chain=[], replay=[], canonical=[], summaries=[])
    with recorded(nnchain, "_resident_chain", logs["chain"]), \
            recorded(nnchain, "nn_chain_from_summaries", logs["summaries"]), \
            recorded(distributed, "_replay_summaries", logs["replay"]), \
            recorded(dendrogram, "canonical_order", logs["canonical"]):
        res, stats = timed(torch, lambda: distributed.two_phase_from_points(X, method,
                                                                           shards=shards))
    n = X.shape[0]
    launches = stats["launches"]["chain_trip"]
    check_launches(stats["launches"], {"chain_trip": launches}, what)
    replays = sum(c["replays"] for c in logs["chain"])
    if launches != replays * nnchain.CHAIN_GRAPH_TRIPS or replays != stats["trip_replays"]:
        raise AssertionError(f"{what}: {launches} trip launches, {stats['trip_replays']} "
                             f"replays, the chains' {replays}")
    for c in logs["chain"]:
        made = c["replays"] * nnchain.CHAIN_GRAPH_TRIPS
        if not c["result"].iters <= made < c["result"].iters + nnchain.CHAIN_GRAPH_TRIPS:
            raise AssertionError(f"{what}: a chain of {c['result'].iters} trips launched {made}")
    merges = res.merges.numpy()
    if res.n_merges != n - 1 or merges.shape != (n - 1, 4):
        raise AssertionError(f"{what}: {res.n_merges} merges, shape {merges.shape}")
    dendrogram.validate_merges(merges, n=n)
    if not dendrogram.is_monotone(merges):
        raise AssertionError(f"{what}: heights are not monotone")
    i, j = merges[:, 0], merges[:, 1]
    if not (np.all(i == np.rint(i)) and np.all(i < j) and i.min() >= 0 and j.max() < n):
        raise AssertionError(f"{what}: slots are not in the global i < j convention")
    return res, stats, logs


def two_phase_full(torch, np, l2_rate: float) -> tuple:
    """Phase 17's full-width run: ``two_phase_from_points`` on phase 11's
    points (n = 131072, d = 128, ward, TWO_PHASE_SHARDS shards of 16384,
    K = 1024 summaries) through :func:`two_phase_run`, the ARI at the
    8-cut against the mixture's labels, peak memory; busy time and idle
    share over a profiled second run (the same merges), with the device
    ms of phase 2's launches apart; per phase the trips, launches and
    host and device ms a trip; the host seconds of the replays and the
    canonicalisations.  Then B5's trip entry against its plain twin from
    phase 2's seed state, for ward (the run's own) and for average and
    weighted (the same phase-1 trees replayed with their recursions:
    ``u`` other than 0), each timed (:func:`trip_row`).  Returns the
    numbers and the trip rows."""
    from repro_torch.core import distributed
    from repro_torch.core.dendrogram import adjusted_rand_index, cut
    from repro_torch.core.nnchain import CHAIN_GRAPH_TRIPS
    from repro_torch.data.synthetic import gaussian_mixture

    n, p = LANDMARK_N, TWO_PHASE_SHARDS
    X, truth = gaussian_mixture(seed=0, n=n, dim=CHAIN_DIM)
    what = f"two-phase n={n} d={CHAIN_DIM} ward shards={p}"
    res, stats, logs = two_phase_run(torch, np, X, "ward", p, what)
    chains = logs["chain"]
    if len(chains) != p + 1:
        raise AssertionError(f"{what}: {len(chains)} chain runs, want {p + 1}")
    merges = res.merges.numpy()
    ari = adjusted_rand_index(cut(merges, CUT_K, n=n), truth)
    if ari < QUALITY_MIN:
        raise AssertionError(f"{what}: ARI at the {CUT_K}-cut {ari:.4f} < {QUALITY_MIN}")
    if stats["peak_gib"] >= PEAK_LIMIT_GIB:
        raise AssertionError(f"{what}: peak memory {stats['peak_gib']:.4f} GiB, "
                             f"limit {PEAK_LIMIT_GIB} GiB")

    # busy and idle over a profiled second run, phase 2's launches apart
    phase2_launches = chains[-1]["replays"] * CHAIN_GRAPH_TRIPS
    again, busy = device_busy(
        torch, lambda: distributed.two_phase_from_points(X, "ward", shards=p), stats["wall_s"],
        stats["launches"], tail={"chain_trip": phase2_launches})
    if not np.array_equal(again.merges.numpy(), merges):
        raise AssertionError(f"{what}: the profiled run gave other merges")
    trip_ms = busy["kernel_ms_mean"]["chain_trip"] * stats["launches"]["chain_trip"]
    device_ms = dict(phase1=trip_ms - busy["tail_ms"]["chain_trip"],
                     phase2=busy["tail_ms"]["chain_trip"])
    phases = {}
    for name, runs in (("phase1", chains[:-1]), ("phase2", chains[-1:])):
        trips = sum(c["result"].iters for c in runs)
        wall = sum(c["seconds"] for c in runs)
        phases[name] = dict(chains=len(runs), trips=trips,
                            launches=sum(c["replays"] for c in runs) * CHAIN_GRAPH_TRIPS,
                            wall_s=wall, ms_per_trip=wall / trips * 1e3,
                            device_ms_per_trip=device_ms[name] / trips,
                            host_ms_per_trip=(wall * 1e3 - device_ms[name]) / trips)
    replay_s = sum(r["seconds"] for r in logs["replay"])
    canonical_s = sum(r["seconds"] for r in logs["canonical"])
    out = dict(n=n, d=CHAIN_DIM, shards=p, summaries=len(logs["summaries"][0]["args"][0]),
               wall_s=stats["wall_s"], peak_gib=stats["peak_gib"],
               device_busy_s=busy["device_busy_s"], idle_share=busy["idle_share"],
               profiler_tries=busy["profiler_tries"], profiler_missed=busy["profiler_missed"],
               launches={"chain_trip": stats["launches"]["chain_trip"]},
               trip_replays=stats["trip_replays"], phases=phases, replay_host_s=replay_s,
               canonical_host_s=canonical_s,
               other_host_s=stats["wall_s"] - sum(c["seconds"] for c in chains) - replay_s
               - canonical_s, ari=ari)

    # B5's trip from phase 2's seed: the run's own (ward), and the same trees
    # replayed under average's and weighted's recursions
    W, u, sizes = logs["summaries"][0]["args"][:3]
    seeds = {"ward": (W, u, sizes)}
    for method in ("average", "weighted"):
        parts = [distributed._replay_summaries(r["args"][0], r["args"][1], method)
                 for r in logs["replay"]]
        seeds[method] = tuple(np.concatenate([part[k][part[3]] for part in parts])
                              for k in range(3))
    rows = {}
    for method, (W, u, sizes) in seeds.items():
        if sizes.sum() != n or (method != "ward") != bool(u.max() > 0):
            raise AssertionError(f"{what}: {method}'s seed has sizes summing to {sizes.sum()} "
                                 f"and u up to {u.max()}")
        t = [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (W, u, sizes)]
        rows[method] = trip_row(torch, method, *t, f"chain_trip from {method}'s summary seed",
                                l2_rate)
        rows[method]["sizes_max"] = float(sizes.max())
    return out, rows


def separated_mixture(np, n: int, d: int, k: int = 16):
    """The reference's two-phase benchmark data
    (``benchmarks/bench_distributed.py``): ``k`` centers 20 apart in
    scale, ``n / k`` points 0.1 around each, in contiguous blocks."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 20
    return np.concatenate([c + 0.1 * rng.normal(size=(n // k, d)).astype(np.float32)
                           for c in centers])


def two_phase_quality(torch, np) -> dict:
    """Phase 17 against the resident exact chain at n = 32768, d = 128,
    ward, TWO_PHASE_SHARDS shards.  On phase 6's points: the ARI between
    the two 8-cuts at least QUALITY_MIN, and the merge-set agreement
    reported (each shard holds an eighth of every component, so no
    cluster below a component's scale is the exact one's).  On the
    reference's own benchmark data (:func:`separated_mixture`): merge-set
    agreement at least TWO_PHASE_AGREEMENT_MIN, the reference's gate."""
    from repro_torch.core.dendrogram import (
        adjusted_rand_index, canonical_order, cut, merge_set_agreement)
    from repro_torch.core.nnchain import nn_chain_from_points
    from repro_torch.data.synthetic import gaussian_mixture

    n = CHAIN_N
    out = {}
    for name, X in (("mixture", gaussian_mixture(seed=0, n=n, dim=CHAIN_DIM,
                                                 return_labels=False)),
                    ("separated", separated_mixture(np, n, CHAIN_DIM))):
        what = f"two-phase n={n} d={CHAIN_DIM} ward shards={TWO_PHASE_SHARDS} on the {name}"
        res, stats, _ = two_phase_run(torch, np, X, "ward", TWO_PHASE_SHARDS, what)
        exact, es = timed(torch, lambda: canonical_order(
            nn_chain_from_points(X, "ward").merges.cpu().numpy(), n=n))
        approx = res.merges.numpy()
        agreement = merge_set_agreement(exact, approx, n=n)
        cut_ari = adjusted_rand_index(cut(approx, CUT_K, n=n), cut(exact, CUT_K, n=n))
        if name == "mixture" and cut_ari < QUALITY_MIN:
            raise AssertionError(f"{what}: ARI between the {CUT_K}-cuts {cut_ari:.4f} "
                                 f"< {QUALITY_MIN}")
        if name == "separated" and agreement < TWO_PHASE_AGREEMENT_MIN:
            raise AssertionError(f"{what}: merge-set agreement with the exact chain "
                                 f"{agreement:.4f} < {TWO_PHASE_AGREEMENT_MIN}")
        out[name] = dict(n=n, wall_s=stats["wall_s"], exact_wall_s=es["wall_s"],
                         merge_set_agreement=agreement, cut_ari=cut_ari)
    return out


def two_phase_against_cpu(torch, np) -> dict:
    """Phase 17's kernel path against the plain path, end to end: at the
    paper's n = 1968, d = 64, TWO_PHASE_SHARDS shards, for ward, average
    and weighted (squared-Euclidean points), the card's run
    (:func:`two_phase_run`) against ``device="cpu"``: slots equal, heights
    within RTOL/ATOL."""
    from repro_torch.core.distributed import two_phase_from_points
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=0, n=PAPER_N, dim=DIM, return_labels=False)
    out = {}
    for method in SHARDED_METHODS:
        what = f"two-phase n={PAPER_N} d={DIM} {method} shards={TWO_PHASE_SHARDS}"
        res, stats, logs = two_phase_run(torch, np, X, method, TWO_PHASE_SHARDS, what)
        cpu, cs = timed(torch, lambda: two_phase_from_points(X, method, shards=TWO_PHASE_SHARDS,
                                                             device="cpu"))
        check_launches(cs["launches"], {}, f"{what} on the CPU")
        check_merges(np, res.merges.numpy(), cpu.merges.numpy(), f"{what}: card vs CPU")
        out[method] = dict(wall_s=stats["wall_s"], cpu_wall_s=cs["wall_s"],
                           launches=stats["launches"]["chain_trip"],
                           trips=sum(c["result"].iters for c in logs["chain"]),
                           max_abs_height_diff=float(np.abs(res.merges.numpy()[:, 2]
                                                            - cpu.merges.numpy()[:, 2]).max()))
    return out


def two_phase_routes(torch, np) -> dict:
    """``cluster(X, "ward", algorithm="twophase")`` on the card at the
    paper's size reports the serial backend; with
    ``backend="distributed"`` on a world-size-1 NCCL group it reports the
    distributed one, with the same merges: the tier over one shard (the
    group's world size), B5's trip entry and no other kernel."""
    import torch.distributed as dist

    from repro_torch.core import cluster
    from repro_torch.core.distributed import make_cluster_mesh, two_phase_from_points
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=0, n=PAPER_N, dim=DIM, return_labels=False)
    want = two_phase_from_points(X, "ward", shards=1).merges.numpy()
    out = {}
    ring = None
    try:
        for backend in ("auto", "distributed"):
            if backend == "distributed":
                ring = make_cluster_mesh()
            res, s = timed(torch, lambda: cluster(X, "ward", algorithm="twophase",
                                                  backend=backend, keep_inputs=False))
            check_launches(s["launches"], {"chain_trip": s["launches"]["chain_trip"]},
                           f"cluster(algorithm='twophase', backend={backend!r})")
            reported = backend.replace("auto", "serial")
            if (res.algorithm, res.backend, res.distances) != ("twophase", reported, None):
                raise AssertionError(f"cluster(algorithm='twophase', backend={backend!r}) ran "
                                     f"{res.algorithm}/{res.backend}")
            check_bit_equal(np, res.merges, want, f"cluster() twophase {backend} vs one shard")
            out[reported] = dict(wall_s=s["wall_s"], launches=s["launches"]["chain_trip"])
    finally:
        if ring is not None:
            dist.destroy_process_group()
    return out


def entry_points() -> dict:
    """Each of ENTRY_POINTS at its defaults on the card, all four at once,
    each in a process of its own: each must exit 0 (its own asserts), and
    its lines are carried into this output."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, *args], cwd=root, env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for name, args in ENTRY_POINTS.items()}
    out, failed = {}, []
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        for line in stdout.splitlines():
            say(f"phase 17 {name}: {line}")
        if proc.returncode != 0:
            print(stderr[-4000:], flush=True)
            failed.append(f"{name} (exit code {proc.returncode})")
        out[name] = dict(done_s=time.perf_counter() - t0, lines=len(stdout.splitlines()))
    if failed:
        raise AssertionError(f"entry points failed: {failed}")
    return out


def phase_two_phase(torch, np, spec: dict) -> dict:
    """Phase 17, in a process of its own: the two-phase tier
    (``two_phase_from_points``) on B5's resident trip in both phases: the
    full-width run and its summary-seed trip rows (:func:`two_phase_full`,
    profiled first in this process), the quality against the exact chain
    (:func:`two_phase_quality`), the card against the CPU
    (:func:`two_phase_against_cpu`), the ``cluster()`` routes
    (:func:`two_phase_routes`) and the entry points (:func:`entry_points`)."""
    from repro_torch.core.distributed import two_phase_from_points
    from repro_torch.data.synthetic import gaussian_mixture

    # loads B5's trip kernel
    two_phase_from_points(gaussian_mixture(seed=1, n=600, dim=CHAIN_DIM, return_labels=False),
                          "ward", shards=2)
    full, rows = two_phase_full(torch, np, spec["l2_rate"])
    say(f"phase 17 two-phase n={LANDMARK_N} d={CHAIN_DIM} ward: " + json.dumps(full))
    for method, row in rows.items():
        say(f"phase 17 chain_trip from {method}'s summary seed m={row['m']} d={row['d']}: "
            + json.dumps(row))
    torch.cuda.empty_cache()
    quality = two_phase_quality(torch, np)
    say(f"phase 17 two-phase vs the exact chain n={CHAIN_N}: " + json.dumps(quality))
    against_cpu = two_phase_against_cpu(torch, np)
    say(f"phase 17 two-phase card vs CPU n={PAPER_N}: " + json.dumps(against_cpu))
    routes = two_phase_routes(torch, np)
    say(f"phase 17 cluster(algorithm='twophase') n={PAPER_N}: " + json.dumps(routes))
    entries = entry_points()
    say("phase 17 entry points: " + json.dumps(entries))
    return dict(full=full, rows=rows, quality=quality, against_cpu=against_cpu, routes=routes,
                entry_points=entries)


#: Phase 18's k-means cells: (n, d, k, the mixture's seed and components).
#: The paper's points (configs/paper_lw.py: gaussian_mixture(seed=0), 8
#: components) at k = 8, and 65536 points in 128-D of 64 components at k = 64.
KMEANS_CELLS = ((PAPER_N, DIM, 8, 0, 8), (65536, CHAIN_DIM, 64, 1, 64))
KMEANS_ITERS = 50


def kmeans_cell(torch, np, n: int, d: int, k: int, seed: int, parts: int,
                l2_rate: float) -> dict:
    """``kmeans`` on the card at (n, d, k), ``KMEANS_ITERS`` Lloyd
    iterations: wall (and ``warm_wall_s``, a third run), peak and launches
    (none: no kernel of the port), busy and idle over a profiled second run
    (the same result bit for bit), the card's ``_lloyd`` from the run's own
    seeds bit for bit the run.  Then every Lloyd step of the CPU's run from
    those seeds held against the card's step from the same centroids
    (:func:`lloyd_against_cpu`), and the CPU's final inertia within rtol
    1e-4 of the card's own run (with the rows whose final labels differ).
    A Lloyd iteration timed from the final centroids, with its roofline
    (``cost.lloyd_step``)."""
    from repro_torch.core import baselines
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.roofline import cost

    what = f"kmeans n={n} d={d} k={k}"
    X = torch.as_tensor(gaussian_mixture(seed=seed, n=n, dim=d, k=parts, return_labels=False),
                        dtype=torch.float32, device="cuda")

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    def call():
        return baselines.kmeans(gen(), X, k, KMEANS_ITERS)

    res, stats = timed(torch, call)
    check_launches(stats["launches"], {}, what)
    again, busy = device_busy(torch, call, stats["wall_s"], stats["launches"])
    warm = timed(torch, call)[1]
    seeds = baselines._kmeans_pp_init(gen(), X, k)
    lloyd = baselines._lloyd(X, seeds, KMEANS_ITERS)
    for name, a, b, c in zip(baselines.KMeansResult._fields, res, again, lloyd):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"{what}: {name} differs between two runs of one seed")
    cpu = lloyd_against_cpu(torch, np, X, seeds, what)
    np.testing.assert_allclose(float(res.inertia), cpu.pop("cpu_inertia"), rtol=RTOL,
                               err_msg=f"{what}: inertia, card vs CPU")
    cpu["final_differing_rows"] = int((res.labels.cpu() != cpu.pop("cpu_labels")).sum())
    cents = res.centroids
    work = cost.lloyd_step(n, k, d)
    return dict(n=n, d=d, k=k, iters=KMEANS_ITERS, wall_s=stats["wall_s"],
                warm_wall_s=warm["wall_s"], device_busy_s=busy["device_busy_s"],
                idle_share=busy["idle_share"], peak_gib=stats["peak_gib"],
                inertia=float(res.inertia), **cpu,
                lloyd_ms=time_ms(torch, lambda: baselines._lloyd_step(X, cents)),
                lloyd_flops=work.flops, lloyd_bytes=work.bytes,
                **bound(torch, work, work.bytes, l2_rate))


def lloyd_against_cpu(torch, np, X, seeds, what: str) -> dict:
    """Every one of the KMEANS_ITERS Lloyd steps on the card and on the
    CPU from the same centroids: the CPU's run from ``seeds``, each of
    its steps' centroids also given to the card.  The card's labels equal
    the CPU's but on near-ties (:func:`check_labels` against the step's
    centroids), and the card's new centroids are within rtol/atol 1e-5 of
    the CPU's update of the card's labels (the CPU's own new centroids
    where the labels agree).  Returns the steps whose labels differed, the
    most near-tie and differing rows of a step, the CPU's wall, and its
    final labels and inertia."""
    from repro_torch.core import baselines
    from repro_torch.kernels.pairwise import pairwise_sq_euclidean_plain

    Xh, host = X.cpu(), seeds.cpu()
    out = dict(steps_with_differing_labels=0, near_tie_rows=0, differing_rows=0)
    cpu_s = 0.0
    for it in range(KMEANS_ITERS):
        card = host.to(X.device)
        got = baselines._first_argmin(pairwise_sq_euclidean_plain(X, card))
        got_cents = baselines._centroids(X, got, card).cpu()
        got = got.cpu()
        t0 = time.perf_counter()
        want = baselines._first_argmin(pairwise_sq_euclidean_plain(Xh, host))
        nxt = baselines._centroids(Xh, want, host)
        cpu_s += time.perf_counter() - t0
        ref = nxt
        if not torch.equal(got, want):
            c = check_labels(torch, np, got.numpy(), want.numpy(), X, host,
                             f"{what}: card vs CPU at Lloyd step {it}")
            out.update(steps_with_differing_labels=out["steps_with_differing_labels"] + 1,
                       near_tie_rows=max(out["near_tie_rows"], c["near_tie_rows"]),
                       differing_rows=max(out["differing_rows"], c["differing_rows"]))
            ref = baselines._centroids(Xh, got, host)
        if not torch.allclose(got_cents, ref, rtol=1e-5, atol=1e-5):
            err = float((got_cents - ref).abs().max())
            raise AssertionError(f"{what}: centroids of Lloyd step {it} differ, card vs CPU, "
                                 f"by up to {err:.3g}")
        host = nxt
    t0 = time.perf_counter()
    d2 = pairwise_sq_euclidean_plain(Xh, host)
    labels, inertia = baselines._first_argmin(d2), float(d2.amin(1).sum())
    return dict(out, cpu_wall_s=cpu_s + time.perf_counter() - t0, cpu_labels=labels,
                cpu_inertia=inertia)


def check_same_cuts(np, got, want, n: int, tol: float, what: str) -> dict:
    """Two single-linkage merge lists (in height order) cut the tree the
    same way at every k: merge by merge both join the same two clusters,
    but inside a run of merges whose heights lie within ``tol`` of the
    next, where the order of a run's merges is down to rounding and
    tie-breaking and only the partition the run ends on must be the same.
    One union-find over the leaves (a cluster holds its slot's leaf), the
    runs read from ``want``'s heights.  Returns the runs of more than one
    merge and the merges in them."""
    got, want = np.asarray(got), np.asarray(want)
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def ends(pairs, roots):
        """Where each of ``roots`` ends after joining ``pairs`` of clusters."""
        sub = {}

        def top(r):
            while sub.get(r, r) != r:
                r = sub[r]
            return r

        for a, b in pairs:
            a, b = top(a), top(b)
            if a == b:
                raise AssertionError(f"{what}: a merge joins a cluster to itself")
            sub[max(a, b)] = min(a, b)
        return {r: top(r) for r in roots}

    h, t, runs, tied = want[:, 2], 0, 0, 0
    while t < n - 1:
        e = t + 1
        while e < n - 1 and h[e] - h[e - 1] <= tol:
            e += 1
        pg = [(find(int(i)), find(int(j))) for i, j in got[t:e, :2]]
        pw = [(find(int(i)), find(int(j))) for i, j in want[t:e, :2]]
        roots = {r for pair in pg + pw for r in pair}
        if ends(pg, roots) != ends(pw, roots):
            raise AssertionError(f"{what}: the cuts differ after merge {e - 1} "
                                 f"(height {h[e - 1]:.9g}, a run of {e - t} merges)")
        for a, b in pw:
            a, b = find(a), find(b)
            parent[max(a, b)] = min(a, b)
        if e - t > 1:
            runs, tied = runs + 1, tied + e - t
        t = e
    return dict(tied_runs=runs, merges_in_tied_runs=tied)


def mst_cell(torch, np, D, what: str, profile: bool) -> dict:
    """``mst_single_linkage`` on the card on the matrix ``D`` (on the card):
    wall, peak, launches (none: no kernel of the port), with ``profile``
    busy and idle over a profiled second run (the same merges), its merges
    bit for bit the CPU's on the same
    matrix; sorted heights within RTOL/ATOL of the port's LW single linkage
    on the card, and the same cuts (:func:`check_same_cuts`), merges whose
    heights lie within twice the largest gap between the two sorted height
    lists (``height_gap``: the LW loop rounds its heights in float32) taken
    as tied."""
    from repro_torch.core import baselines, cluster

    n = D.shape[0]
    res, stats = timed(torch, lambda: baselines.mst_single_linkage(D))
    check_launches(stats["launches"], {}, what)
    busy = {}
    if profile:
        again, busy = device_busy(torch, lambda: baselines.mst_single_linkage(D),
                                  stats["wall_s"], stats["launches"])
        check_bit_equal(np, again, res, f"{what}: two runs on the card")
        busy = dict(device_busy_s=busy["device_busy_s"], idle_share=busy["idle_share"])
    t0 = time.perf_counter()
    cpu = baselines.mst_single_linkage(D.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    check_bit_equal(np, res, cpu, f"{what}: card vs CPU")
    D_host = D.cpu().numpy()            # cluster() takes host arrays
    lw, lw_stats = timed(torch, lambda: cluster(D_host, "single", algorithm="lw",
                                                backend="kernel", is_distance=True,
                                                keep_inputs=False))
    del D_host
    heights = np.sort(lw.heights()), np.sort(res[:, 2])
    np.testing.assert_allclose(*heights, rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: heights vs LW single")
    gap = float(np.abs(heights[0] - heights[1]).max())
    cuts = check_same_cuts(np, lw.merges, res, n, 2 * gap, f"{what} vs LW single")
    return dict(n=n, wall_s=stats["wall_s"], **busy, peak_gib=stats["peak_gib"],
                launches=stats["launches"], cpu_wall_s=cpu_s, lw_single_wall_s=lw_stats["wall_s"],
                height_gap=gap, **cuts)


def phase_baselines(torch, np, spec: dict) -> dict:
    """Phase 18, in a process of its own: the paper's baselines on the card
    (``repro_torch.core.baselines``), k-means at KMEANS_CELLS
    (:func:`kmeans_cell`) and MST single linkage on phase 3's and phase
    4's matrices (:func:`mst_cell`; profiled at the paper's size only: a
    run at n = 16384 makes ~2.5·10⁵ device records, and the profile adds a
    second run of ~6 s to the smoke)."""
    from repro_torch.core import baselines
    from repro_torch.core.api import build_distance_matrix
    from repro_torch.data.synthetic import gaussian_mixture


    # loads cuBLAS and the float64 paths before any timed run
    W = torch.rand(64, 8, device="cuda")
    baselines.kmeans(torch.Generator(device="cuda").manual_seed(0), W, 4, 2)
    baselines.mst_single_linkage(torch.cdist(W, W))
    out = {}
    for n, d, k, seed, parts in KMEANS_CELLS:
        out[f"kmeans n={n}"] = row = kmeans_cell(torch, np, n, d, k, seed, parts,
                                                  spec["l2_rate"])
        say(f"phase 18 kmeans n={n} d={d} k={k}: " + json.dumps(row))
        torch.cuda.empty_cache()
    for n in (PAPER_N, FULL_N):
        D = build_distance_matrix(gaussian_mixture(seed=0, n=n, dim=DIM, return_labels=False),
                                  "euclidean")
        out[f"mst n={n}"] = row = mst_cell(torch, np, D, f"mst_single_linkage n={n}",
                                           profile=n == PAPER_N)
        say(f"phase 18 mst_single_linkage n={n}: " + json.dumps(row))
        del D
        torch.cuda.empty_cache()
    return out


LM_SEED = 0                      # the weights' generator and the prompts' seed
LM_ARCH = "gemma3-1b"            # the full-width, full-depth model (~1.0 B parameters)
LM_CHECK = (4, 1024, 16)         # (a) batch, prompt (past the 512 window), new tokens, fp32
LM_CPU = (2, 1024, 4, 2)         # (b) batch, prompt, decode steps, layers: the card vs the CPU
LM_SERVED = (16, 8, 1024, 64)    # (c) requests, batch, prompt, new tokens, bf16
# (d), fp32: arch, layers, and whether the spec's init is also run in float64
# (llama3-405b's layer and 2.1 B-entry embeddings in float64, 59 GB, do
# not fit the card beside its float32 model)
LM_OTHERS = (("chatglm3-6b", 2, True), ("deepseek-coder-33b", 2, True), ("llama3-405b", 1, False))
LM_OTHER_SHAPE = (2, 256, 4)     # (d) batch, prompt, decode steps
LM_LOOP_STEPS = 16               # (c) decode steps of the timed and profiled loop window
LM_DECODE_TOL = 2e-3             # decode vs full forward: the reference's own tolerance
LM_CPU_TOL = 1e-4                # the card vs the CPU, fp32


def lm_prompts(np, cfg, requests: int, length: int, seed: int = LM_SEED):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (requests, length)).astype(np.int32)


def lm_model(torch, cfg):
    """The port's module for ``cfg`` on the card, from the seeded generator
    (a bf16 config draws the fp32 config's values and casts them)."""
    from repro_torch.models import model_api

    return model_api.init_params(cfg, torch.Generator(device="cuda").manual_seed(LM_SEED))


def lm_check_close(torch, got, want, tol: float, what: str, gate: bool = True) -> float:
    """Both finite and, gated, |got - want| <= tol + tol |want| everywhere;
    the largest gap."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite logits")
    gap = (got - want).abs()
    if gate and (gap > tol + tol * want.abs()).any():
        raise AssertionError(f"{what}: largest gap {float(gap.max()):.3g} past rtol/atol {tol}")
    return float(gap.max())


def lm_unit_attention(torch, cfg, model) -> None:
    """Rescale each block's attention weights in place to a true fan-in:
    ``d_model`` for wq, wk and wv, ``n_heads · head_dim`` for wo.  The
    reference's "scaled" init (which ``init_params`` follows) takes
    ``shape[-2]`` as the fan-in, the head count of a ``(d, h, hd)`` weight:
    at full width it makes queries and keys ~11 and ~45 (chatglm3-6b), the
    softmax a hard argmax, and fp32 rounding decides its near-ties."""
    d, h, n, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_
    with torch.no_grad():
        for block in model.blocks:
            block.wq.mul_((h / d) ** 0.5)
            block.wk.mul_((n / d) ** 0.5)
            block.wv.mul_((n / d) ** 0.5)
            block.wo.mul_((1 / h) ** 0.5)


def lm_forward_logits(torch, np, cfg, model, seq, prompt: int, new: int):
    """The port's full forward (train mode) over ``seq``, the prompt and the
    tokens generated but the last: the logits at the ``new`` positions
    decoded.  ``seq`` is padded with token 0 to a whole number of the flash
    core's 512-token q blocks (a causal model's logits at a position do not
    see later tokens): at prompt + new - 1 = 1039, a prime, its halving rule
    would take blocks of one token."""
    from repro_torch.models import embedding, model_api

    seq = torch.tensor(np.pad(seq, [(0, 0), (0, -seq.shape[1] % 512)]), device="cuda")
    with torch.no_grad():
        hidden = model_api.apply(cfg, model, {"tokens": seq}, "train")
        return embedding.logits_fn(cfg, model.tree(), hidden[:, prompt - 1:prompt - 1 + new])


def lm_decode_check(torch, np, cfg, model, batch: int, prompt: int, new: int, what: str,
                    gate: bool = True):
    """``serve`` of ``batch`` prompts with each step's logits, every step
    within LM_DECODE_TOL of the port's full forward at the position it
    decoded (``gate`` False: the gaps only); no kernel of the port
    launched.  Returns (the row, the served logits, the sequence the full
    forward read)."""
    from repro_torch.launch.serve import serve

    p = lm_prompts(np, cfg, batch, prompt)
    reset_counters()
    res = serve(cfg, model, p, batch=batch, max_new=new, return_logits=True)
    check_launches(read_counters(), {}, what)
    seq = np.concatenate([p, res.tokens[:, :-1]], axis=1)
    want = lm_forward_logits(torch, np, cfg, model, seq, prompt, new)
    gaps = [lm_check_close(torch, res.logits[:, t], want[:, t], LM_DECODE_TOL, f"{what} step {t}",
                           gate) for t in range(new)]
    row = dict(batch=batch, prompt=prompt, new=new, max_abs_err_per_step=gaps,
               prefill_ms=res.prefill_s * 1e3, decode_ms_per_step=res.decode_s / res.decode_steps
               * 1e3 if res.decode_steps else None)
    return row, res.logits, seq


def lm_float64_witness(torch, np, cfg, model, logits32, seq32, prompt: int, what: str) -> dict:
    """The spec's init of ``cfg`` in float64 (the float32 draws, cast; every
    op of the model in float64): its own decode within LM_DECODE_TOL of its
    full forward (gated), and, on the float32 run's tokens, how far the
    float32 decode's logits and the float32 full forward's each lie from the
    float64 forward's (reported).  The decode agreeing with the forward in
    float64 while both float32 paths part from it alike says their float32
    gap is rounding, not the decode's cache, mask or self-token fold-in."""
    batch, new = logits32.shape[:2]
    cfg64 = cfg.replace(param_dtype="float64", compute_dtype="float64")
    model64 = lm_model(torch, cfg64)
    exact = lm_forward_logits(torch, np, cfg64, model64, seq32, prompt, new)
    forward32 = lm_forward_logits(torch, np, cfg, model, seq32, prompt, new)
    row64 = lm_decode_check(torch, np, cfg64, model64, batch, prompt, new,
                            f"{what} in float64")[0]
    del model64
    torch.cuda.empty_cache()
    return dict(
        spec_init_fp64_max_abs_err_per_step=row64["max_abs_err_per_step"],
        spec_init_fp32_decode_vs_fp64_forward=[float((logits32[:, t] - exact[:, t]).abs().max())
                                               for t in range(new)],
        spec_init_fp32_forward_vs_fp64_forward=[float((forward32[:, t] - exact[:, t]).abs().max())
                                                for t in range(new)])


def lm_cache_advances(torch, np, cfg, model, prompt: int, steps: int = 2) -> None:
    """The prefill step's cache: ``cur`` at the prompt's length, the
    prompt's positions, −1 beyond; each decode step writes its slot and
    advances ``cur``."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    p = torch.tensor(lm_prompts(np, cfg, 2, prompt), device="cuda")
    logits, cache = make_prefill_step(cfg, seq_len=prompt + steps)(model, {"tokens": p})
    decode = make_decode_step(cfg)
    kv_pos = cache["kv_pos"]
    if int(cache["cur"]) != prompt or (kv_pos[:, prompt:] != -1).any() or \
            (kv_pos[:, :prompt] != torch.arange(prompt, device="cuda")).any():
        raise AssertionError("prefill cache: cur or kv_pos wrong")
    for i in range(steps):
        logits, cache = decode(model, cache, {"tokens": logits.argmax(-1)[:, None]})
        if int(cache["cur"]) != prompt + i + 1 or (cache["kv_pos"][:, prompt + i] != prompt + i).any():
            raise AssertionError(f"decode step {i}: cur or kv_pos did not advance")


def lm_card_vs_cpu(torch, np, cfg32, model32) -> dict:
    """(b) The fp32 weights cut to LM_CPU's layers, on the card and on the
    CPU: prefill logits and each decode step (teacher-forced with the
    card's greedy tokens) within LM_CPU_TOL; TF32 off for matmuls."""
    import copy

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import DenseTransformer

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on for float32 matmuls")
    batch, prompt, steps, layers = LM_CPU
    cfg = cfg32.replace(n_layers=layers)
    card = DenseTransformer(cfg, "cuda")
    weights = dict(model32.named_parameters())
    with torch.no_grad():
        for name, param in card.named_parameters():
            param.copy_(weights[name])
    cpu = copy.deepcopy(card).to("cpu")
    p = lm_prompts(np, cfg, batch, prompt)

    def run(model, device, forced=None):
        logits, cache = make_prefill_step(cfg, seq_len=prompt + steps)(
            model, {"tokens": torch.tensor(p, device=device)})
        decode, out, toks = make_decode_step(cfg), [logits], []
        for i in range(steps):
            tok = logits.argmax(-1) if forced is None else forced[i].to(device)
            toks.append(tok)
            logits, cache = decode(model, cache, {"tokens": tok[:, None]})
            out.append(logits)
        return torch.stack(out, 1), toks

    got, toks = run(card, "cuda")
    t0 = time.perf_counter()
    want, _ = run(cpu, "cpu", toks)
    cpu_s = time.perf_counter() - t0
    gaps = [lm_check_close(torch, got[:, t].cpu(), want[:, t], LM_CPU_TOL, f"card vs CPU step {t}")
            for t in range(steps + 1)]
    return dict(layers=layers, batch=batch, prompt=prompt, steps=steps,
                max_abs_err_per_step=gaps, cpu_s=cpu_s)


def lm_served(torch, np, cfg, first32) -> dict:
    """(c) ``serve`` of LM_SERVED's requests with ``cfg`` (bf16), keeping
    no logits: prefill ms, decode ms a step, tokens a second, peak memory;
    the decode loop of one batch again, timed and profiled (busy and idle);
    prefill's ``model_flops`` over the bf16 peak.  The same requests served
    again keeping every step's logits (1.07 GB in float32, not in the
    peak): the first token's logits against the fp32 run's ``first32``
    (reported).  Gates: every logit finite, every request answered in both
    runs, no kernel of the port launched."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.roofline import hw, model_flops

    requests, batch, prompt, new = LM_SERVED
    model = lm_model(torch, cfg)
    p = lm_prompts(np, cfg, requests, prompt)
    serve(cfg, model, p[:1, :64], batch=1, max_new=2)              # loads cuBLAS' bf16 paths
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = serve(cfg, model, p, batch=batch, max_new=new)
    wall = time.perf_counter() - t0
    check_launches(read_counters(), {}, "served run")
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_counters()
    checked = serve(cfg, model, p, batch=batch, max_new=new, return_logits=True)
    check_launches(read_counters(), {}, "served run keeping its logits")
    for run in (res, checked):
        if run.tokens.shape != (requests, new) or \
                not ((0 <= run.tokens) & (run.tokens < cfg.vocab_padded)).all():
            raise AssertionError(f"served run: tokens {run.tokens.shape}, want {(requests, new)}")
    if not torch.isfinite(checked.logits).all():
        raise AssertionError("served run: non-finite logits")
    first = checked.logits[:batch, 0]
    agree = float((first.argmax(-1) == first32.argmax(-1)).float().mean())
    tokens_equal = bool((res.tokens == checked.tokens).all())
    del checked

    # the first LM_LOOP_STEPS decode steps of the first batch, alone: a
    # fresh copy of the positions a run, so that each run decodes into
    # unwritten slots
    logits0, cache0 = make_prefill_step(cfg, seq_len=prompt + new)(
        model, {"tokens": torch.tensor(p[:batch], device="cuda")})
    decode, kv_pos0 = make_decode_step(cfg), cache0["kv_pos"].clone()

    def loop():
        cache, tok = dict(cache0, kv_pos=kv_pos0.clone()), logits0.argmax(-1)
        for _ in range(LM_LOOP_STEPS):
            logits, cache = decode(model, cache, {"tokens": tok[:, None]})
            tok = logits.argmax(-1)
        return tok

    _, stats = timed(torch, loop)
    check_launches(stats["launches"], {}, "decode loop")
    busy = device_busy(torch, loop, stats["wall_s"], NO_LAUNCHES)[1]
    prefill_batch_s = res.prefill_s / res.batches
    flops = model_flops(cfg, Shape("served prefill", prompt, batch, "prefill"))
    return dict(requests=requests, batch=batch, prompt=prompt, new=new, wall_s=wall,
                prefill_ms=prefill_batch_s * 1e3,
                decode_ms_per_step=res.decode_s / res.decode_steps * 1e3,
                tokens_per_s=requests * new / wall,
                decode_tokens_per_s=batch * res.decode_steps / res.decode_s,
                peak_gib=peak, decode_loop_wall_s=stats["wall_s"],
                decode_loop_busy_s=busy["device_busy_s"], decode_loop_idle_share=busy["idle_share"],
                prefill_model_flops=flops,
                prefill_flops_share_of_bf16_peak=flops / prefill_batch_s / hw.PEAK_FLOPS_BF16,
                first_token_max_abs_gap_vs_fp32=float((first - first32).abs().max()),
                first_token_top1_agreement_vs_fp32=agree,
                tokens_equal_between_runs=tokens_equal)


def phase_lm_serve(torch, np, spec: dict) -> dict:
    """Phase 19, in a process of its own: the LM stack's serving path
    (``repro_torch.launch.serve``: prefill, then greedy decode) on the card,
    (a)-(d) as the module docstring says."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step

    t0 = time.perf_counter()
    cfg16 = get_config(LM_ARCH)
    cfg32 = cfg16.replace(param_dtype="float32", compute_dtype="float32")
    model32 = lm_model(torch, cfg32)
    batch, prompt, new = LM_CHECK
    check = lm_decode_check(torch, np, cfg32, model32, batch, prompt, new,
                            f"{LM_ARCH} fp32 decode vs full forward")[0]
    lm_cache_advances(torch, np, cfg32, model32, prompt)
    check["seconds"] = time.perf_counter() - t0
    say(f"phase 19 (a) {LM_ARCH} fp32 {cfg32.n_layers} layers decode vs full forward: "
        + json.dumps(check))
    requests, sbatch, sprompt, _ = LM_SERVED
    first32, _ = make_prefill_step(cfg32, seq_len=sprompt)(
        model32, {"tokens": torch.tensor(lm_prompts(np, cfg32, requests, sprompt)[:sbatch],
                                         device="cuda")})

    t0 = time.perf_counter()
    against_cpu = lm_card_vs_cpu(torch, np, cfg32, model32)
    against_cpu["seconds"] = time.perf_counter() - t0
    say(f"phase 19 (b) {LM_ARCH} fp32 card vs CPU: " + json.dumps(against_cpu))
    del model32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    served = lm_served(torch, np, cfg16, first32)
    served["seconds"] = time.perf_counter() - t0
    say(f"phase 19 (c) {LM_ARCH} bf16 served: " + json.dumps(served))
    torch.cuda.empty_cache()

    others = {}
    for arch, layers, in_float64 in LM_OTHERS:
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(n_layers=layers, param_dtype="float32",
                                       compute_dtype="float32")
        model = lm_model(torch, cfg)
        torch.cuda.reset_peak_memory_stats()
        batch, prompt, steps = LM_OTHER_SHAPE
        # the spec's init: gated in float64 where it fits the card, else in float32
        what = f"{arch} decode vs full forward, the spec's init"
        spec_init, logits32, seq32 = lm_decode_check(torch, np, cfg, model, batch, prompt,
                                                     steps + 1, what, gate=not in_float64)
        witness = lm_float64_witness(torch, np, cfg, model, logits32, seq32, prompt, what) \
            if in_float64 else {}
        del logits32
        lm_unit_attention(torch, cfg, model)
        others[arch] = row = lm_decode_check(torch, np, cfg, model, batch, prompt, steps + 1,
                                             f"{arch} decode vs full forward")[0]
        row.update(layers=layers, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   spec_init_max_abs_err_per_step=spec_init["max_abs_err_per_step"],
                   **witness, seconds=time.perf_counter() - t0)
        say(f"phase 19 (d) {arch} fp32 {layers} layers decode vs full forward: " + json.dumps(row))
        del model
        torch.cuda.empty_cache()
    return dict(check=check, against_cpu=against_cpu, served=served, others=others)


LATER_PHASES_FLAG, PROFILE_CHAIN_FLAG = "--later-phases", "--profile-chain"
BATCH_FLAG = "--batch"
SERVICE_FLAG = "--service"
DISTRIBUTED_FLAG = "--distributed"
SHARDED_CHAIN_FLAG = "--sharded-chain"
SHARDED_WINDOW_FLAG = "--sharded-window"
TWO_PHASE_FLAG = "--two-phase"
BASELINES_FLAG = "--baselines"
LM_SERVE_FLAG = "--lm-serve"


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
            BATCH_FLAG: phase_batch, SERVICE_FLAG: phase_service,
            DISTRIBUTED_FLAG: phase_distributed, SHARDED_CHAIN_FLAG: phase_sharded_chain,
            SHARDED_WINDOW_FLAG: sharded_window_child, TWO_PHASE_FLAG: phase_two_phase,
            BASELINES_FLAG: phase_baselines, LM_SERVE_FLAG: phase_lm_serve}


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
            batch: dict, service: dict, distributed: dict, sharded: dict,
            two_phase: dict, baselines: dict, lm: dict) -> str:
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
    for variant in ("baseline", "rowmin", "lazy"):
        s, u = distributed["paper"][variant], distributed["paper"][f"{variant}_unstaged"]
        parts.append(f"distributed {variant} n={PAPER_N} wall_s {g(s['wall_s'])} "
                     + (f"busy_s {g(s['device_busy_s'])} idle {g(s['idle_share'])} host/device "
                        f"ms per merge {g(s['host_ms_per_merge'])}/"
                        f"{g(s['device_ms_per_merge'])} " if "device_busy_s" in s else "")
                     + f"collectives {s['collectives']}; unstaged wall_s {g(u['wall_s'])}")
    parts.append(f"distributed rmsd build wall_s {g(distributed['rmsd']['build_wall_s'])} err "
                 f"{g(distributed['rmsd']['max_abs_err_vs_cpu'])}; batch wall_s "
                 f"{g(distributed['batch']['wall_s'])} (serial "
                 f"{g(distributed['batch']['serial_wall_s'])})")
    for m in SHARDED_METHODS:
        r, w = sharded[m], sharded[m].get("window")
        parts.append(f"sharded chain {m} n={r['n']} wall_s {g(r['wall_s'])} trips {r['trips']} "
                     f"collectives {r['collectives']} peak_gib {g(r['peak_gib'])}"
                     + (f"; window busy_s {g(w['device_busy_s'])} idle {g(w['idle_share'])} "
                        f"host/device ms per trip {g(w['host_ms_per_trip'])}/"
                        f"{g(w['device_ms_per_trip'])}" if w else "")
                     + f"; host loop wall_s {g(r['host_loop_wall_s'])}")
    seg = sharded["segmented"]
    parts.append(f"sharded chain n={PAPER_N} segmented wall_s {g(seg['wall_s'])} restarts "
                 f"{seg['restarts']} stragglers "
                 f"{seg['stragglers']} segments {seg['segments']}; cluster() wall_s "
                 f"{g(sharded['cluster_wall_s'])}")
    f, q = two_phase["full"], two_phase["quality"]
    parts.append(f"two-phase n={f['n']} shards={f['shards']} K={f['summaries']} wall_s "
                 f"{g(f['wall_s'])} busy_s {g(f['device_busy_s'])} idle {g(f['idle_share'])} "
                 f"ari {g(f['ari'])} peak_gib {g(f['peak_gib'])}; " + ", ".join(
                     f"{k} trips {v['trips']} host/device ms per trip "
                     f"{g(v['host_ms_per_trip'])}/{g(v['device_ms_per_trip'])}"
                     for k, v in f["phases"].items())
                 + f"; host s replay {g(f['replay_host_s'])} canonical "
                 f"{g(f['canonical_host_s'])}; n={CHAIN_N} agreement / cut ari: " + ", ".join(
                     f"{k} {g(v['merge_set_agreement'])} / {g(v['cut_ari'])}"
                     for k, v in q.items())
                 + f"; card vs CPU n="
                 f"{PAPER_N} max height diff " + ", ".join(
                     f"{k} {g(v['max_abs_height_diff'])}"
                     for k, v in two_phase["against_cpu"].items() if "cpu_wall_s" in v))
    for label, s in baselines.items():
        parts.append(f"{label} wall_s {g(s['wall_s'])}"
                     + (f" busy_s {g(s['device_busy_s'])} idle {g(s['idle_share'])}"
                        if "device_busy_s" in s else "")
                     + f" peak_gib {g(s['peak_gib'])}"
                     + (f" inertia {g(s['inertia'])} Lloyd steps with near-tie labels "
                        f"{s['steps_with_differing_labels']} Lloyd ms "
                        f"{g(s['lloyd_ms'])} bound {g(s['bound_ms'])}" if "inertia" in s else
                        f" tied runs {s['tied_runs']}"))
    c, a, v = lm["check"], lm["against_cpu"], lm["served"]
    parts.append(f"lm {LM_ARCH} fp32 decode vs forward max err {g(max(c['max_abs_err_per_step']))}; "
                 f"card vs CPU max err {g(max(a['max_abs_err_per_step']))}; bf16 served "
                 f"{v['requests']} requests prefill_ms {g(v['prefill_ms'])} decode ms/step "
                 f"{g(v['decode_ms_per_step'])} tokens/s {g(v['tokens_per_s'])} peak_gib "
                 f"{g(v['peak_gib'])} decode loop busy_s {g(v['decode_loop_busy_s'])} idle "
                 f"{g(v['decode_loop_idle_share'])} prefill flops/bf16 peak "
                 f"{g(v['prefill_flops_share_of_bf16_peak'])} first-token gap vs fp32 "
                 f"{g(v['first_token_max_abs_gap_vs_fp32'])} top-1 agreement "
                 f"{g(v['first_token_top1_agreement_vs_fp32'])}; " + ", ".join(
                     f"{k} max err {g(max(r['max_abs_err_per_step']))} (spec init "
                     f"{g(max(r['spec_init_max_abs_err_per_step']))}) peak_gib {g(r['peak_gib'])}"
                     for k, r in lm["others"].items()))
    return "summary: " + "; ".join(parts)


def kernel_inventory(kernels: dict, full: dict, lazy: dict, points: dict, assigned: dict,
                     batch: dict, service: dict, sharded: dict, two_phase: dict) -> list:
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
    # entry's launches and times, and lists every entry under "entries";
    # B5's vote entry runs once a trip of the sharded chain (phase 16's ward
    # run, at its shard shape), its row entry once a trip of phase 16's
    # host-driven reference loop; B5's trip entry also from phase 2's seed of the
    # two-phase tier (phase 17: ward's launches in the full-width run, average's
    # and weighted's in the paper-size runs)
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
    row_main = sharded["ward"]
    b_kernel, b_lazy = batch["full"]["kernel"], batch["full"]["kernel_lazy"]
    inventory = []
    for name, entries in (
            ("masked_argmin", [("masked_argmin", ("masked_argmin/seed", FULL_N), full),
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
                                  ("chain_vote", ("chain_vote", row_main["n"]), row_main),
                                  ("row_sq_euclidean", ("row_sq_euclidean", row_main["n"]),
                                   dict(launches=row_main["host_loop_launches"]))]),
            ("pairwise_sq_euclidean", [("pairwise_sq_euclidean",
                                        ("pairwise_sq_euclidean", QUERY_N),
                                        assigned["centroid"]["kernel"])])):
        listed = [dict(entry=entry, **numbers(key, path, entry)) for entry, key, path in entries]
        for row in listed:                        # the single lazy merge's second launch
            if row["entry"] in service["card"]["launches"] and row["entry"].endswith("_batch"):
                row["service_launches"] = service["card"]["launches"][row["entry"]]
            if row["entry"] == "lazy_merge":
                row["rescan_launches"] = lazy["launches"]["lazy_rescan"]
            if row["entry"] == "masked_argmin":        # the seed's all-live state, and mid-run
                row["mid_run_ms"] = kernels[("masked_argmin", FULL_N)]["ms"]
        if name == "row_sq_euclidean":
            for method, row in two_phase["rows"].items():
                launches = (two_phase["full"]["launches"] if method == "ward" else
                            {"chain_trip": two_phase["against_cpu"][method]["launches"]})
                key = (f"chain_trip/summaries/{method}", row["m"])
                kernels[key] = row
                listed.append(dict(entry="chain_trip", seed=f"two-phase summaries, {method}",
                                   **numbers(key, dict(launches=launches), "chain_trip")))
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
        row = phase_vote(torch, m, d, l2_rate)
        say(f"phase 2 chain_vote m={m} d={d}: " + json.dumps(row))
        kernels[("chain_vote", m)] = row
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
    serial, paper_serial = phase_serial(torch, np, X_mid, X_paper, paper_merges)
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
    distributed = run_child(torch, DISTRIBUTED_FLAG, dict(paper_serial=paper_serial))
    sharded = run_child(torch, SHARDED_CHAIN_FLAG, {})
    two_phase = run_child(torch, TWO_PHASE_FLAG, dict(l2_rate=l2_rate))
    baselines = run_child(torch, BASELINES_FLAG, dict(l2_rate=l2_rate))
    lm = run_child(torch, LM_SERVE_FLAG, {})

    # 20. inventory, card, result
    inventory = kernel_inventory(kernels, full, lazy, points, assigned, batch, service, sharded,
                                 two_phase)
    print(summary(kernels, paper, full, dense, points, serial, lazy, assigned, landmark, rmsd,
                  batch, service, distributed, sharded, two_phase, baselines, lm))
    print(json.dumps({"kernels": inventory}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


DISTRIBUTED_FULL_FLAG = "--distributed-full"


def distributed_full() -> int:
    """``python3 chip_smoke.py --distributed-full``: the full-size runs of
    phases 15 and 16, out of the smoke for their time.  On a world-size-1
    NCCL group: the distributed ``rowmin`` and ``lazy`` at the paper's size,
    staged, profiled (:func:`distributed_run`); the distributed
    ``baseline`` at n = 16384 (phase 4's points), staged, against the
    slots of phase 4's kernel-backend run; then the
    sharded chain at n = 8192, d = 128 for ward, average and weighted
    (:func:`sharded_methods`) and at n = 32768, d = 128
    (:func:`sharded_chain_full`).  Prints the card's line and one JSON
    line: the LW run's wall, peak memory, collectives and the rank's block
    bytes at each stage, and the chains' numbers."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from repro_torch.core import build_distance_matrix, cluster
    from repro_torch.core.distributed import make_cluster_mesh
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import _build

    _build.build_all()
    X = gaussian_mixture(seed=0, n=FULL_N, dim=DIM, return_labels=False)
    want = cluster(X, "complete", algorithm="lw", backend="kernel", keep_inputs=False).merges
    torch.cuda.empty_cache()
    ring = make_cluster_mesh()
    try:
        Xp = gaussian_mixture(seed=0, n=PAPER_N, dim=DIM, return_labels=False)
        Dp = build_distance_matrix(Xp, "euclidean")
        paper = {variant: distributed_run(torch, np, ring, Dp, variant, True, None,
                                          f"distributed {variant} n={PAPER_N}")[1]
                 for variant in ("rowmin", "lazy")}
        D = build_distance_matrix(X, "euclidean")
        res, full = distributed_run(torch, np, ring, D, "baseline", True, None,
                                    f"distributed baseline n={FULL_N}", profile=False)
        check_merges(np, res.merges.cpu().numpy(), want,
                     f"distributed n={FULL_N} vs the kernel backend")
        del D, res
        torch.cuda.empty_cache()
        mid = sharded_methods(torch, np, ring, MID_N, CHAIN_DIM, "distributed-full")[0]
        chain = sharded_chain_full(torch, np, ring)
    finally:
        dist.destroy_process_group()
    print(gpu_line())
    print(json.dumps(dict(lw=dict(n=FULL_N, **full), lw_paper=paper, sharded_chain_mid=mid,
                          sharded_chain=chain)))
    return 0


SINGLE_TIMES_FLAG = "--single-kernel-times"


def single_kernel_times(src: str | None) -> int:
    """``python3 chip_smoke.py --single-kernel-times [SRC]``: phase 2's rows of
    the single-problem entries of B1, B2 and B3, and B5's vote entry where
    the tree has one (their checks included) for
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
    from repro_torch.kernels import pairwise

    if hasattr(pairwise, "chain_vote"):         # B5's vote entry, and the composition it replaced
        for m, d in ROW_SHAPES:
            row = phase_vote(torch, m, d, l2_rate)
            rows[f"chain_vote m={m} d={d}"] = row["ms"]
            rows[f"chain_vote composition m={m} d={d}"] = row["composition_ms"]
            rows[f"chain_vote half dead m={m} d={d}"] = row["half_dead_ms"]
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
    if sys.argv[1:2] == [DISTRIBUTED_FULL_FLAG]:
        sys.exit(distributed_full())
    sys.exit(child(sys.argv[1]) if sys.argv[1:2] and sys.argv[1] in CHILDREN else main())
