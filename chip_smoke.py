#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the card's name and power limit.
2. Hold each kernel against its plain torch version on the card, on a
   mid-run state with dead slots at n = 1968 and n = 16384, and time both.
3. The paper's configuration: n = 1968 points in 64 dimensions, complete
   linkage, through ``cluster(..., algorithm="lw", backend="kernel")``;
   merges equal the engine run with the plain step functions, heights
   match scipy's, and the launch counters read 1 and n - 1.
4. Full size: n = 16384 (a 1 GiB float32 matrix) through the same call;
   wall time and peak memory; the first 256 merges equal the plain
   engine's.  Phases 3 and 4 also read the device's busy time over a
   second, profiled run of the whole call, and set the host's time per
   merge against the device's over a window (showing that the loop never
   waits for the card).
5. One line ``{"kernels": [...]}`` with each kernel's numbers, the card's
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Needs one CUDA device and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
PAPER_N, FULL_N, DIM = 1968, 16384, 64
PREFIX = 256                   # merges of the full-size run held against the plain engine
SPLIT_WINDOW = 16              # merges whose host time is set against their device time
SLEEP_CYCLES = 400_000_000     # ~0.2 s of GPU clock: holds the stream while the host enqueues
RTOL, ATOL = 1e-4, 1e-5        # height tolerance of the JAX package's kernel tests
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
KERNEL_SYMBOLS = {             # wrapper -> its device functions, the first once a launch
    "masked_argmin": ("masked_row_min", "first_min_over_rows"),
    "lw_step": ("lw_step_kernel",),
}


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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least ms the card could take, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def phase_kernels(torch, n: int) -> dict:
    """Each kernel against its plain version at size n; times and bounds."""
    from repro_torch.kernels import lw_step, minscan

    out = {}
    D, alive, sizes, i, j, _ = mid_run_state(torch, n, squared=False, seed=1)
    live = int(alive.sum())
    v, flat = minscan.masked_argmin(D, alive)
    vp, flatp = minscan.masked_argmin_plain(D, alive)
    if (float(v), int(flat)) != (float(vp), int(flatp)):
        raise AssertionError(f"masked_argmin n={n}: kernel {(float(v), int(flat))} "
                             f"!= plain {(float(vp), int(flatp))}")
    # read the live submatrix and alive, write one value and one index;
    # one compare a live cell
    bound_ms, bound_by = bound(4 * live * live + n + 12, live * live)
    out["masked_argmin"] = dict(
        n=n, live=live, max_abs_err=abs(float(v) - float(vp)),
        ms=time_ms(torch, lambda: minscan.masked_argmin(D, alive)),
        plain_ms=time_ms(torch, lambda: minscan.masked_argmin_plain(D, alive)),
        bound_ms=bound_ms, bound_by=bound_by,
    )

    for method in ("complete", "ward"):
        D, alive, sizes, i, j, dmin = mid_run_state(torch, n, squared=method == "ward", seed=2)
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
        if not torch.equal(rarg_k, rarg_p):
            raise AssertionError(f"lw_step {method} n={n}: rarg differs")
        for a, b, what in ((Dk, Dp, "D"), (rmin_k, rmin_p, "rmin")):
            if not torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                raise AssertionError(f"lw_step {method} n={n}: {what} differs")
        fin = torch.isfinite(rmin_p)
        err = max(float((Dk - Dp).abs().max()), float((rmin_k[fin] - rmin_p[fin]).abs().max()))
        live_next = int(alive.sum()) - 1      # j dies in the merge
        # read the live submatrix, write row and column i, read the two rows,
        # sizes and alive, write rmin and rarg; a compare and a select a live
        # cell, about a dozen operations for the recurrence of each lane
        bound_ms, bound_by = bound(4 * live_next * live_next + 8 * live_next + 25 * n,
                                   2 * live_next * live_next + 12 * n)
        out[f"lw_step/{method}"] = dict(
            n=n, live=live_next, max_abs_err=err,
            ms=time_ms(torch, lambda: lw_step.lw_step(*kargs)),
            plain_ms=time_ms(torch, lambda: lw_step.lw_step_plain(*pargs)),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        del Dk, Dp, kargs, pargs
    return out


def plain_engine_merges(torch, X, method: str, n_steps: int):
    """The same problem through the engine with the plain step functions."""
    from repro_torch.core import engine
    from repro_torch.core.api import build_distance_matrix
    from repro_torch.kernels import lw_step, minscan

    D = engine.symmetrize(build_distance_matrix(X, "euclidean"))
    n = D.shape[0]
    ops = engine._fused_ops(method, n, minscan.masked_argmin_plain, lw_step.lw_step_plain)
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    state = engine.run_merge_loop(ops, engine._init_state(D, alive, n_steps), n_steps)
    return state.merges.cpu().numpy()


def reset_counters() -> None:
    from repro_torch.kernels import lw_step, minscan

    minscan.masked_argmin.launches = 0
    lw_step.lw_step.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels import lw_step, minscan

    return {"masked_argmin": minscan.masked_argmin.launches, "lw_step": lw_step.lw_step.launches}


def run_cluster(torch, X):
    """The main path: wall seconds, peak memory and launches of one run,
    then the device's busy time over a second run of the same call."""
    from repro_torch.core import cluster

    def call():
        res = cluster(X, "complete", algorithm="lw", backend="kernel", keep_inputs=False)
        torch.cuda.synchronize()
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = call()
    wall = time.perf_counter() - t0
    stats = dict(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 launches=read_counters())
    stats.update(device_busy(torch, call, wall, stats["launches"]))
    return res, stats


def device_busy(torch, call, wall_s: float, launches: dict) -> dict:
    """Device busy seconds over a whole run of ``call``, summed from the
    profiler's records of every kernel, copy and fill on the card (one
    stream, so they do not overlap); the idle share is the rest of the
    unprofiled run's wall time.  The profiler must have seen every launch
    that the counters saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        profiled_wall = time.perf_counter() - t0
    busy_us = 0.0
    kernel_us, kernel_n = dict.fromkeys(KERNEL_SYMBOLS, 0.0), dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        for name, symbols in KERNEL_SYMBOLS.items():
            if any(sym in e.name for sym in symbols):
                kernel_us[name] += us
                kernel_n[name] += symbols[0] in e.name
    if kernel_n != launches:
        raise AssertionError(f"the profiler saw launches {kernel_n}, the counters {launches}")
    return dict(device_busy_s=busy_us / 1e6, idle_share=1 - busy_us / 1e6 / wall_s,
                profiled_wall_s=profiled_wall,
                kernel_ms_mean={k: kernel_us[k] / 1e3 / max(kernel_n[k], 1) for k in kernel_us},
                kernel_busy_share={k: kernel_us[k] / busy_us for k in kernel_us})


def host_device_split(torch, X) -> dict:
    """Host and device ms per merge over the first merges of a run.

    A sleep kernel holds the stream while the host enqueues the window, so
    the host time has no waits in it and the device time no gaps.  A loop
    that synced with the card on any merge would wait out the sleep: the
    host time staying under the sleep shows that it does not.
    """
    from repro_torch.core import engine
    from repro_torch.core.api import build_distance_matrix

    D = engine.symmetrize(build_distance_matrix(X, "euclidean"))
    n = D.shape[0]
    ops = engine.kernel_ops("complete", n)
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    state = ops.seed(engine._init_state(D, alive, SPLIT_WINDOW))
    step = engine.make_step(ops)
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    held.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for t in range(SPLIT_WINDOW):
        state = step(state, t)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    sleep_ms = held.elapsed_time(start)
    if host_ms >= sleep_ms:
        raise AssertionError(f"enqueueing {SPLIT_WINDOW} merges took {host_ms:.1f} ms, "
                             f"longer than the {sleep_ms:.1f} ms the stream was held")
    return dict(split_window=SPLIT_WINDOW, host_ms_per_merge=host_ms / SPLIT_WINDOW,
                device_ms_per_merge=start.elapsed_time(end) / SPLIT_WINDOW,
                stream_held_ms=sleep_ms)


def phase_paper(torch, np) -> dict:
    import scipy.cluster.hierarchy as sch

    from repro_torch.core.dendrogram import validate_merges
    from repro_torch.data.synthetic import gaussian_mixture

    n = PAPER_N
    X = gaussian_mixture(seed=0, n=n, dim=DIM, return_labels=False)
    res, stats = run_cluster(torch, X)
    if stats["launches"] != {"masked_argmin": 1, "lw_step": n - 1}:
        raise AssertionError(f"paper run launches {stats['launches']}, want 1 and {n - 1}")
    validate_merges(res.merges, n=n)
    check_merges(np, res.merges, plain_engine_merges(torch, X, "complete", n - 1),
                 "paper run vs plain engine")
    want = np.sort(sch.linkage(X.astype(np.float64), "complete")[:, 2])
    np.testing.assert_allclose(np.sort(res.heights()), want, rtol=RTOL, err_msg="vs scipy")
    stats.update(host_device_split(torch, X))
    return stats


def phase_full(torch, np) -> dict:
    from repro_torch.core.dendrogram import is_monotone, validate_merges
    from repro_torch.data.synthetic import gaussian_mixture

    n = FULL_N
    X = gaussian_mixture(seed=0, n=n, dim=DIM, return_labels=False)
    res, stats = run_cluster(torch, X)
    if stats["launches"] != {"masked_argmin": 1, "lw_step": n - 1}:
        raise AssertionError(f"full run launches {stats['launches']}, want 1 and {n - 1}")
    validate_merges(res.merges, n=n)
    if not is_monotone(res.merges):
        raise AssertionError("complete-linkage heights are not monotone")
    check_merges(np, res.merges[:PREFIX], plain_engine_merges(torch, X, "complete", PREFIX),
                 f"first {PREFIX} merges vs plain engine")

    stats.update(host_device_split(torch, X))
    return stats


def summary(kernels: dict, paper: dict, full: dict) -> str:
    """The numbers a reader checks first, on one line near the end."""
    def g(x):
        return f"{x:.6g}"

    parts = [f"{name} n={n} ms {g(r['ms'])} bound {g(r['bound_ms'])} plain {g(r['plain_ms'])}"
             for (name, n), r in kernels.items()]
    for label, s in (("paper", paper), ("full", full)):
        parts.append(f"{label} wall_s {g(s['wall_s'])} busy_s {g(s['device_busy_s'])} "
                     f"idle {g(s['idle_share'])} host/device ms per merge "
                     f"{g(s['host_ms_per_merge'])}/{g(s['device_ms_per_merge'])} "
                     f"peak_gib {g(s['peak_gib'])}")
    return "summary: " + "; ".join(parts)


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
    print(f"phase 1 build: {build_s:.2f} s; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; {card}", flush=True)

    # 2. kernels against their plain versions
    kernels = {}
    for n in (PAPER_N, FULL_N):
        for name, row in phase_kernels(torch, n).items():
            print(f"phase 2 {name} n={n}: " + json.dumps(row), flush=True)
            kernels[(name, n)] = row
        torch.cuda.empty_cache()

    # 3. the paper's configuration
    paper = phase_paper(torch, np)
    print("phase 3 paper n=1968 complete: " + json.dumps(paper), flush=True)
    torch.cuda.empty_cache()

    # 4. full size
    full = phase_full(torch, np)
    print(f"phase 4 full n={FULL_N} complete: " + json.dumps(full), flush=True)

    # 5. inventory, card, result
    src = {"masked_argmin": ("src/repro_torch/csrc/minscan.cu", "src/repro/kernels/minscan.py:71"),
           "lw_step": ("src/repro_torch/csrc/lw_step.cu", "src/repro/kernels/lw_step.py:154")}
    inventory = []
    for name, key in (("masked_argmin", "masked_argmin"), ("lw_step", "lw_step/complete")):
        row = kernels[(key, FULL_N)]
        inventory.append(dict(
            name=name, route="cuda", source=src[name][0], replaces=src[name][1],
            launches=full["launches"][name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None, n=FULL_N,
        ))
    print(summary(kernels, paper, full))
    print(json.dumps({"kernels": inventory}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
