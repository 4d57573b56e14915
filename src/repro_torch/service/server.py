"""Synthetic load drivers (open- and closed-loop) + metrics reports.

Counterpart of :mod:`repro.service.server`.  Drives a
:class:`~repro_torch.service.batcher.ClusteringService` with an
open-loop Poisson arrival process (arrivals are scheduled independently
of completions — the honest way to measure a server: a closed loop
self-throttles and hides queueing collapse), then reports the serving
metrics the ROADMAP cares about: p50/p99 latency, throughput, padding
waste, cache hit rate, and — the zero-build invariant — bucket programs
built and CUDA graphs captured after warmup.

    PYTHONPATH=src python -m repro_torch.service.server --rate 200 --duration 3

runs on the card; ``--device cpu`` runs the kernels' plain versions on
the CPU.
The closed loop has its one honest use — measuring *capacity* (a
saturated closed loop cannot overload itself, so its completion rate IS
the service's sustainable throughput) — and :func:`overload_sweep`
builds on it: measure capacity closed-loop, then drive open-loop at
0.5×–4× that capacity with a priority-lane traffic mix and per-request
deadlines, reporting goodput, shed rate and p99-of-admitted at each
multiple (DESIGN.md §14; ``--overload`` from the CLI).

Problem matrices are pre-generated with numpy so the generator measures
the service, not itself.

Observability (DESIGN.md §13): ``--trace-out run.trace.json`` records
the full span story (submit → pack → cache → execute → resolve, one
trace id per request) and writes Chrome trace-event JSON — load it in
``chrome://tracing`` or https://ui.perfetto.dev.  ``--metrics-out
run.metrics.json`` dumps the service's metrics registry as JSON
(periodically during the run via ``--metrics-period``, and always once
at exit); ``--prometheus`` prints the text exposition to stdout.
"""

from __future__ import annotations

import argparse
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from repro_torch.obs import PeriodicDumper, Tracer, dump_json, prometheus_text
from repro_torch.service.batcher import ClusteringService, MetricsSnapshot, ServiceConfig
from repro_torch.service.cache import engine_jit_cache_size
from repro_torch.service.errors import DeadlineExceeded, ServiceOverloaded


def synthetic_problem(rng: np.random.Generator, n: int, dim: int = 8) -> np.ndarray:
    """One (n, n) Euclidean distance matrix over random points (numpy only)."""
    X = rng.normal(size=(n, dim))
    D = np.sqrt(np.maximum(((X[:, None] - X[None]) ** 2).sum(-1), 0.0))
    return D.astype(np.float32)


@dataclass(frozen=True)
class LoadReport:
    """One load run: the service snapshot plus driver-side accounting."""

    snapshot: MetricsSnapshot
    elapsed_s: float
    n_submitted: int
    n_errors: int
    n_unresolved: int           # requests still pending at drain timeout
    warmup_compiles: int        # bucket programs built by warmup
    steady_compiles: int        # programs built during the timed run (want: 0)
    steady_jit_growth: int      # programs + graphs captured during it (want: 0)

    @property
    def throughput_rps(self) -> float:
        return self.n_submitted / self.elapsed_s if self.elapsed_s else 0.0


def run_load(
    service: ClusteringService,
    *,
    rate_hz: float,
    duration_s: float,
    sizes: tuple[int, ...],
    seed: int = 0,
    dim: int = 8,
    pool: int = 64,
    as_points: bool = False,
) -> tuple[list[Future], float, bool]:
    """Open-loop Poisson arrivals of ragged problems.

    Returns ``(futures, elapsed_s, drained)`` — ``drained=False`` means
    the backlog did not clear within the drain timeout (the service is
    past saturation; some futures are still pending).  ``sizes`` are the
    real problem sizes to draw from (they need not be bucket-aligned —
    the batcher rounds them up); a ``pool`` of matrices is generated up
    front so the arrival loop does no problem-building work of its own.

    ``as_points=True`` submits raw ``(n, dim)`` point sets under the
    service method's default metric instead of pre-built matrices — the
    traffic shape that exercises the matrix-free NN-chain buckets (the
    matrix build then happens on the worker, on the service's device, for
    LW buckets and never for nnchain buckets, so the A/B is end-to-end
    honest).
    """
    rng = np.random.default_rng(seed)
    if as_points:
        problems = [
            rng.normal(size=(int(rng.choice(sizes)), dim)).astype(np.float32)
            for _ in range(pool)
        ]
    else:
        problems = [
            synthetic_problem(rng, int(rng.choice(sizes)), dim)
            for _ in range(pool)
        ]
    futures: list[Future] = []
    t0 = time.perf_counter()
    deadline = t0 + duration_s
    t_next = t0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if now < t_next:
            time.sleep(min(t_next - now, 0.002))
            continue
        # is_distance=True skips the O(n²) square-input ambiguity check —
        # the cheap disambiguation the service path exists to use
        futures.append(
            service.submit(
                problems[len(futures) % pool],
                is_distance=False if as_points else True,
            )
        )
        t_next += rng.exponential(1.0 / rate_hz)
    drained = service.flush(timeout=120.0)
    return futures, time.perf_counter() - t0, drained


def run_closed_loop(
    service: ClusteringService,
    *,
    duration_s: float,
    sizes: tuple[int, ...],
    seed: int = 0,
    dim: int = 8,
    pool: int = 32,
    concurrency: int = 16,
    as_points: bool = False,
) -> float:
    """Closed-loop saturation: ``concurrency`` workers submit→wait→resubmit.

    Returns the completion rate in req/s.  A closed loop self-throttles,
    which is exactly why this is the honest *capacity* probe: it cannot
    offer more than the service completes, so its completion rate is the
    sustainable throughput the overload sweep's multiples are scaled
    from.  ``concurrency`` should be ≥ ``2 × max_batch`` so the batching
    window always closes full and the engine pipeline never starves.
    ``as_points`` submits ``(n, dim)`` point sets, as :func:`run_load`
    does.
    """
    rng = np.random.default_rng(seed)
    if as_points:
        problems = [
            rng.normal(size=(int(rng.choice(sizes)), dim)).astype(np.float32)
            for _ in range(pool)
        ]
    else:
        problems = [
            synthetic_problem(rng, int(rng.choice(sizes)), dim)
            for _ in range(pool)
        ]
    served = [0] * concurrency
    stop = threading.Event()

    def worker(k: int) -> None:
        i = k
        while not stop.is_set():
            fut = service.submit(problems[i % pool], is_distance=not as_points)
            try:
                fut.result(timeout=120)
                served[k] += 1
            except Exception:  # noqa: BLE001 — capacity probe counts successes
                pass
            i += concurrency

    threads = [
        threading.Thread(target=worker, args=(k,), daemon=True)
        for k in range(concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    return sum(served) / (time.perf_counter() - t0)


#: Overload-sweep traffic mix: (lane, fraction of arrivals).  Lane 0
#: (highest priority) is the thin paid tier; lane 2 carries the bulk —
#: so a 4× overload (which must shed ~75% of arrivals) is absorbable
#: entirely by the lowest class, and "shedding stays confined to lane 2"
#: is a meaningful gate rather than an arithmetic impossibility.  The
#: high lanes must stay thin: at the sweep's top multiple M their joint
#: demand is ``M × (f0 + f1) × capacity``, and once that approaches
#: capacity they queue among themselves, lane 2 drains empty, and
#: shed-oldest starts eating lane 1 — with 10% here, 4× keeps the
#: high-priority demand at 0.4× capacity, comfortably inside it.
OVERLOAD_LANE_MIX: tuple[tuple[int, float], ...] = (
    (0, 0.02), (1, 0.08), (2, 0.90),
)


@dataclass(frozen=True)
class OverloadPoint:
    """One sweep point: open-loop load at ``multiple`` × capacity."""

    multiple: float
    offered_rps: float          # measured arrivals/s (not the nominal rate)
    elapsed_s: float
    n_submitted: int
    n_ok: int
    n_shed: int                 # typed ServiceOverloaded resolutions
    n_expired: int              # typed DeadlineExceeded resolutions
    n_failed: int               # anything else
    shed_by_lane: tuple[int, ...]       # shed + expired, per lane
    p50_admitted_ms: float
    p99_admitted_ms: float      # latency percentiles of SERVED requests

    @property
    def goodput_rps(self) -> float:
        return self.n_ok / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def shed_rate(self) -> float:
        total = self.n_submitted
        return (self.n_shed + self.n_expired) / total if total else 0.0


@dataclass(frozen=True)
class OverloadReport:
    """Capacity estimate + one :class:`OverloadPoint` per multiple."""

    capacity_rps: float
    points: tuple[OverloadPoint, ...]

    def point(self, multiple: float) -> OverloadPoint:
        for p in self.points:
            if p.multiple == multiple:
                return p
        raise KeyError(f"no sweep point at {multiple}x")


def overload_sweep(
    config: ServiceConfig,
    *,
    multiples: tuple[float, ...] = (0.5, 1.0, 2.0, 4.0),
    duration_s: float = 2.0,
    capacity_s: float = 1.5,
    sizes: tuple[int, ...] = (20, 27, 40, 56),
    seed: int = 0,
    dim: int = 8,
    lane_mix: tuple[tuple[int, float], ...] = OVERLOAD_LANE_MIX,
    device=None,
) -> OverloadReport:
    """Measure capacity closed-loop, then drive 0.5×–4× of it open-loop.

    Each multiple gets a *fresh warmed service* on ``config`` (one run's
    backlog must not pollute the next point's tail), Poisson arrivals
    with lanes drawn from ``lane_mix``, and per-request deadlines from
    ``config.default_deadline_ms``.  Futures are classified by their
    typed resolution — served / shed (:class:`ServiceOverloaded`) /
    expired (:class:`DeadlineExceeded`) / failed — and the served-side
    latency percentiles come from the service's own histogram, which
    only ever observes successful resolutions: ``p99_admitted_ms`` is
    p99-of-admitted by construction.
    """
    with ClusteringService(config, device=device) as probe:
        probe.warmup()
        capacity = run_closed_loop(
            probe, duration_s=capacity_s, sizes=sizes, seed=seed, dim=dim,
            concurrency=max(2 * config.max_batch, 8),
        )
    rng = np.random.default_rng(seed)
    pool = 32
    problems = [
        synthetic_problem(rng, int(rng.choice(sizes)), dim)
        for _ in range(pool)
    ]
    lanes_avail = np.array([lane for lane, _ in lane_mix])
    lane_p = np.array([frac for _, frac in lane_mix], dtype=float)
    lane_p /= lane_p.sum()
    points: list[OverloadPoint] = []
    for multiple in multiples:
        rate_hz = capacity * multiple
        with ClusteringService(config, device=device) as service:
            service.warmup()
            laned: list[tuple[int, Future]] = []
            t0 = time.perf_counter()
            deadline = t0 + duration_s
            t_next = t0
            while True:
                now = time.perf_counter()
                if now >= deadline:
                    break
                if now < t_next:
                    time.sleep(min(t_next - now, 0.002))
                    continue
                lane = int(rng.choice(lanes_avail, p=lane_p))
                laned.append((lane, service.submit(
                    problems[len(laned) % pool],
                    is_distance=True, priority=lane,
                )))
                t_next += rng.exponential(1.0 / rate_hz)
            service.flush(timeout=120.0)
            elapsed = time.perf_counter() - t0
            snap = service.metrics.snapshot(service.cache)
        n_ok = n_shed = n_expired = n_failed = 0
        shed_by_lane = [0] * config.n_lanes
        for lane, fut in laned:
            exc = fut.exception() if fut.done() else None
            if not fut.done() or exc is None:
                n_ok += 1
            elif isinstance(exc, ServiceOverloaded):
                n_shed += 1
                shed_by_lane[lane] += 1
            elif isinstance(exc, DeadlineExceeded):
                n_expired += 1
                shed_by_lane[lane] += 1
            else:
                n_failed += 1
        points.append(OverloadPoint(
            multiple=multiple,
            offered_rps=len(laned) / elapsed if elapsed else 0.0,
            elapsed_s=elapsed,
            n_submitted=len(laned),
            n_ok=n_ok,
            n_shed=n_shed,
            n_expired=n_expired,
            n_failed=n_failed,
            shed_by_lane=tuple(shed_by_lane),
            p50_admitted_ms=snap.p50_ms,
            p99_admitted_ms=snap.p99_ms,
        ))
    return OverloadReport(capacity_rps=capacity, points=tuple(points))


def print_overload_report(report: OverloadReport) -> None:
    print(f"capacity={report.capacity_rps:.0f} req/s (closed-loop probe)")
    print("  mult  offered   goodput  shed%   expired  p50ms  p99ms  "
          "shed_by_lane")
    for p in report.points:
        print(
            f"  {p.multiple:>4g}x {p.offered_rps:>7.0f} "
            f"{p.goodput_rps:>9.0f} {p.shed_rate:>6.1%} {p.n_expired:>8d} "
            f"{p.p50_admitted_ms:>6.2f} {p.p99_admitted_ms:>6.2f}  "
            f"{list(p.shed_by_lane)}"
        )


def overload_config(
    *,
    max_queue: int = 32,
    deadline_ms: float = 150.0,
    bucket_ns: tuple[int, ...] = (32, 64),
) -> ServiceConfig:
    """The §14 reference overload posture: shed-oldest, 3 lanes, small
    bounded queue, a deadline a few × the loaded p99.

    The *small* ``max_queue`` is what bounds p99-of-admitted under deep
    overload — an admitted request waits at most ``max_queue/capacity``
    — and the deadline is the belt-and-braces cap behind it.  Used by
    the CLI ``--overload`` mode and the CI-gated bench so both measure
    the same posture.
    """
    return ServiceConfig(
        method="complete",
        engine="serial",
        max_batch=8,
        max_delay_ms=2.0,
        bucket_ns=bucket_ns,
        max_queue=max_queue,
        overload_policy="shed-oldest",
        n_lanes=3,
        default_lane=2,
        default_deadline_ms=deadline_ms,
    )


def drive(
    config: ServiceConfig,
    *,
    rate_hz: float,
    duration_s: float,
    sizes: tuple[int, ...],
    seed: int = 0,
    warmup: bool = True,
    dim: int = 8,
    as_points: bool = False,
    tracer: Tracer | None = None,
    registry=None,
    metrics_out: str | None = None,
    metrics_period_s: float = 10.0,
    device=None,
) -> LoadReport:
    """Warm a fresh service on ``device``, run one timed open-loop load,
    close it.

    ``tracer`` (if given) records the span story of the whole run;
    ``registry`` (if given) receives the service metrics — pass one to
    read or export them after the service closes; ``metrics_out`` dumps
    the registry JSON every ``metrics_period_s`` seconds during the run
    and once more at exit.
    """
    with ClusteringService(config, tracer=tracer, registry=registry,
                           device=device) as service:
        if tracer is not None:
            tracer.name_thread("load-driver")
        dumper = (
            PeriodicDumper(service.registry, metrics_out, metrics_period_s)
            .start()
            if metrics_out is not None else None
        )
        try:
            warmup_compiles = service.warmup() if warmup else 0
            compiles_before = service.cache.stats.compiles
            jit_before = engine_jit_cache_size()
            futures, elapsed, _ = run_load(
                service,
                rate_hz=rate_hz,
                duration_s=duration_s,
                sizes=sizes,
                seed=seed,
                dim=dim,
                as_points=as_points,
            )
        finally:
            if dumper is not None:
                dumper.stop()       # dump-on-exit, even on a failed run
        # only inspect resolved futures — under saturation some are still
        # pending and a bare f.exception() would block the driver forever
        n_errors = sum(
            1 for f in futures if f.done() and f.exception() is not None
        )
        n_unresolved = sum(1 for f in futures if not f.done())
        return LoadReport(
            snapshot=service.metrics.snapshot(service.cache),
            elapsed_s=elapsed,
            n_submitted=len(futures),
            n_errors=n_errors,
            n_unresolved=n_unresolved,
            warmup_compiles=warmup_compiles,
            steady_compiles=service.cache.stats.compiles - compiles_before,
            steady_jit_growth=engine_jit_cache_size() - jit_before,
        )


def print_report(report: LoadReport) -> None:
    s = report.snapshot
    print(
        f"requests={report.n_submitted} errors={report.n_errors} "
        f"unresolved={report.n_unresolved} "
        f"batches={s.n_batches} elapsed={report.elapsed_s:.2f}s"
    )
    if report.n_unresolved:
        print(
            f"WARNING: {report.n_unresolved} requests had not resolved when "
            "the drain timed out — the offered rate exceeds service capacity"
        )
    print(
        f"throughput={report.throughput_rps:.1f} req/s  "
        f"p50={s.p50_ms:.2f} ms  p99={s.p99_ms:.2f} ms  "
        f"mean_batch={s.mean_batch_size:.2f}"
    )
    print(
        f"pad_waste={s.pad_waste:.1%}  cache_hit_rate={s.cache_hit_rate:.1%}  "
        f"warmup_compiles={report.warmup_compiles}  "
        f"steady_compiles={report.steady_compiles}  "
        f"steady_jit_growth={report.steady_jit_growth}"
    )


def main(argv: list[str] | None = None) -> "LoadReport | OverloadReport":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=200.0, help="arrivals/sec")
    ap.add_argument("--duration", type=float, default=3.0, help="seconds")
    ap.add_argument("--method", default="complete")
    ap.add_argument("--engine", default="serial", choices=("serial", "kernel"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--algorithm", default="auto",
                    choices=("auto", "lw", "nnchain"))
    ap.add_argument("--points", action="store_true",
                    help="submit (n, dim) point sets instead of matrices "
                         "(exercises the matrix-free nnchain buckets)")
    ap.add_argument("--dim", type=int, default=8,
                    help="embedding dim of the synthetic points")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--buckets", default="8,16,32",
                    help="declared bucket sizes, comma-separated")
    ap.add_argument("--sizes", default="5,8,12,20,27",
                    help="real problem sizes to draw, comma-separated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip warmup (shows the cold-start build cost)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record spans and write Chrome trace-event JSON "
                         "here (open in chrome://tracing or Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the metrics registry as JSON here "
                         "(periodic during the run + once at exit)")
    ap.add_argument("--metrics-period", type=float, default=10.0,
                    help="seconds between periodic metrics dumps")
    ap.add_argument("--prometheus", action="store_true",
                    help="print the Prometheus text exposition at exit")
    ap.add_argument("--overload", action="store_true",
                    help="run the §14 overload sweep (closed-loop capacity "
                         "probe, then open-loop at --multiples × capacity "
                         "with priority lanes + deadlines) and exit")
    ap.add_argument("--multiples", default="0.5,1,2,4",
                    help="capacity multiples for --overload")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.overload:
        report = overload_sweep(
            overload_config(),
            multiples=tuple(float(m) for m in args.multiples.split(",")),
            duration_s=args.duration,
            seed=args.seed,
            device=args.device,
        )
        print_overload_report(report)
        return report

    config = ServiceConfig(
        method=args.method,
        engine=args.engine,
        variant=args.variant,
        algorithm=args.algorithm,
        points_dim=args.dim if args.points else None,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        bucket_ns=tuple(int(b) for b in args.buckets.split(",")),
    )
    tracer = Tracer() if args.trace_out else None
    registry = None
    if args.metrics_out or args.prometheus:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry()
    report = drive(
        config,
        rate_hz=args.rate,
        duration_s=args.duration,
        sizes=tuple(int(s) for s in args.sizes.split(",")),
        seed=args.seed,
        warmup=not args.no_warmup,
        dim=args.dim,
        as_points=args.points,
        tracer=tracer,
        registry=registry,
        metrics_out=args.metrics_out,
        metrics_period_s=args.metrics_period,
        device=args.device,
    )
    print_report(report)
    if tracer is not None:
        n = tracer.write(args.trace_out)
        print(f"trace: {n} spans -> {args.trace_out}")
    if registry is not None and args.metrics_out:
        # final dump again, now with the driver-side report attached
        dump_json(registry, args.metrics_out, extra={
            "n_submitted": report.n_submitted,
            "n_errors": report.n_errors,
            "n_unresolved": report.n_unresolved,
            "elapsed_s": report.elapsed_s,
            "throughput_rps": report.throughput_rps,
            "warmup_compiles": report.warmup_compiles,
            "steady_compiles": report.steady_compiles,
            "steady_jit_growth": report.steady_jit_growth,
        })
        print(f"metrics: -> {args.metrics_out}")
    if registry is not None and args.prometheus:
        print(prometheus_text(registry))
    return report


if __name__ == "__main__":
    main()
