"""The port's observability layer (``repro_torch.obs``): the registry,
the tracer and the exporters (the framework-free cases of
``tests/test_obs.py``, run against the port's copies), and the service's
spans and metrics on ``device="cpu"``.

The service tests re-prove the zero-build contract with tracing ON:
instrumentation that silently perturbed the programs would invalidate
every number the layer reports.  Left out until their modules are
ported: the compile span's HLO cost (the JAX package reads it from XLA's
HLO; the port's analytic roofline is ROADMAP.md A8), the sharded chain's
telemetry (A7) and the benchmark regression gate (A8).
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import (  # noqa: E402
    MetricsRegistry,
    PeriodicDumper,
    Tracer,
    dump_json,
    prometheus_text,
    registry_json,
    spans_by_name,
)
from tests.conftest import random_distance_matrix  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- registry


def test_counter_labels_and_totals():
    reg = MetricsRegistry()
    c = reg.counter("events", "test events")
    c.inc(event="hit")
    c.inc(2, event="miss")
    c.inc()                                 # unlabeled series
    assert c.value(event="hit") == 1
    assert c.value(event="miss") == 2
    assert c.value() == 1
    assert c.total() == 4
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)


def test_registry_idempotent_and_kind_collision():
    reg = MetricsRegistry()
    a = reg.counter("x", "first")
    b = reg.counter("x", "second declaration ignored")
    assert a is b and a.help == "first"
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")
    assert reg.get("x") is a
    assert reg.get("missing") is None


def test_gauge_set_add():
    reg = MetricsRegistry()
    g = reg.gauge("depth")
    g.set(5)
    g.add(-2)
    assert g.value() == 3
    g.set(1, queue="b")
    assert g.value(queue="b") == 1 and g.value() == 3


def test_histogram_window_is_bounded_and_lifetime_counts_are_not():
    reg = MetricsRegistry()
    h = reg.histogram("lat", window=16)
    for i in range(100):
        h.observe(float(i))
    assert h.count() == 100
    assert h.sum() == sum(range(100))
    win = h.window()
    assert len(win) == 16 and win == [float(i) for i in range(84, 100)]
    # percentiles read the window only, matching numpy on the same data
    assert h.percentile(50) == pytest.approx(np.percentile(win, 50))
    assert h.percentile(99) == pytest.approx(np.percentile(win, 99))
    assert h.percentile(0) == 84.0 and h.percentile(100) == 99.0
    with pytest.raises(ValueError):
        h.percentile(101)


def test_counter_concurrency_exact_totals():
    reg = MetricsRegistry()
    c = reg.counter("hammer")
    h = reg.histogram("hammer_hist", window=64)
    n_threads, per_thread = 8, 2000

    def work(k):
        for i in range(per_thread):
            c.inc(thread=str(k))
            h.observe(float(i))

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.total() == n_threads * per_thread
    for k in range(n_threads):
        assert c.value(thread=str(k)) == per_thread
    assert h.count() == n_threads * per_thread
    assert len(h.window()) == 64


def test_snapshot_never_throws_under_concurrent_writes():
    reg = MetricsRegistry()
    c = reg.counter("c")
    h = reg.histogram("h", window=32)
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            c.inc(lane=str(i % 5))
            h.observe(float(i % 97))
            i += 1

    def reader():
        try:
            while not stop.is_set():
                snap = reg.snapshot()
                json.dumps(snap)            # must always be serializable
                prometheus_text(reg)
        except Exception as e:  # noqa: BLE001 — the test asserts on this
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    stop_timer = threading.Timer(0.5, stop.set)
    stop_timer.start()
    for t in threads:
        t.join()
    stop_timer.cancel()
    assert not errors, errors


# ------------------------------------------------------------ exporters


def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("reqs_total", "requests").inc(3, kind="ok")
    reg.gauge("depth", "queue depth").set(7)
    h = reg.histogram("lat_ms", "latency")
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    text = prometheus_text(reg)
    assert "# TYPE reqs_total counter" in text
    assert 'reqs_total{kind="ok"} 3.0' in text
    assert "reqs_total_total" not in text   # no doubled suffix
    assert "# TYPE depth gauge" in text and "depth 7.0" in text
    assert 'lat_ms{quantile="0.5"} 2.0' in text
    assert "lat_ms_count 3" in text and "lat_ms_sum 6.0" in text


def test_json_dump_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc(5)
    path = str(tmp_path / "m.json")
    dump_json(reg, path, extra={"run": "test"})
    doc = json.load(open(path))
    assert doc["metrics"]["c"]["series"][""] == 5.0
    assert doc["extra"]["run"] == "test"
    assert doc["uptime_s"] >= 0
    assert registry_json(reg)["metrics"]["c"]["kind"] == "counter"


def test_periodic_dumper_dumps_on_exit(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc()
    path = str(tmp_path / "m.json")
    with PeriodicDumper(reg, path, period_s=60.0) as d:
        pass                                # period never elapses...
    assert d.n_dumps >= 1                   # ...but exit always dumps
    assert json.load(open(path))["metrics"]["c"]["series"][""] == 1.0


# --------------------------------------------------------------- tracer


def test_tracer_spans_nest_and_export_is_valid_chrome_trace(tmp_path):
    tr = Tracer()
    tr.name_thread("test-main")
    with tr.span("outer", request="r1"):
        with tr.span("inner", cat="engine"):
            pass
    tr.add_span("measured", 0.0, 0.001, trace_id=7)

    @tr.trace(name="decorated", cat="engine")
    def decorated():
        return 42

    assert decorated() == 42
    events = tr.events()
    outer = spans_by_name(events, "outer")[0]
    inner = spans_by_name(events, "inner")[0]
    # nesting by time containment on the same tid
    assert outer.tid == inner.tid
    assert outer.ts_us <= inner.ts_us
    assert outer.ts_us + outer.dur_us >= inner.ts_us + inner.dur_us
    assert spans_by_name(events, "decorated")[0].dur_us >= 0

    path = str(tmp_path / "t.trace.json")
    n = tr.write(path)
    doc = json.load(open(path))             # well-formed JSON
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert n == len(xs) == 4
    for e in xs:                            # chrome trace-event schema
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid",
                "args"} <= e.keys()
    metas = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    assert any(m["args"]["name"] == "test-main" for m in metas)
    assert spans_by_name(tr.events(), "measured")[0].args["trace_id"] == 7


def test_disabled_tracer_records_nothing_but_ids_flow():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    tr.add_span("y", 0.0, 1.0)
    assert tr.events() == []
    assert tr.new_trace_id() != tr.new_trace_id()


def test_tracer_window_is_bounded():
    tr = Tracer(max_events=8)
    for i in range(100):
        tr.add_span(f"s{i}", 0.0, 1.0)
    events = tr.events()
    assert len(events) == 8
    assert events[0].name == "s92" and events[-1].name == "s99"


# -------------------------------------------------- service integration


def _small_service_config():
    from repro_torch.service.batcher import ServiceConfig
    return ServiceConfig(method="complete", max_batch=4, max_delay_ms=1.0,
                         bucket_ns=(8, 16))


def _service(**kw):
    from repro_torch.service.batcher import ClusteringService
    return ClusteringService(_small_service_config(), device="cpu", **kw)


def test_service_trace_covers_every_request_and_stays_build_free(rng):
    from repro_torch.service import engine_jit_cache_size

    tracer = Tracer()
    with _service(tracer=tracer) as svc:
        warmed = svc.warmup()
        built = engine_jit_cache_size()
        problems = [random_distance_matrix(rng, n) for n in (5, 8, 11, 16, 7)]
        futures = svc.submit_many(problems, is_distance=True)
        for fut in futures:
            assert fut.result(timeout=120).merges is not None
        assert svc.cache.stats.compiles == warmed   # zero steady builds
        assert engine_jit_cache_size() == built

        events = tracer.events()
        submit_ids = {e.args["trace_id"]
                      for e in spans_by_name(events, "submit")}
        resolve_ids = {e.args["trace_id"]
                       for e in spans_by_name(events, "resolve")}
        bucket_ids = {tid for e in spans_by_name(events, "bucket")
                      for tid in e.args["trace_ids"]}
        assert len(submit_ids) == len(problems)
        assert submit_ids == resolve_ids == bucket_ids
        n_buckets = len(spans_by_name(events, "bucket"))
        for kind in ("pack", "cache", "execute"):
            assert len(spans_by_name(events, kind)) == n_buckets, kind
        # warmed traffic: every dispatch-time cache span is a hit
        assert all(e.args["hit"] for e in spans_by_name(events, "cache"))
        # warmup's builds are compile spans, one a program
        assert len(spans_by_name(events, "compile")) == warmed


def test_compile_span_carries_the_program(rng):
    """An unwarmed request builds its program once, on the worker: one
    ``compile`` span with the build time and the program's device bytes.
    The cost profile waits for the port's roofline (ROADMAP.md A8)."""
    tracer = Tracer()
    with _service(tracer=tracer) as svc:
        fut = svc.submit(random_distance_matrix(rng, 6), is_distance=True)
        fut.result(timeout=120)
        compiles = spans_by_name(tracer.events(), "compile")
        assert len(compiles) == 1
        args = compiles[0].args
        assert args["compile_s"] > 0
        (prog,) = svc.cache.programs()
        assert args["program_bytes"] == prog.nbytes > 0
        assert args["signature"].startswith("lw/complete/serial/n8/B1")
        assert svc.cache.cost_profiles == {}


def test_service_metrics_snapshot_timebase(rng):
    with _service() as svc:
        svc.warmup()
        for fut in svc.submit_many(
            [random_distance_matrix(rng, 8) for _ in range(6)],
            is_distance=True,
        ):
            fut.result(timeout=120)
        snap = svc.metrics.snapshot(svc.cache)
    assert snap.n_requests == 6
    assert snap.started_at > 0 and snap.uptime_s > 0
    assert snap.throughput_rps == pytest.approx(
        snap.n_requests / snap.uptime_s, rel=0.2)
    # trailing fields default — pre-timebase constructions stay valid
    from repro_torch.service.batcher import MetricsSnapshot
    old = MetricsSnapshot(1, 1, 0, 0.0, 0.0, 1.0, 0.0, None)
    assert old.throughput_rps == 0.0


def test_two_services_do_not_share_a_registry(rng):
    with _service() as a, _service() as b:
        a.submit(random_distance_matrix(rng, 8),
                 is_distance=True).result(timeout=120)
        assert a.metrics.n_requests == 1
        assert b.metrics.n_requests == 0
        assert a.registry is not b.registry


def test_registry_exports_the_service_instruments(rng):
    """The cache's and the dispatcher's instruments reach the exporters
    under the reference's metric names."""
    with _service() as svc:
        svc.warmup()
        svc.submit(random_distance_matrix(rng, 8), is_distance=True).result(timeout=120)
        text = prometheus_text(svc.registry)
        doc = registry_json(svc.registry)
    for name in ("service_cache_events_total", "service_cache_entries",
                 "service_compile_seconds", "service_requests_total",
                 "service_request_latency_ms", "service_batches_total"):
        assert name in doc["metrics"], name
        assert f"# TYPE {name}" in text, name
    assert 'service_cache_events_total{event="compile"} 6.0' in text


def test_fault_counters_land_on_the_global_registry():
    from repro_torch.distributed.fault import FailurePlan, RetryPolicy, SimulatedFailure, retry_call
    from repro_torch.obs import get_registry

    reg = get_registry()
    before = reg.counter("fault_retries_total").total()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("injected")
        return "ok"

    assert retry_call(flaky, RetryPolicy(attempts=3, base_delay_s=0.0)) == "ok"
    assert reg.counter("fault_retries_total").total() == before + 2
    plan = FailurePlan(fail_at=(2,))
    plan.check(1)
    with pytest.raises(SimulatedFailure):
        plan.check(2)
    plan.check(2)                      # fires once, as a replaced node would
