"""The port's overload-safe serving (``repro_torch.service``, on
``device="cpu"``): the cases of ``tests/test_service_robustness.py`` —
admission control, deadlines, tenant quotas, bounded retry, wedged-worker
recovery and the submit()/close() race — and a retry that reruns a bucket
program after its run touched the operand.

The contract under test: every decline is a *typed* exception resolved
on the future (never a raise, never a stranded future), an expired
request never reaches ``_run_bucket``, a quota breach punishes only the
offending tenant, and a wedged worker takes down exactly its bucket —
with the warmed :class:`CompileCache` surviving the restart, so
recovery builds no program and captures no graph.  Every wait is bounded
by its future's own timeout.
"""

import threading
import time
from concurrent.futures import wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.service import (  # noqa: E402
    AdmissionQueue,
    DeadlineExceeded,
    ServiceClosed,
    ServiceConfig,
    ServiceOverloaded,
    WorkerWedged,
    engine_jit_cache_size,
    is_transient,
)
from repro_torch.service import ClusteringService as _Service  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402


def ClusteringService(*args, **kw):
    """The service on the CPU (the port's default device is CUDA)."""
    return _Service(*args, device="cpu", **kw)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _FakeJob:
    """Just enough of ``_Job`` for AdmissionQueue unit tests."""

    def __init__(self, lane=0, tenant=None, deadline=None, tag=None):
        self.lane = lane
        self.tenant = tenant
        self.deadline = deadline
        self.tag = tag


def _mat(rng, n=8):
    return random_distance_matrix(rng, n).astype(np.float32)


# ---------------------------------------------------------------------------
# AdmissionQueue: policies, lane ordering, quotas, close atomicity
# ---------------------------------------------------------------------------


def test_queue_reject_policy_and_fifo_order():
    q = AdmissionQueue(max_queue=2, n_lanes=1, policy="reject")
    a, b, c = _FakeJob(tag="a"), _FakeJob(tag="b"), _FakeJob(tag="c")
    assert q.offer(a).admitted and q.offer(b).admitted
    d = q.offer(c)
    assert not d.admitted and d.rejected_reason == "queue-full"
    assert [q.take().tag, q.take().tag] == ["a", "b"]


def test_queue_take_drains_highest_lane_first():
    q = AdmissionQueue(max_queue=8, n_lanes=3, policy="reject")
    for lane, tag in [(2, "low"), (0, "hi"), (1, "mid"), (0, "hi2")]:
        assert q.offer(_FakeJob(lane=lane, tag=tag)).admitted
    assert [q.take().tag for _ in range(4)] == ["hi", "hi2", "mid", "low"]


def test_queue_shed_oldest_evicts_lowest_lane_first():
    q = AdmissionQueue(max_queue=3, n_lanes=3, policy="shed-oldest")
    old_low = _FakeJob(lane=2, tag="old_low")
    for j in (old_low, _FakeJob(lane=2, tag="low2"), _FakeJob(lane=1)):
        assert q.offer(j).admitted
    # a mid-lane newcomer evicts the OLDEST job of the LOWEST lane
    d = q.offer(_FakeJob(lane=1, tag="new"))
    assert d.admitted and [v.tag for v in d.victims] == ["old_low"]
    assert len(q) == 3


def test_queue_shed_oldest_newcomer_is_own_victim_when_outranked():
    q = AdmissionQueue(max_queue=2, n_lanes=3, policy="shed-oldest")
    assert q.offer(_FakeJob(lane=0)).admitted
    assert q.offer(_FakeJob(lane=0)).admitted
    # everything queued outranks the lane-2 newcomer: it is shed itself
    d = q.offer(_FakeJob(lane=2))
    assert not d.admitted and d.rejected_reason == "shed"
    assert not d.victims and len(q) == 2


def test_queue_quota_precedes_bound_for_every_policy():
    for policy in ("block", "reject", "shed-oldest"):
        q = AdmissionQueue(
            max_queue=10, n_lanes=1, policy=policy, tenant_quota=2
        )
        assert q.offer(_FakeJob(tenant="t")).admitted
        assert q.offer(_FakeJob(tenant="t")).admitted
        d = q.offer(_FakeJob(tenant="t"))
        # quota breach must not block or shed a neighbour — typed reject
        # even under 'block', and the queue is nowhere near max_queue
        assert not d.admitted and d.rejected_reason == "quota", policy
        assert q.offer(_FakeJob(tenant="other")).admitted
        assert q.tenant_depth("t") == 2


def test_queue_block_policy_honors_job_deadline():
    q = AdmissionQueue(max_queue=1, n_lanes=1, policy="block")
    assert q.offer(_FakeJob()).admitted
    t0 = time.perf_counter()
    d = q.offer(_FakeJob(deadline=t0 + 0.05))
    waited = time.perf_counter() - t0
    assert not d.admitted and d.rejected_reason == "deadline"
    assert 0.02 < waited < 2.0  # woke on the deadline, not a poll tick


def test_queue_block_policy_unblocks_on_take():
    q = AdmissionQueue(max_queue=1, n_lanes=1, policy="block")
    assert q.offer(_FakeJob(tag="first")).admitted
    out = []
    t = threading.Thread(
        target=lambda: out.append(q.offer(_FakeJob(tag="second")))
    )
    t.start()
    time.sleep(0.05)
    assert not out           # parked: queue is at the bound
    assert q.take().tag == "first"
    t.join(timeout=5)
    assert out and out[0].admitted
    assert q.take().tag == "second"


def test_queue_close_and_drain_sweeps_then_rejects():
    q = AdmissionQueue(max_queue=8, n_lanes=2, policy="block")
    jobs = [_FakeJob(lane=i % 2, tag=i) for i in range(5)]
    for j in jobs:
        q.offer(j)
    swept = q.close_and_drain()
    assert {j.tag for j in swept} == set(range(5))
    assert len(q) == 0 and q.closed
    d = q.offer(_FakeJob())
    assert not d.admitted and d.rejected_reason == "closed"
    assert q.take() is None  # closed and drained → dispatcher exits


# ---------------------------------------------------------------------------
# service: typed declines on the future, never a raise
# ---------------------------------------------------------------------------


def _small_cfg(**kw):
    kw.setdefault("bucket_ns", (8,))
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_delay_ms", 1.0)
    return ServiceConfig(**kw)


def _blocking_service(rng, **cfg_kw):
    """A service whose FIRST bucket parks on an event, jamming the
    dispatcher so the admission queue fills deterministically."""
    gate = threading.Event()
    hits = []

    def hook(sig):
        hits.append(sig)
        if len(hits) == 1:
            gate.wait(30.0)

    svc = ClusteringService(_small_cfg(**cfg_kw), execute_hook=hook)
    return svc, gate, hits


def test_queue_full_resolves_typed_overloaded(rng):
    svc, gate, _ = _blocking_service(
        rng, max_queue=2, overload_policy="reject"
    )
    try:
        blocker = svc.submit(_mat(rng))
        time.sleep(0.1)  # dispatcher now parked inside the first bucket
        queued = [svc.submit(_mat(rng)) for _ in range(2)]
        overflow = svc.submit(_mat(rng))
        exc = overflow.exception(timeout=5)
        assert isinstance(exc, ServiceOverloaded)
        assert exc.reason == "queue-full" and exc.lane == 1
        assert svc.metrics.n_shed == 1
        assert svc.metrics.shed_by_lane(1) == 1
        gate.set()
        assert blocker.result(timeout=30) is not None
        for f in queued:
            assert f.result(timeout=30) is not None
    finally:
        gate.set()
        svc.close()


def test_shed_oldest_service_path_victim_future_resolves(rng):
    svc, gate, _ = _blocking_service(
        rng, max_queue=1, overload_policy="shed-oldest", n_lanes=2,
        default_lane=1,
    )
    try:
        blocker = svc.submit(_mat(rng), priority=0)
        time.sleep(0.1)
        victim = svc.submit(_mat(rng), priority=1)   # fills the queue
        newcomer = svc.submit(_mat(rng), priority=0)  # evicts the victim
        exc = victim.exception(timeout=5)
        assert isinstance(exc, ServiceOverloaded) and exc.reason == "shed"
        gate.set()
        assert blocker.result(timeout=30) is not None
        assert newcomer.result(timeout=30) is not None
    finally:
        gate.set()
        svc.close()


def test_tenant_quota_isolates_neighbours(rng):
    svc, gate, _ = _blocking_service(
        rng, max_queue=64, overload_policy="block", tenant_quota=1
    )
    try:
        blocker = svc.submit(_mat(rng))
        time.sleep(0.1)
        ok_a = svc.submit(_mat(rng), tenant="a")
        over_a = svc.submit(_mat(rng), tenant="a")   # quota breach
        ok_b = svc.submit(_mat(rng), tenant="b")     # neighbour unaffected
        exc = over_a.exception(timeout=5)
        assert isinstance(exc, ServiceOverloaded)
        assert exc.reason == "quota" and exc.tenant == "a"
        gate.set()
        for f in (blocker, ok_a, ok_b):
            assert f.result(timeout=30) is not None
        assert svc.metrics.n_shed == 1
    finally:
        gate.set()
        svc.close()


def test_expired_job_never_reaches_run_bucket(rng):
    svc, gate, hits = _blocking_service(rng, max_queue=64)
    try:
        blocker = svc.submit(_mat(rng))
        time.sleep(0.1)
        # queued behind a bucket that outlives its 1 ms budget: reaped in
        # _dispatch, BEFORE padding a bucket or touching the engine
        doomed = svc.submit(_mat(rng), deadline_ms=1.0)
        time.sleep(0.05)
        gate.set()
        exc = doomed.exception(timeout=10)
        assert isinstance(exc, DeadlineExceeded)
        assert blocker.result(timeout=30) is not None
        svc.flush(timeout=30)
        assert len(hits) == 1, "expired job reached _run_bucket"
        assert svc.metrics.n_deadline_expired == 1
        # shed/expired are declines, not service failures
        assert svc.metrics.snapshot().n_failed == 0
    finally:
        gate.set()
        svc.close()


def test_submit_validates_lane_and_deadline_on_future(rng):
    with ClusteringService(_small_cfg()) as svc:
        bad_lane = svc.submit(_mat(rng), priority=7)
        assert isinstance(bad_lane.exception(timeout=5), ValueError)
        bad_dl = svc.submit(_mat(rng), deadline_ms=-1.0)
        assert isinstance(bad_dl.exception(timeout=5), ValueError)


# ---------------------------------------------------------------------------
# bounded retry + wedged-worker recovery
# ---------------------------------------------------------------------------


def test_transient_failures_retried_then_succeed(rng):
    boom = {"left": 2}

    def hook(sig):
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("transient engine failure (injected)")

    cfg = _small_cfg(max_retries=2, retry_backoff_ms=1.0)
    with ClusteringService(cfg, execute_hook=hook) as svc:
        res = svc.submit(_mat(rng)).result(timeout=60)
        assert res.merges.shape[1] == 4
        assert svc.metrics.n_retries == 2
        assert boom["left"] == 0


def test_retry_budget_exhausted_fails_typed(rng):
    def hook(sig):
        raise RuntimeError("permanently poisoned (injected)")

    cfg = _small_cfg(max_retries=1, retry_backoff_ms=1.0)
    with ClusteringService(cfg, execute_hook=hook) as svc:
        exc = svc.submit(_mat(rng)).exception(timeout=60)
        assert isinstance(exc, RuntimeError)
        assert "poisoned" in str(exc)
        assert svc.metrics.n_retries == 1  # attempts = max_retries + 1


def test_validation_errors_are_not_retried(rng):
    calls = []

    def hook(sig):
        calls.append(sig)
        raise ValueError("caller error (injected)")

    with ClusteringService(
        _small_cfg(max_retries=3), execute_hook=hook
    ) as svc:
        exc = svc.submit(_mat(rng)).exception(timeout=60)
        assert isinstance(exc, ValueError)
        assert len(calls) == 1 and svc.metrics.n_retries == 0
    assert not is_transient(ValueError()) and not is_transient(WorkerWedged())
    assert is_transient(RuntimeError())


def test_wedged_worker_fails_only_its_bucket_zero_recompiles(rng):
    wedge = {"armed": False}

    def hook(sig):
        if wedge["armed"]:
            wedge["armed"] = False
            time.sleep(2.0)  # blows way past the 200 ms hard deadline

    cfg = _small_cfg(hard_deadline_ms=200.0)
    m = _mat(rng)
    with ClusteringService(cfg, execute_hook=hook) as svc:
        svc.warmup()
        healthy = svc.submit(m).result(timeout=60)
        compiles0 = svc.cache.stats.compiles
        built0 = engine_jit_cache_size()
        gen0 = svc._watchdog.generation

        wedge["armed"] = True
        doomed = svc.submit(m)
        exc = doomed.exception(timeout=30)
        # the wedge fails exactly this bucket, typed, without retry
        # (WorkerWedged is a ServiceError → non-transient)
        assert isinstance(exc, WorkerWedged)
        assert svc.metrics.n_retries == 0
        assert svc.metrics.n_worker_restarts == 1
        assert svc._watchdog.generation == gen0 + 1

        # recovery: the replacement worker serves the same signature as
        # a cache HIT — zero builds across the restart; the abandoned
        # worker, waking later, queues on the program's lock
        recovered = svc.submit(m).result(timeout=60)
        np.testing.assert_array_equal(recovered.merges, healthy.merges)
        assert svc.cache.stats.compiles == compiles0
        assert engine_jit_cache_size() == built0
    # the abandoned generation-0 thread retires on its own; give it a
    # moment so it cannot leak into a later test's thread count
    time.sleep(0.1)


# ---------------------------------------------------------------------------
# submit()/close() race: no future is ever stranded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["reject", "shed-oldest"])
def test_submit_close_hammer_no_future_stranded(rng, policy):
    mats = [_mat(rng) for _ in range(8)]
    for round_ in range(4):
        cfg = _small_cfg(
            max_queue=4, overload_policy=policy, max_batch=4,
            max_delay_ms=0.5,
        )
        svc = ClusteringService(cfg)
        futures, stop = [], threading.Event()
        lock = threading.Lock()

        def pound():
            i = 0
            while not stop.is_set():
                f = svc.submit(mats[i % len(mats)])
                with lock:
                    futures.append(f)
                i += 1

        threads = [threading.Thread(target=pound) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.05 * (round_ + 1))
        svc.close()          # races live submitters on purpose
        stop.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()

        done, not_done = wait(futures, timeout=30)
        assert not not_done, (
            f"{len(not_done)} futures stranded unresolved (policy={policy})"
        )
        for f in done:
            exc = f.exception()
            if exc is not None:
                assert isinstance(
                    exc, (ServiceClosed, ServiceOverloaded)
                ), exc


def test_close_sweeps_queued_requests_typed(rng):
    svc, gate, _ = _blocking_service(rng, max_queue=64)
    blocker = svc.submit(_mat(rng))
    time.sleep(0.1)
    queued = [svc.submit(_mat(rng)) for _ in range(4)]
    gate.set()
    svc.close()
    assert blocker.result(timeout=5) is not None  # in-flight completed
    for f in queued:
        exc = f.exception(timeout=5)
        # swept by close_and_drain OR served if the dispatcher got to it
        # first — but never stranded, never an untyped error
        assert exc is None or isinstance(exc, ServiceClosed)
    late = svc.submit(_mat(rng))
    assert isinstance(late.exception(timeout=5), ServiceClosed)


def test_counters_exported_through_registry(rng):
    """The §14 counters must be visible in the shared MetricsRegistry
    dump (the CI observability artifact), not only on ServiceMetrics."""
    svc, gate, _ = _blocking_service(
        rng, max_queue=2, overload_policy="reject"
    )
    try:
        svc.submit(_mat(rng))
        time.sleep(0.1)
        svc.submit(_mat(rng))                        # queue slot 1
        svc.submit(_mat(rng), deadline_ms=1.0)       # slot 2: will expire
        svc.submit(_mat(rng)).exception(timeout=5)   # shed: queue-full
        time.sleep(0.05)                             # deadline passes queued
        gate.set()
        svc.flush(timeout=30)
        reg = svc.registry
        assert reg.counter("service_shed_total").total() >= 1
        assert reg.counter("service_deadline_expired_total").total() >= 1
        # wired but untriggered here: present at zero, not missing
        assert reg.counter("service_retries_total").total() == 0
        assert reg.counter("service_worker_restarts_total").total() == 0
        snap = svc.metrics.snapshot()
        assert snap.n_shed >= 1 and snap.n_deadline_expired >= 1
    finally:
        gate.set()
        svc.close()


# ---------------------------------------------------------------------------
# a retry reruns the same program and loads its operand again
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["serial", "kernel"])
def test_retry_after_a_run_reloads_the_program(rng, engine, monkeypatch):
    """A transient failure raised after the engine ran (the kernel engine
    updates the operand in place): the retry loads the bucket again into
    the same program, builds nothing, and its merges equal a healthy run's
    bit for bit."""
    from repro_torch.core import batched

    m = _mat(rng)
    cfg = _small_cfg(engine=engine, max_retries=1, retry_backoff_ms=1.0)
    with ClusteringService(cfg) as svc:
        svc.warmup()
        healthy = svc.submit(m).result(timeout=60)
        built0 = engine_jit_cache_size()
        run = batched.BucketProgram.execute
        failed = []

        def flaky(self, thr=None):
            out = run(self, thr)
            if not failed:
                failed.append(self)
                raise RuntimeError("transient failure after the run (injected)")
            return out

        monkeypatch.setattr(batched.BucketProgram, "execute", flaky)
        again = svc.submit(m).result(timeout=60)
        assert failed and svc.metrics.n_retries == 1
        np.testing.assert_array_equal(again.merges, healthy.merges)
        assert engine_jit_cache_size() == built0
