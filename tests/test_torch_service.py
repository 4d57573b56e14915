"""The port's clustering service (``repro_torch.service``) on the CPU.

Contract: the same requests through the JAX package's
``ClusteringService`` and the port's give the same merges (slots equal,
heights within rtol 1e-4 / atol 1e-5), on both engines, on matrices and
on points; the port's service equals the port's ``cluster_batch`` bit for
bit; after ``warmup()`` steady traffic builds no bucket program and
captures no graph (``CacheStats.compiles`` and ``engine_jit_cache_size``
flat) for plain, compacted and NN-chain buckets; one program run on
different buckets back to back equals a fresh ``cluster_batch`` each
time.  Also the program cache's LRU, ``warmup_signatures`` against the
reference's, validation, and the device rule (CUDA unless the caller names
the CPU).  The kernel engine runs its batch kernels' plain twins here.
"""

import dataclasses
import warnings
from concurrent.futures import wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.service as jservice  # noqa: E402
from repro.core import dendrogram as jdg  # noqa: E402
from repro.service import cache as jcache  # noqa: E402
from repro_torch.core import cluster, cluster_batch, cluster_batch_merges, engine  # noqa: E402
from repro_torch.core import dendrogram as dg  # noqa: E402
from repro_torch.core.batched import BucketProgram, bucket_signature  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.service import (  # noqa: E402
    ClusteringService,
    CompileCache,
    ServiceConfig,
    engine_jit_cache_size,
    warmup_signatures,
)
from tests.conftest import random_distance_matrix  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def kernel_floor(monkeypatch):
    """Lower the kernel plan's floor so that CPU-sized buckets stage."""
    def set_floor(floor):
        monkeypatch.setattr(engine, "KERNEL_MIN_STAGE", floor)
        monkeypatch.setattr(ops, "KERNEL_MIN_STAGE", floor)
    return set_floor


def service(cfg, **kw):
    return ClusteringService(cfg, device="cpu", **kw)


def ragged(rng, count, n_lo=3, n_hi=16, squared=False):
    return [random_distance_matrix(rng, int(rng.integers(n_lo, n_hi + 1)), squared=squared)
            .astype(np.float32) for _ in range(count)]


def resolve_all(futures, timeout=120.0):
    done, not_done = wait(futures, timeout=timeout)
    assert not not_done, f"{len(not_done)} requests never resolved"
    return [f.result() for f in futures]


def assert_close_merges(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-5)


def batch_reference(problems, cfg, **kw):
    """The port's ``cluster_batch_merges`` on the service's knobs."""
    merges, _ = cluster_batch_merges(
        problems, cfg.method, engine=cfg.engine, variant=cfg.variant,
        stop_at_k=cfg.stop_at_k, distance_threshold=cfg.distance_threshold,
        compaction=cfg.compaction, algorithm=cfg.algorithm, device="cpu", **kw)
    return merges


# ---------------------------------------------------------------------------
# against the JAX package's service
# ---------------------------------------------------------------------------

JAX_CASES = {
    "serial-matrix": dict(engine="serial", method="complete", bucket_ns=(8, 16)),
    "kernel-matrix": dict(engine="kernel", method="average", bucket_ns=(8,)),
    "serial-points": dict(engine="serial", method="ward", points_dim=4, bucket_ns=(8, 64)),
    "kernel-points": dict(engine="kernel", method="ward", bucket_ns=(8,)),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_service_matches_jax_service(case):
    """Both services on the same requests; the points case on the serial
    engine sends sets of 64 and more to the batched chain (canonical lists)
    and smaller ones to the LW loop."""
    kw = dict(JAX_CASES[case], max_batch=4, max_delay_ms=1.0)
    rng = np.random.default_rng(len(case))
    if kw.get("points_dim"):
        sizes = (5, 70, 8, 64, 3, 100) if kw["engine"] == "serial" else (5, 8, 3, 7)
        probs = [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]
    else:
        probs = ragged(rng, 6, n_hi=max(kw["bucket_ns"]), squared=kw["method"] == "ward")
    with jservice.ClusteringService(jservice.ServiceConfig(**kw)) as jsvc:
        want = resolve_all(jsvc.submit_many(probs))
    with service(ServiceConfig(**kw)) as svc:
        got = resolve_all(svc.submit_many(probs))
    for g, w in zip(got, want):
        assert (g.algorithm, g.backend, g.n, g.metric) == (w.algorithm, w.backend, w.n, w.metric)
        assert (g.distances is None) == (w.distances is None)
        assert_close_merges(g.merges, w.merges)


# ---------------------------------------------------------------------------
# against the port's own cluster_batch, bit for bit
# ---------------------------------------------------------------------------

KNOBS = {"none": {}, "stop_at_k": {"stop_at_k": 3}, "threshold": {"distance_threshold": 2.0}}


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("variant", ("baseline", "lazy"))
@pytest.mark.parametrize("engine_", ("serial", "kernel"))
def test_service_equals_cluster_batch(engine_, variant, knob, rng):
    cfg = ServiceConfig(method="average", engine=engine_, variant=variant, bucket_ns=(8, 16),
                        max_batch=3, max_delay_ms=0.5, **KNOBS[knob])
    probs = ragged(rng, 8, n_lo=2)
    with service(cfg) as svc:
        svc.warmup()
        got = resolve_all(svc.submit_many(probs))
    for g, m, p in zip(got, batch_reference(probs, cfg), probs):
        np.testing.assert_array_equal(g.merges, m)
        assert g.n == p.shape[0] and g.backend == engine_ and g.algorithm == "lw"


def test_service_accepts_points_and_metric(rng):
    with service(ServiceConfig(bucket_ns=(8,), max_delay_ms=0.5)) as svc:
        X = rng.normal(size=(7, 3)).astype(np.float32)
        res = svc.submit(X, metric="euclidean").result(timeout=120)
        want = cluster(X, "complete", metric="euclidean", algorithm="lw", backend="serial",
                       device="cpu")
        np.testing.assert_array_equal(res.merges, want.merges)
        assert res.points is not None and res.metric == "euclidean"
        assert res.distances.shape == (7, 7)


# ---------------------------------------------------------------------------
# the zero-build contract after warmup
# ---------------------------------------------------------------------------


def steady(svc, problems):
    """Serve ``problems`` on a warmed service; assert nothing was built."""
    compiles0, built0 = svc.cache.stats.compiles, engine_jit_cache_size()
    results = resolve_all(svc.submit_many(problems))
    assert svc.cache.stats.compiles == compiles0, "the program cache built"
    assert engine_jit_cache_size() == built0, "a program or graph was built past the cache"
    return results


@pytest.mark.parametrize("engine_", ("serial", "kernel"))
def test_zero_builds_steady_state(engine_, rng):
    cfg = ServiceConfig(engine=engine_, bucket_ns=(8, 16), max_batch=4, max_delay_ms=1.0)
    with service(cfg) as svc:
        assert svc.warmup() == 6            # 2 buckets × batch paddings {1, 2, 4}
        mats = ragged(rng, 30)
        for res, m in zip(steady(svc, mats), batch_reference(mats, cfg)):
            np.testing.assert_array_equal(res.merges, m)
        # an undeclared bucket (n > 16) is served, but pays a recorded build
        compiles0 = svc.cache.stats.compiles
        big = random_distance_matrix(rng, 20).astype(np.float32)
        res = svc.submit(big).result(timeout=120)
        assert svc.cache.stats.compiles == compiles0 + 1
        np.testing.assert_array_equal(res.merges, batch_reference([big], cfg)[0])


@pytest.mark.parametrize("engine_", ("serial", "kernel"))
def test_zero_builds_compacted_buckets(engine_, rng, kernel_floor):
    """Warmup covers the stage schedule: buckets past the first boundary
    resolve ``compaction="auto"`` to staged programs (the kernel plan at a
    floor of 16 here), and the first compacted request builds nothing."""
    kernel_floor(16)
    cfg = ServiceConfig(engine=engine_, bucket_ns=(64,), max_batch=2, max_delay_ms=1.0)
    with service(cfg) as svc:
        assert svc.warmup() == 2
        assert all(s.compaction for s in svc.cache.signatures())
        mats = [random_distance_matrix(rng, n).astype(np.float32) for n in (40, 64, 33)]
        for res, m in zip(steady(svc, mats), batch_reference(mats, cfg)):
            np.testing.assert_array_equal(res.merges, m)


def test_zero_builds_nnchain_buckets(rng):
    cfg = ServiceConfig(method="ward", points_dim=4, bucket_ns=(8, 64), max_batch=2,
                        max_delay_ms=1.0)
    with service(cfg) as svc:
        # dense LW: 2 buckets × {1, 2}; points: bucket 64 × {1, 2} on the
        # chain (bucket 8's points signature is the dense one)
        assert svc.warmup() == 6
        assert {s.algorithm for s in svc.cache.signatures()} == {"lw", "nnchain"}
        pts = [rng.normal(size=(n, 4)).astype(np.float32) for n in (50, 64, 6, 33)]
        results = steady(svc, pts)
    want = [r.merges for r in cluster_batch(pts, "ward", device="cpu")]
    for res, X, m in zip(results, pts, want):
        big = X.shape[0] > 8
        assert res.algorithm == ("nnchain" if big else "lw")
        assert (res.distances is None) == big
        np.testing.assert_array_equal(res.merges, m)
        lw = cluster(X, "ward", algorithm="lw", backend="serial", device="cpu")
        assert dg.merges_equivalent(res.merges, lw.merges, n=X.shape[0])


def test_mixed_lw_nnchain_traffic_no_collisions(rng):
    """LW and chain buckets out of one window dispatch through distinct
    signatures, and every request still matches its reference."""
    cfg = ServiceConfig(method="ward", points_dim=3, bucket_ns=(8, 64), max_batch=8,
                        max_delay_ms=50.0)
    with service(cfg) as svc:
        svc.warmup()
        X_big = rng.normal(size=(64, 3)).astype(np.float32)
        X_small = rng.normal(size=(6, 3)).astype(np.float32)
        mat = random_distance_matrix(rng, 7, squared=True).astype(np.float32)
        res_big, res_small, res_mat = resolve_all(
            [svc.submit(X_big), svc.submit(X_small), svc.submit(mat, is_distance=True)])
        assert svc.metrics.snapshot(svc.cache).n_batches == 2
        sigs = svc.cache.signatures()
        assert len(set(sigs)) == len(sigs)
    assert res_big.algorithm == "nnchain"
    assert dg.merges_equivalent(
        res_big.merges, cluster(X_big, "ward", algorithm="lw", backend="serial",
                                device="cpu").merges, n=64)
    assert res_small.algorithm == res_mat.algorithm == "lw"
    np.testing.assert_array_equal(
        res_mat.merges, cluster(mat, "ward", algorithm="lw", backend="serial",
                                is_distance=True, device="cpu").merges)


# ---------------------------------------------------------------------------
# one program, many buckets: the reset is the whole difference
# ---------------------------------------------------------------------------

PROGRAM_CASES = {
    "serial": dict(engine="serial", variant="baseline"),
    "kernel": dict(engine="kernel", variant="baseline"),
    "kernel-lazy": dict(engine="kernel", variant="lazy"),
    "kernel-threshold": dict(engine="kernel", variant="rowmin", threshold=True),
    "chain-dense": dict(engine="serial", algorithm="nnchain"),
    "chain-points": dict(engine="serial", algorithm="nnchain", points_dim=5),
}


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_program_runs_equal_fresh_cluster_batch(case, kernel_floor):
    """Bucket A, bucket B, bucket A again through one program (bucket 64,
    four lanes, staged on the kernel engine at a floor of 16): each run's
    merges equal a fresh ``cluster_batch`` of the same problems bit for
    bit."""
    kernel_floor(16)
    kw = dict(PROGRAM_CASES[case])
    threshold = kw.pop("threshold", False)
    pdim = kw.pop("points_dim", 0)
    method = "ward"
    sig = bucket_signature(64, 4, method=method, with_threshold=threshold, points_dim=pdim,
                           **kw)
    prog = BucketProgram(sig, "cpu", eager=True)
    rng = np.random.default_rng(len(case))
    if pdim:
        A, B = ([rng.normal(size=(n, pdim)).astype(np.float32) for n in ns]
                for ns in ((64, 40, 33, 50), (50, 64)))
    else:
        A, B = ([random_distance_matrix(rng, n, squared=True).astype(np.float32) for n in ns]
                for ns in ((64, 40, 2, 50), (50, 64, 37)))
    thr = 8.0 if threshold else None
    for probs in (A, B, A):
        merges, n_merges = prog.run(probs, thr)
        merges, n_merges = merges.numpy(), n_merges.numpy()
        want, _ = cluster_batch_merges(
            [None] * len(probs) if pdim else probs, method,
            points=probs if pdim else None, distance_threshold=thr, device="cpu", **kw)
        for b, (p, w) in enumerate(zip(probs, want)):
            k = p.shape[0]
            if sig.algorithm == "nnchain":
                got = dg.canonical_order(merges[b, : k - 1], n=k)
            else:
                got = merges[b, : min(k - 1, int(n_merges[b]))]
            np.testing.assert_array_equal(got, w)


def test_one_shot_program_builds_a_stage_when_reached(kernel_floor):
    """A one-shot kernel program (``cluster_batch``'s) holds no stage past
    the first that its runs have not reached: a threshold run that stops in
    stage 0 keeps fewer bytes than a cached (eager) program, with the same
    merges; a full run builds every stage."""
    kernel_floor(16)
    sig = bucket_signature(64, 4, method="ward", engine="kernel", with_threshold=True)
    assert sig.compaction
    rng = np.random.default_rng(3)
    probs = [random_distance_matrix(rng, n, squared=True).astype(np.float32)
             for n in (64, 40, 2, 50)]
    eager, lazy = BucketProgram(sig, "cpu", eager=True), BucketProgram(sig, "cpu")
    assert lazy.nbytes < eager.nbytes
    want, want_n = (t.numpy() for t in eager.run(probs, 1.0))
    got, got_n = (t.numpy() for t in lazy.run(probs, 1.0))
    assert 0 < int(want_n.max()) <= 32                  # stops in stage 0 (64 → 32)
    np.testing.assert_array_equal(got_n, want_n)
    for b, k in enumerate(want_n):
        np.testing.assert_array_equal(got[b, :k], want[b, :k])
    assert lazy.nbytes < eager.nbytes
    lazy.run(probs, None)
    assert lazy.nbytes == eager.nbytes


def test_service_points_on_a_dense_bucket_equal_cluster_batch(rng):
    """Points that ride a dense LW bucket get their matrix on the
    service's device, on the worker: merges bit for bit ``cluster_batch``'s
    of the same points, the result keeping that matrix; a request whose
    points the metric cannot embed fails at submit, alone."""
    pts = [rng.normal(size=(int(n), 3)).astype(np.float32) for n in (5, 9, 20, 31, 7, 12)]
    cfg = ServiceConfig(method="ward", algorithm="lw", bucket_ns=(8, 16, 32), max_batch=4,
                        max_delay_ms=1.0)
    with service(cfg) as svc:
        bad = svc.submit(rng.normal(size=(6, 2, 3)), metric="sqeuclidean")
        got = resolve_all(svc.submit_many(pts, metric="sqeuclidean"))
        with pytest.raises(ValueError, match="expected \\(n, d\\) points"):
            bad.result(timeout=60)
    want = cluster_batch(pts, "ward", metric="sqeuclidean", algorithm="lw", device="cpu",
                         keep_inputs=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.merges, w.merges)
        assert isinstance(g.distances, torch.Tensor) and g.distances.shape == (g.n, g.n)
        np.testing.assert_array_equal(g.distances.numpy(), w.distances.numpy())


# ---------------------------------------------------------------------------
# the program cache
# ---------------------------------------------------------------------------


def test_compile_cache_lru_eviction():
    cache = CompileCache(capacity=2, device="cpu")
    sigs = [bucket_signature(8, 1, method=m, engine="serial")
            for m in ("single", "complete", "average")]
    cache.get(sigs[0])
    cache.get(sigs[1])
    first = cache.get(sigs[0])              # refresh: sigs[1] is now LRU
    cache.get(sigs[2])                      # evicts sigs[1]
    assert cache.stats.evictions == 1
    assert sigs[1] not in cache and sigs[0] in cache and sigs[2] in cache
    assert cache.get(sigs[0]) is first
    compiles = cache.stats.compiles
    built = engine_jit_cache_size()
    cache.get(sigs[1])                      # re-entry rebuilds
    assert cache.stats.compiles == compiles + 1
    assert engine_jit_cache_size() == built + 1
    assert cache.stats.hits == 2 and cache.stats.misses == 4
    assert len(cache) == 2 and cache.signatures() == [sigs[0], sigs[1]]


def test_cache_rejects_distributed_engine():
    cache = CompileCache(device="cpu")
    with pytest.raises(ValueError, match="distributed"):
        cache.get(bucket_signature(8, 1, method="complete", engine="distributed"))


WARMUP_GRID = [
    dict(engine=e, variant=v, compaction=c, max_batch=mb)
    for e in ("serial", "kernel") for v in ("baseline", "lazy") for c in ("auto", False)
    for mb in (1, 5)
] + [dict(method="ward", points_dim=16, algorithm="auto", max_batch=8),
     dict(method="ward", algorithm="nnchain", max_batch=2),
     dict(stop_at_k=300, with_threshold=True, max_batch=3)]


@pytest.mark.parametrize("knobs", WARMUP_GRID, ids=str)
def test_warmup_signatures_match_reference(knobs):
    """Field by field the JAX package's list, except the kernel engine's
    compaction at bucket 256 (the port's kernel plan does not stage it)."""
    knobs = {"method": "complete", **knobs}
    buckets = (8, 64, 256, 512, 1024)
    got = warmup_signatures(buckets, **knobs)
    want = jcache.warmup_signatures(buckets, **knobs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        if g.engine == "kernel" and g.bucket_n == 256 and g.algorithm == "lw":
            assert not gd.pop("compaction")
            wd.pop("compaction")
        assert gd == wd
    with pytest.raises(ValueError, match="bucket grid"):
        warmup_signatures((10,), method="complete")


# ---------------------------------------------------------------------------
# validation, the device rule, error paths
# ---------------------------------------------------------------------------


def test_service_config_validation():
    with pytest.raises(ValueError, match="bucket grid"):
        ServiceConfig(bucket_ns=(7,))
    with pytest.raises(NotImplementedError, match="A7"):
        ServiceConfig(engine="distributed")
    with pytest.raises(ValueError, match="engine"):
        ServiceConfig(engine="pallas")
    with pytest.raises(ValueError, match="method"):
        ServiceConfig(method="nope")
    with pytest.raises(ValueError, match="working set"):
        ServiceConfig(bucket_ns=(8, 16, 32, 64), max_batch=8, cache_capacity=10)
    with pytest.raises(ValueError, match="reducible"):
        ServiceConfig(method="centroid", algorithm="nnchain")
    with pytest.raises(ValueError, match="serial"):
        ServiceConfig(engine="kernel", algorithm="nnchain")
    with pytest.raises(ValueError, match="algorithm"):
        ServiceConfig(algorithm="fastest")
    with pytest.raises(ValueError, match="points_dim"):
        ServiceConfig(points_dim=0)
    with pytest.raises(ValueError, match="reducible"):
        ServiceConfig(method="centroid", algorithm="landmark")
    with pytest.raises(ValueError, match="supervised worker"):
        ServiceConfig(method="ward", engine="kernel", algorithm="landmark")
    with pytest.raises(ValueError, match="landmark lane"):
        ServiceConfig(method="ward", n_landmarks=32)
    ServiceConfig(engine="kernel", algorithm="auto")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the rule without a card")
def test_service_runs_on_cuda_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusteringService(ServiceConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        CompileCache()
    cache = CompileCache(device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        ClusteringService(ServiceConfig(), cache=cache, device="meta")


def test_submit_error_paths(rng):
    with service(ServiceConfig(bucket_ns=(8,))) as svc:
        with pytest.raises(ValueError, match="at least 2"):
            svc.submit(np.zeros((1, 1), np.float32)).result(timeout=10)
        with pytest.raises(ValueError, match="bucket"):
            svc.submit(np.zeros((5000, 5000), np.float32)).result(timeout=10)
        assert svc.metrics.snapshot(svc.cache).n_failed == 2
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(random_distance_matrix(rng, 5)).result(timeout=10)


def test_metrics_accounting(rng):
    cfg = ServiceConfig(bucket_ns=(8,), max_batch=4, max_delay_ms=20.0)
    with service(cfg) as svc:
        svc.warmup()
        resolve_all(svc.submit_many(ragged(rng, 4, n_lo=5, n_hi=8)))
        snap = svc.metrics.snapshot(svc.cache)
        assert snap.n_requests == 4 and snap.n_batches >= 1
        assert snap.p50_ms > 0 and snap.p99_ms >= snap.p50_ms
        assert 0.0 <= snap.pad_waste < 1.0
        assert snap.cache_hit_rate is not None


def test_cancelled_future_does_not_kill_dispatcher(rng):
    cfg = ServiceConfig(bucket_ns=(8,), max_batch=4, max_delay_ms=50.0)
    with service(cfg) as svc:
        svc.warmup()
        mats = ragged(rng, 3, n_lo=5, n_hi=8)
        futs = svc.submit_many(mats)
        futs[1].cancel()
        assert svc.flush(timeout=60)
        want = batch_reference(mats, cfg)
        for i in (0, 2):
            if not futs[i].cancelled():
                np.testing.assert_array_equal(futs[i].result(timeout=10).merges, want[i])
        m = random_distance_matrix(rng, 6).astype(np.float32)
        np.testing.assert_array_equal(svc.submit(m).result(timeout=60).merges,
                                      batch_reference([m], cfg)[0])


def test_service_landmark_lane():
    """The landmark lane: one ``landmark_cluster`` call a request on the
    service's device, equal to the direct call; the JAX package's lane on
    the same points gives the same merges."""
    from repro.data.synthetic import gaussian_mixture
    from repro_torch.core.landmark import landmark_cluster

    pts = gaussian_mixture(seed=11, n=300, dim=8)[0].astype(np.float32)
    cfg = ServiceConfig(method="ward", algorithm="landmark", landmark_seed=0)
    with service(cfg) as svc:
        assert svc.warmup() == 0
        res = svc.submit(pts, metric="sqeuclidean").result(timeout=120)
    assert res.algorithm == "landmark" and res.distances is None
    direct = landmark_cluster(pts, "ward", metric="sqeuclidean", seed=0, device="cpu")
    np.testing.assert_array_equal(res.merges, direct.merges)
    with jservice.ClusteringService(jservice.ServiceConfig(**dataclasses.asdict(cfg))) as jsvc:
        want = jsvc.submit(pts, metric="sqeuclidean").result(timeout=120)
    assert jdg.merges_equivalent(res.merges, np.asarray(want.merges), n=300)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with service(cfg) as svc:
            with pytest.raises(ValueError, match="landmark"):
                svc.submit(np.zeros((8, 8), np.float32)).result(timeout=30)
