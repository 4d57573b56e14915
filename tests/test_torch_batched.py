"""Batching in the port vs the JAX package: the bucket grid and signatures,
packing, the scheduler, ``cluster_batch`` on the serial and kernel
backends, and the batched NN chains.

Contract: every lane of a batched LW run equals the port's own
single-problem ``cluster(..., algorithm="lw")`` on the same backend bit
for bit (slots, heights, sizes), for every method, variant, early-stop
knob and compaction setting; against the JAX package's ``cluster_batch``
the slots are equal and the heights within rtol 1e-4 / atol 1e-5 (its
kernel batch runs in interpret mode).  The kernel backend runs on the CPU
through its batch kernels' plain twins.  The batched chains' lists match
the reference's after ``canonical_order``.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import batched as jbatched  # noqa: E402
from repro.core import dendrogram as jdg  # noqa: E402
from repro.core import nnchain as jnnchain  # noqa: E402
from repro_torch.core import (  # noqa: E402
    METHODS,
    VARIANTS,
    batched,
    cluster,
    cluster_batch,
    cluster_batch_merges,
    engine,
    nnchain,
)
from repro_torch.core.dendrogram import canonical_order, validate_merges  # noqa: E402
from repro_torch.core.naive import naive_lw  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402

RAGGED_NS = (5, 8, 13, 16, 3, 30)       # crosses the 8/16/32 buckets
STAGED_NS = (40, 64, 17, 50, 2, 33)     # bucket 64: serial 64 → 32, kernel (floor 16) → 16
GEOMETRIC = ("centroid", "median", "ward")
BACKENDS = ("serial", "kernel")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the lockstep loops run many small ops, and
    parallel test workers that each start a thread pool oversubscribe the
    cores."""
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


def mats(method, ns, seed=0):
    rng = np.random.default_rng([seed, METHODS.index(method)])
    return [random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)
            for n in ns]


def single(m, method, backend, **knobs):
    return cluster(m, method, algorithm="lw", backend=backend, device="cpu", **knobs).merges


def assert_close_merges(got, want):
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_cluster_batch_matches_reference(backend, method):
    """Same numpy inputs through both packages' ``cluster_batch``: slots
    equal, heights within tolerance, the same stats."""
    probs = mats(method, RAGGED_NS)
    got = cluster_batch(probs, method, backend=backend, device="cpu")
    want = jcore.cluster_batch(probs, method, backend=backend)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.algorithm, g.backend, g.n) == (w.algorithm, w.backend, w.n)
        assert_close_merges(g.merges, np.asarray(w.merges))
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def test_reference_batch_rounding_case(rng):
    """The reference's own batch-vs-loop case that fails on centroid
    (``tests/test_batched.py``): the JAX batch records merge 4 of the n =
    16 problem an ulp below its loop.  The port's batch equals its own loop
    bit for bit, and both packages' slots and the float64 naive oracle's
    agree, heights within tolerance."""
    probs = [random_distance_matrix(rng, n, squared=True) for n in RAGGED_NS]
    got = cluster_batch(probs, "centroid", backend="serial", device="cpu")
    want = jcore.cluster_batch(probs, "centroid", backend="serial")
    for p, g, w in zip(probs, got, want):
        np.testing.assert_array_equal(g.merges, single(p, "centroid", "serial"))
        assert_close_merges(g.merges, np.asarray(w.merges))
        assert_close_merges(g.merges, naive_lw(p, "centroid").astype(np.float32))


# ---------------------------------------------------------------------------
# each lane against the port's own single-problem run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_lanes_match_single_problem(backend, method):
    probs = mats(method, RAGGED_NS, seed=1)
    for p, r in zip(probs, cluster_batch(probs, method, backend=backend, device="cpu")):
        np.testing.assert_array_equal(r.merges, single(p, method, backend))
        validate_merges(r.merges)


KNOBS = {"none": {}, "stop_at_k": {"stop_at_k": 3}, "threshold": "median"}


@pytest.mark.parametrize("compaction", (True, False))
@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_knob_grid_matches_single_problem(backend, variant, knob, compaction, kernel_floor):
    """Every variant under each early-stop knob, staged (the buckets of 64
    stage on both backends) and unstaged: each lane equals its
    single-problem run with the same knobs bit for bit."""
    kernel_floor(16)
    method = "ward" if variant == "lazy" else "complete"
    probs = mats(method, STAGED_NS, seed=2)
    knobs = KNOBS[knob]
    if knobs == "median":   # a stop inside the full lane's second stage (merges 32-63)
        knobs = {"distance_threshold": float(np.sort(single(probs[1], method, "serial")[:, 2])[40])}
    got = cluster_batch(probs, method, backend=backend, variant=variant, compaction=compaction,
                        device="cpu", **knobs)
    sig = batched.bucket_signature(64, 2, method=method, engine=backend, compaction=compaction,
                                   stop_at_k=knobs.get("stop_at_k", 1))
    assert sig.compaction is compaction
    for p, r in zip(probs, got):
        np.testing.assert_array_equal(r.merges, single(p, method, backend, variant=variant,
                                                       **knobs))


def test_points_input_matches_cluster(rng):
    """Points go through the same metric defaulting as ``cluster()``; below
    bucket 64 ward stays on the LW loop."""
    pts = [rng.normal(size=(n, 6)).astype(np.float32) for n in (7, 12, 20)]
    for method in ("complete", "ward"):
        got = cluster_batch(pts, method, device="cpu")
        want = jcore.cluster_batch(pts, method, backend="serial")
        for g, w, p in zip(got, want, pts):
            assert g.algorithm == "lw"
            np.testing.assert_array_equal(g.merges, single(p, method, "serial"))
            assert_close_merges(g.merges, np.asarray(w.merges))


@pytest.mark.parametrize("backend", BACKENDS)
def test_duplicate_points_and_exact_ties(backend, rng):
    """Exact-zero distances (duplicate documents) and exact ties go to the
    first minimum in every lane, as in the single-problem run."""
    X = rng.normal(size=(12, 3))
    X[4] = X[0]
    X[9] = X[2]
    D = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    ties = np.round(D * 2).astype(np.float32)     # many exactly equal distances
    for method in ("single", "complete", "average"):
        for m in (D, ties):
            got = cluster_batch([m, m.copy(), m[:7, :7]], method, backend=backend, device="cpu")
            want = jcore.cluster_batch([m, m.copy(), m[:7, :7]], method, backend=backend)
            for g, w, p in zip(got, want, (m, m, m[:7, :7])):
                np.testing.assert_array_equal(g.merges, single(p, method, backend))
                np.testing.assert_array_equal(g.merges[:, :2], np.asarray(w.merges)[:, :2])


def test_batch_of_one():
    (p,) = mats("complete", (11,), seed=3)
    for backend in BACKENDS:
        got = cluster_batch([p], "complete", backend=backend, device="cpu")
        assert len(got) == 1 and got.stats.buckets == ((16, 1),) and got.stats.padded_problems == 0
        np.testing.assert_array_equal(got[0].merges, single(p, "complete", backend))


def test_batch_result_api():
    probs = mats("complete", (6, 10), seed=4)
    got = cluster_batch(probs, "complete", device="cpu", keep_inputs=True)
    assert len(got) == 2 and [r.n for r in got] == [6, 10]
    assert [len(lab) for lab in got.labels(3)] == [6, 10]
    assert got.stats.engine == "serial"
    assert got.stats.cells_padded == 8 * 8 + 16 * 16
    assert abs(got.stats.pad_waste - (1 - 136 / 320)) < 1e-9
    assert got[0].exemplars(2).shape == (2,)
    with pytest.raises(ValueError, match="positive"):
        got.labels(0)
    cut = cluster_batch(probs, "complete", stop_at_k=4, device="cpu")
    assert [lab.max() + 1 for lab in cut.labels(2)] == [4, 4]


BAD_CALLS = {
    "method": (lambda f, p: f(p, "nope")),
    "backend": (lambda f, p: f(p, backend="nope")),
    "variant": (lambda f, p: f(p, variant="nope")),
    "stop_at_k": (lambda f, p: f(p, stop_at_k=0)),
    "algorithm": (lambda f, p: f(p, algorithm="nope")),
    "nnchain_centroid": (lambda f, p: f(p, "centroid", algorithm="nnchain")),
    "nnchain_kernel": (lambda f, p: f(p, algorithm="nnchain", backend="kernel")),
    "compaction": (lambda f, p: f(p, compaction="sometimes")),
    "one_item": (lambda f, p: f([np.zeros((1, 1))], metric=None)),
    "too_big": (lambda f, p: f([np.zeros((4097, 2))])),
    "points_shape": (lambda f, p: f([np.zeros((5, 3, 2, 2))])),
}


@pytest.mark.parametrize("case", BAD_CALLS)
def test_input_validation_matches_reference(case):
    """The same bad calls raise the same exception types in both packages."""
    probs = mats("complete", (4, 6), seed=5)

    def outcome(f):
        try:
            BAD_CALLS[case](f, probs)
        except Exception as e:      # noqa: BLE001 — the type is what is compared
            return type(e)
        return None

    want = outcome(jcore.cluster_batch)
    assert want is not None
    assert outcome(lambda *a, **k: cluster_batch(*a, device="cpu", **k)) is want


def test_distributed_backend_not_ported():
    with pytest.raises(NotImplementedError, match="A7"):
        cluster_batch(mats("complete", (4,)), backend="distributed", device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        cluster_batch_merges(mats("complete", (4,)), engine="distributed", device="cpu")


# ---------------------------------------------------------------------------
# the bucket grid, signatures, packing and slicing
# ---------------------------------------------------------------------------


def test_bucket_grid_matches_reference():
    assert batched.BUCKETS == jbatched.BUCKETS
    for n in range(1, batched.BUCKETS[-1] + 1):
        assert batched.bucket_n(n) == jbatched.bucket_n(n)
    with pytest.raises(ValueError):
        batched.bucket_n(batched.BUCKETS[-1] + 1)
    for b, mult in itertools.product(range(1, 70), (1, 2, 3, 4, 6)):
        assert batched.bucket_batch(b, mult) == jbatched.bucket_batch(b, mult)


SIG_GRID = list(itertools.product(
    (3, 9, 100, 200, 256, 300, 600, 1024, 2000), ("complete", "ward", "centroid"),
    ("serial", "kernel", "distributed"), (1, 5, 300), (True, False, "auto", None),
    ("lw", "auto"), (0, 16)))


@pytest.mark.parametrize("chunk", range(4))
def test_bucket_signature_matches_reference(chunk):
    """Every field equal to the reference's, but the kernel engine's
    compaction: the port's kernel plan halves down to 256 slots with no
    128-lane alignment, the JAX one down to 128, aligned.  So at bucket 256
    the JAX kernel signature stages (256 → 128) and the port's does not."""
    for n, method, eng, k, comp, algo, pdim in SIG_GRID[chunk::4]:
        kw = dict(method=method, engine=eng, stop_at_k=k, compaction=comp, algorithm=algo,
                  points_dim=pdim, with_threshold=k == 5)
        got = dataclasses.asdict(batched.bucket_signature(n, 5, **kw))
        want = dataclasses.asdict(jbatched.bucket_signature(n, 5, **kw))
        if eng == "kernel" and got["algorithm"] == "lw":
            bn, steps = got["bucket_n"], got["n_steps"]
            assert got.pop("compaction") is ops.resolve_kernel_compaction(comp, bn, steps)
            want.pop("compaction")
        assert got == want
    kernel = dict(method="complete", engine="kernel")
    assert jbatched.bucket_signature(256, 1, **kernel).compaction is True
    assert batched.bucket_signature(256, 1, **kernel).compaction is False
    assert batched.bucket_signature(512, 1, **kernel).compaction is True
    assert engine.plan_stages(1024, 1023, min_stage=engine.KERNEL_MIN_STAGE) == (
        (1024, 512), (512, 256), (256, 255))


def test_packing_and_prefix_match_reference():
    probs = mats("complete", (5, 8, 3), seed=6)
    sig = batched.bucket_signature(8, 3, method="complete")
    jsig = jbatched.bucket_signature(8, 3, method="complete")
    for got, want in zip(batched.pack_bucket(probs, sig), jbatched.pack_bucket(probs, jsig)):
        np.testing.assert_array_equal(got.numpy(), want)
    pts = [np.random.default_rng(i).normal(size=(n, 3)).astype(np.float32)
           for i, n in enumerate((70, 64, 100))]
    sig = batched.bucket_signature(100, 3, method="ward", algorithm="auto", points_dim=3)
    jsig = jbatched.bucket_signature(100, 3, method="ward", algorithm="auto", points_dim=3)
    assert sig.algorithm == jsig.algorithm == "nnchain"
    for got, want in zip(batched.pack_points_bucket(pts, sig),
                         jbatched.pack_points_bucket(pts, jsig)):
        np.testing.assert_array_equal(got.numpy(), want)
    for n, k, m in itertools.product((0, 1, 5, 30), (1, 3, 40), (0, 2, 29, 100)):
        assert batched.merge_prefix(n, k, m) == jbatched.merge_prefix(n, k, m)


def test_program_reload_packs_like_reference():
    """A program loaded with a full bucket, then fewer and smaller
    problems, then a device tensor, packs each as the reference packs it
    alone: the lanes the last load wrote are cleared."""
    sig = batched.bucket_signature(8, 4, method="complete")
    jsig = jbatched.bucket_signature(8, 4, method="complete")
    prog = batched.BucketProgram(sig, "cpu")
    for probs in (mats("complete", (8, 7, 6, 8), seed=8), mats("complete", (3, 5), seed=9),
                  [torch.as_tensor(m) for m in mats("complete", (4,), seed=10)]):
        prog.load(probs)
        want = jbatched.pack_bucket([np.asarray(p) for p in probs], jsig)
        for got, w in zip((prog.operand, prog.n_real), want):
            np.testing.assert_array_equal(got.numpy(), w)


def test_batch_stats_match_reference():
    """A ragged batch of matrices and points across LW and chain buckets:
    the same stats, per-bucket algorithms and merges."""
    rng = np.random.default_rng(7)
    probs = [*mats("ward", (5, 30, 9)),
             *(rng.normal(size=(n, 4)).astype(np.float32) for n in (70, 10, 100, 64))]
    got = cluster_batch(probs, "ward", device="cpu")
    want = jcore.cluster_batch(probs, "ward")
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert [r.algorithm for r in got] == [r.algorithm for r in want]
    for g, w in zip(got, want):
        assert_close_merges(g.merges, np.asarray(w.merges))


# ---------------------------------------------------------------------------
# the batched NN chains
# ---------------------------------------------------------------------------


def chain_bucket(rng, n, n_real, dim=3):
    D = np.zeros((len(n_real), n, n), np.float32)
    for b, k in enumerate(n_real):
        D[b, :k, :k] = random_distance_matrix(rng, k, dim=dim)
    return D


def assert_same_canonical(got, want, n_real):
    np.testing.assert_array_equal(got.n_merges.numpy(), np.asarray(want.n_merges))
    for b, k in enumerate(n_real):
        if k < 2:
            continue
        g = canonical_order(got.merges.numpy()[b, :k - 1], n=k)
        w = jdg.canonical_order(np.asarray(want.merges)[b, :k - 1], n=k)
        assert_close_merges(g, w)


@pytest.mark.parametrize("method", nnchain.REDUCIBLE_METHODS)
def test_nn_chain_batched_matches_reference(method):
    """Lanes of 0, 1, 2 and 20 slots (and some between), canonicalized."""
    n_real = np.array([20, 7, 1, 0, 2, 13])
    D = chain_bucket(np.random.default_rng([8, METHODS.index(method)]), 20, n_real)
    got = nnchain.nn_chain_batched(D, n_real, method, device="cpu")
    assert_same_canonical(got, jnnchain.nn_chain_batched(D, n_real, method), n_real)


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_nn_chain_batched_from_points_matches_reference(method):
    rng = np.random.default_rng([9, METHODS.index(method)])
    n_real = np.array([70, 64, 1, 0, 2, 33])
    X = np.zeros((len(n_real), 70, 5), np.float32)
    for b, k in enumerate(n_real):
        X[b, :k] = rng.normal(size=(k, 5))
    got = nnchain.nn_chain_batched_from_points(X, n_real, method, device="cpu")
    assert_same_canonical(got, jnnchain.nn_chain_batched_from_points(X, n_real, method), n_real)
    assert (got.iters.numpy() <= 4 * 70 + 8).all()


@pytest.mark.parametrize("method,metric", (("ward", None), ("average", "sqeuclidean"),
                                           ("weighted", "sqeuclidean")))
def test_points_buckets_route_to_the_chain(method, metric):
    """Default knobs send matrix-free buckets of 64 and more to the batched
    chain (smaller ones to the LW loop), as the reference does; knobs that
    pin the LW loop keep it; the early-stop knobs truncate the canonical
    list."""
    rng = np.random.default_rng(10)
    pts = [rng.normal(size=(n, 5)).astype(np.float32) for n in (70, 20, 100, 65)]
    got = cluster_batch(pts, method, metric=metric, stop_at_k=2, device="cpu")
    want = jcore.cluster_batch(pts, method, metric=metric, stop_at_k=2)
    assert [r.algorithm for r in got] == [r.algorithm for r in want] == [
        "nnchain", "lw", "nnchain", "nnchain"]
    for g, w in zip(got, want):
        assert_close_merges(g.merges, np.asarray(w.merges))
    pinned = cluster_batch(pts, method, metric=metric, variant="rowmin", device="cpu")
    assert {r.algorithm for r in pinned} == {"lw"}


def test_chain_bucket_with_nan_raises():
    pts = [np.random.default_rng(11).normal(size=(70, 3)).astype(np.float32)]
    pts[0][5] = np.nan
    with pytest.raises(RuntimeError, match="NaN"):
        jcore.cluster_batch(pts, "ward")
    with pytest.raises(RuntimeError, match="NaN"):
        cluster_batch(pts, "ward", device="cpu")


#: Lanes of chip_smoke.py's points-chain batch (``gaussian_mixture(seed=1000
#: + b, n=256, dim=64)``, ward) where two merges lie within ulps: in 36, 108
#: and 147 both packages' chains part from the LW loop at a near-tie, and
#: in 180 the two chains' canonical orders swap rows 70 and 71.
NEAR_TIE_LANES = (36, 108, 147, 180)


def test_near_tie_lanes_of_the_points_chain():
    """The service's points buckets run this chain.  On the near-tie lanes
    the port's batched chain and the JAX package's give the same dendrogram
    (clusters equal, heights within rtol 1e-4 / atol 1e-5), compared as
    dendrograms, not by canonical slots."""
    from repro_torch.data.synthetic import gaussian_mixture

    n = 256
    X = np.stack([gaussian_mixture(seed=1000 + b, n=n, dim=64)[0]
                  for b in NEAR_TIE_LANES]).astype(np.float32)
    n_real = np.full(len(NEAR_TIE_LANES), n)
    got = nnchain.nn_chain_batched_from_points(X, n_real, "ward", device="cpu")
    want = jnnchain.nn_chain_batched_from_points(X, n_real, "ward")
    np.testing.assert_array_equal(got.n_merges.numpy(), np.asarray(want.n_merges))
    for b, lane in enumerate(NEAR_TIE_LANES):
        g, w = got.merges.numpy()[b], np.asarray(want.merges)[b]
        assert jdg.merges_equivalent(g, w, n=n, rtol=1e-4, atol=1e-5), lane
