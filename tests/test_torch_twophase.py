"""The two-phase approximate tier in the port against the JAX package's:
``nn_chain_from_summaries`` (phase 2's chain, on B5's trip through its
plain twin), ``_replay_summaries`` bit for bit, ``two_phase_from_points``
over a grid of shard counts and intermediate cluster counts, and the
``cluster(algorithm="twophase")`` route; on a 3-rank gloo group, the
default shard count (the world size, where the JAX package reads its
device count).

The port runs with ``device="cpu"``; its card runs against the CPU are in
``test_torch_cuda.py``.  Slots and sizes are held equal, heights within
rtol 1e-4 / atol 1e-5.  The mixture is the reference test's well-separated
one (``tests/test_distributed_nnchain.py``), so no truncation level sits
on a near-tie.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import run_ranks  # noqa: E402

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import nnchain as jnnchain  # noqa: E402
from repro.core.dendrogram import canonical_order as jcanonical_order  # noqa: E402
from repro_torch.core import cluster  # noqa: E402
from repro_torch.core import dendrogram as dg  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import nnchain  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
SHARDS = (1, 3, 4, 8)
INTERMEDIATE_K = (None, 1, 5)
CUT_K = 8                  # the mixture's components
SUMMARY_K = 64


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the chains run many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mixture(n_per=24, k=6, d=5, seed=0, spread=20.0, noise=0.1):
    """The reference test's separated Gaussian mixture (its ``_mixture``):
    the merge structure is unambiguous."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    return np.concatenate(
        [c + noise * rng.normal(size=(n_per, d)) for c in centers]
    ).astype(np.float32)


@functools.cache
def grid_points() -> np.ndarray:
    """The reference test's mixture (8 components of 32 in 6-D) less its
    last 3 points: n = 253, which no shard count of the grid divides."""
    return mixture(n_per=32, k=CUT_K, d=6, seed=1)[:-3]


@functools.cache
def exact(method: str) -> np.ndarray:
    """The exact chain's canonical merges on the grid's points."""
    X = grid_points()
    return dg.canonical_order(nnchain.nn_chain_from_points(X, method, device="cpu")
                              .merges.numpy(), n=len(X))


def summaries(seed: int, k: int = SUMMARY_K, d: int = 5):
    """``k`` summaries as phase 2 finds them: points, ``u >= 0``, integer
    sizes >= 1."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(k, d)).astype(np.float32) * 3
    u = np.abs(rng.normal(size=k)).astype(np.float32)
    sizes = rng.integers(1, 9, size=k).astype(np.float32)
    return W, u, sizes


def assert_merges_match(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# phase 2's chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
@pytest.mark.parametrize("seed", (0, 1))
def test_summaries_chain_matches_reference(method, seed):
    """Chain-order merges over summary slots, the trips and the merge
    count as the JAX package's; the caller's arrays are not modified."""
    W, u, sizes = summaries(seed)
    before = [a.copy() for a in (W, u, sizes)]
    got = nnchain.nn_chain_from_summaries(W, u, sizes, method, device="cpu")
    want = jnnchain.nn_chain_from_summaries(W, u, sizes, method)
    assert_merges_match(got.merges.numpy(), want.merges)
    assert (got.n_merges, got.iters) == (int(want.n_merges), int(want.iters))
    assert got.merges[:, 3].max() == sizes.sum()
    for a, b in zip((W, u, sizes), before):
        assert np.array_equal(a, b)


def test_summaries_chain_leaves_torch_inputs_alone():
    W, u, sizes = (torch.tensor(a) for a in summaries(2, k=20))
    copies = [t.clone() for t in (W, u, sizes)]
    nnchain.nn_chain_from_summaries(W, u, sizes, "average", device="cpu")
    for t, c in zip((W, u, sizes), copies):
        assert torch.equal(t, c)


def test_summaries_chain_with_unit_sizes_is_the_points_chain():
    """Unit sizes and ``u = 0``: the points chain's merges, bit for bit."""
    W, _, _ = summaries(3, k=40)
    for method in nnchain.POINTS_METHODS:
        got = nnchain.nn_chain_from_summaries(W, np.zeros(40), np.ones(40), method, device="cpu")
        want = nnchain.nn_chain_from_points(W, method, device="cpu")
        assert torch.equal(got.merges, want.merges) and got.iters == want.iters


SUMMARY_ERRORS = {
    "method": (lambda W, u, s: (W, u, s, "complete"), "summary agglomeration supports"),
    "W 1-D": (lambda W, u, s: (W[0], u, s, "ward"), r"expected \(k, d\) summary points"),
    "u shape": (lambda W, u, s: (W, u[:-1], s, "ward"), "u and sizes must be"),
    "sizes shape": (lambda W, u, s: (W, u, s[:, None], "ward"), "u and sizes must be"),
}


@pytest.mark.parametrize("case", SUMMARY_ERRORS)
def test_summaries_chain_errors(case):
    """The reference's ``ValueError``s, message for message."""
    make, match = SUMMARY_ERRORS[case]
    args = make(*summaries(4, k=8))
    with pytest.raises(ValueError, match=match):
        nnchain.nn_chain_from_summaries(*args, device="cpu")
    with pytest.raises(ValueError, match=match):
        jnnchain.nn_chain_from_summaries(*args)


@pytest.mark.parametrize("k", (0, 1))
def test_summaries_chain_below_two(k):
    W, u, sizes = summaries(5, k=max(k, 1))
    got = nnchain.nn_chain_from_summaries(W[:k], u[:k], sizes[:k], device="cpu")
    want = jnnchain.nn_chain_from_summaries(W[:k], u[:k], sizes[:k])
    assert got.merges.shape == (0, 4) == tuple(want.merges.shape)
    assert got.n_merges == int(want.n_merges) == 0


# ---------------------------------------------------------------------------
# the host replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_replay_summaries_bit_for_bit(method):
    """On a reference phase-1 prefix (the JAX chain's canonical merges cut
    at round(√m) clusters), the port's replay is the reference's bit for
    bit: the summaries phase 2 starts from."""
    X = mixture(n_per=16, k=5, d=7, seed=3, noise=1.0)
    m = len(X)
    prefix = jcanonical_order(np.asarray(jnnchain.nn_chain_from_points(X, method).merges),
                              n=m)[: m - round(np.sqrt(m))]
    got = tdist._replay_summaries(X, prefix, method)
    want = jdist._replay_summaries(X, prefix, method)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert int(got[3].sum()) == round(np.sqrt(m))


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("intermediate_k", INTERMEDIATE_K)
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_two_phase_matches_reference(method, shards, intermediate_k):
    """The stitched, repaired, height-sorted merges equal the JAX
    package's; the result is a valid dendrogram; where every shard keeps
    more clusters than one, the reference test's gates hold: merge-set
    agreement with the exact chain >= 0.5 and the exact 8-cut."""
    X = grid_points()
    n = len(X)
    got = tdist.two_phase_from_points(X, method, shards=shards, intermediate_k=intermediate_k,
                                      device="cpu")
    want = jdist.two_phase_from_points(X, method, shards=shards, intermediate_k=intermediate_k)
    merges = got.merges.numpy()
    assert_merges_match(merges, want.merges)
    assert got.n_merges == int(want.n_merges) == n - 1
    dg.validate_merges(merges, n=n)
    assert np.all(np.diff(merges[:, 2]) >= 0)
    if intermediate_k != 1:
        assert dg.merge_set_agreement(exact(method), merges, n=n) >= 0.5
        assert dg.adjusted_rand_index(dg.cut(merges, CUT_K, n=n),
                                      dg.cut(exact(method), CUT_K, n=n)) == 1.0


EDGE_CASES = {
    "shards > n": (5, dict(shards=8)),
    "no phase-1 merge in any shard": (10, dict(shards=3, intermediate_k=4)),
    "a shard without phase-1 merges": (10, dict(shards=3, intermediate_k=3)),
    "one shard, one cluster": (12, dict(shards=1, intermediate_k=1)),
    "n = 2": (2, dict(shards=2)),
}


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_two_phase_edges_match_reference(method, case):
    n, knobs = EDGE_CASES[case]
    X = np.random.default_rng(6).normal(size=(n, 4)).astype(np.float32)
    got = tdist.two_phase_from_points(X, method, device="cpu", **knobs)
    want = jdist.two_phase_from_points(X, method, **knobs)
    assert_merges_match(got.merges.numpy(), want.merges)
    assert got.n_merges == int(want.n_merges) == n - 1


@pytest.mark.parametrize("n", (0, 1))
def test_two_phase_below_two_points(n):
    X = np.zeros((n, 3), np.float32)
    got = tdist.two_phase_from_points(X, shards=0, device="cpu")     # before the shard check
    want = jdist.two_phase_from_points(X, shards=0)
    assert got.merges.shape == (0, 4) == tuple(np.asarray(want.merges).shape)
    assert got.n_merges == int(want.n_merges) == 0


@pytest.mark.parametrize("knobs,match", (
    (dict(method="complete"), "two-phase tier supports"),
    (dict(shards=0), "shards must be positive"),
    (dict(shards=-2), "shards must be positive"),
))
def test_two_phase_errors(knobs, match):
    X = mixture(n_per=4, k=2)
    knobs = dict(dict(method="ward"), **knobs)
    with pytest.raises(ValueError, match=match):
        tdist.two_phase_from_points(X, device="cpu", **knobs)
    with pytest.raises(ValueError, match=match):
        jdist.two_phase_from_points(X, **knobs)
    with pytest.raises(ValueError, match=r"expected \(n, d\) points"):
        tdist.two_phase_from_points(X[0], device="cpu")


def test_two_phase_nan_stops_phase_one():
    X = grid_points().copy()
    X[5, 0] = np.nan
    with pytest.raises(RuntimeError, match="phase-1 chain on shard at offset 0"):
        tdist.two_phase_from_points(X, shards=4, device="cpu")


# ---------------------------------------------------------------------------
# the cluster() route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
@pytest.mark.parametrize("backend", ("auto", "serial", "distributed"))
def test_cluster_route_matches_reference(backend, method):
    X = mixture(n_per=16, k=4, seed=2)
    metric = None if method == "ward" else "sqeuclidean"
    got = cluster(X, method, metric=metric, algorithm="twophase", backend=backend,
                  device="cpu")
    want = jcluster(X, method, metric=metric, algorithm="twophase", backend=backend)
    assert (got.algorithm, got.backend) == (want.algorithm, want.backend)
    assert got.backend == ("serial" if backend == "auto" else backend)
    assert got.distances is None and got.n == len(X)
    assert_merges_match(got.merges, want.merges)
    assert len(got.labels(4)) == len(X)


@pytest.mark.parametrize("stop", ("stop_at_k", "distance_threshold"))
def test_cluster_route_stops_match_reference(stop):
    X = mixture(n_per=16, k=4, seed=2)
    full = np.asarray(jcluster(X, "ward", algorithm="twophase").merges)
    # a threshold between two merge heights: the packages round heights apart
    knobs = (dict(stop_at_k=7) if stop == "stop_at_k"
             else dict(distance_threshold=float(full[40:42, 2].mean())))
    got = cluster(X, "ward", algorithm="twophase", device="cpu", **knobs)
    want = jcluster(X, "ward", algorithm="twophase", **knobs)
    assert_merges_match(got.merges, want.merges)
    assert got.n_merges == (len(X) - 7 if stop == "stop_at_k" else 41)
    assert got.labels(len(X) - got.n_merges).shape == (len(X),)


def _route_errors():
    X = mixture(n_per=8, k=3)
    D = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return {
        "complete linkage": ((X, "complete"), {}),
        "a precomputed matrix": ((D, "ward"), dict(metric="precomputed")),
        "the kernel backend": ((X, "ward"), dict(backend="kernel")),
        "euclidean average": ((X, "average"), {}),
    }


@pytest.mark.parametrize("case", ("complete linkage", "a precomputed matrix",
                                  "the kernel backend", "euclidean average"))
def test_cluster_route_errors(case):
    args, knobs = _route_errors()[case]
    with pytest.raises(ValueError, match="twophase"):
        cluster(*args, algorithm="twophase", device="cpu", **knobs)
    with pytest.raises(ValueError, match="twophase"):
        jcluster(*args, algorithm="twophase", **knobs)


# ---------------------------------------------------------------------------
# the default shard count on a 3-rank gloo group
# ---------------------------------------------------------------------------


def ranks_default_shards() -> dict:
    """On each rank: the tier with the default shard count, directly and
    through ``cluster()``."""
    import torch.distributed as dist

    X = grid_points()
    direct = tdist.two_phase_from_points(X, "average", device="cpu").merges.numpy()
    res = cluster(X, "average", metric="sqeuclidean", algorithm="twophase", device="cpu")
    return dict(p=dist.get_world_size(), direct=direct, merges=res.merges, backend=res.backend)


def test_default_shards_are_the_world_size(tmp_path):
    results = run_ranks(3, "ranks_default_shards", tmp_path, module="test_torch_twophase")
    want = jdist.two_phase_from_points(grid_points(), "average", shards=3).merges
    for r in results:
        assert r["p"] == 3 and r["backend"] == "serial"
        assert_merges_match(r["direct"], want)
        assert np.array_equal(r["merges"], r["direct"])
    one = tdist.two_phase_from_points(grid_points(), "average", device="cpu").merges.numpy()
    assert not np.array_equal(one[:, :2], results[0]["direct"][:, :2])   # shards=1 here
