"""Port landmark tier vs the JAX package's ``repro.core.landmark``.

Both packages run the same seeded input: the landmark sets and
``group_labels`` must be equal, the merges slot-equal with heights
within rtol 1e-4 / atol 1e-5 (the rmsd runs atol 1e-4: the square root
amplifies float noise near 0), and the distance-query budget equal by
tag.  Also the reference's own gates on the port alone: the
sub-quadratic budget, quality against the exact chain, determinism, and
the ``cluster()`` wiring and validation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import count_distance_queries as jcount  # noqa: E402
from repro.core import landmark as jlandmark  # noqa: E402
from repro_torch.core import cluster, count_distance_queries  # noqa: E402
from repro_torch.core import dendrogram as dg  # noqa: E402
from repro_torch.core import landmark  # noqa: E402
from repro_torch.core.nnchain import nn_chain_from_points  # noqa: E402
from repro_torch.data.synthetic import conformations, gaussian_mixture  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the loops here run many small ops, and
    parallel test workers that each start a thread pool oversubscribe the
    cores (on an 8-core CPU, six processes of eight threads each ran the
    n = 4096 resident chain ~100× slower than six of one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

RTOL, ATOL, RMSD_ATOL = 1e-4, 1e-5, 1e-4


def _mixture(seed=0, n=512, dim=8, k=6, spread=10.0):
    return gaussian_mixture(seed=seed, n=n, dim=dim, k=k, spread=spread)


def assert_merges_match(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=RTOL, atol=atol)


# (method, metric, n, n_landmarks, refine, seed); points from _mixture
LANDMARK_CASES = [
    ("ward", "sqeuclidean", 1024, None, 0, 0),     # matrix-free landmark chain (B5 path)
    ("ward", "sqeuclidean", 512, 64, 2, 3),        # refinement passes
    ("average", "sqeuclidean", 400, 50, 1, 0),     # matrix-free, average
    ("complete", "euclidean", 600, None, 0, 1),    # dense (k, k) chain
    ("single", "euclidean", 300, 40, 0, 2),
    ("weighted", "sqeuclidean", 300, 30, 0, 0),
    ("average", "cosine", 500, None, 0, 0),        # cosine (k, k) matrix
    ("ward", "sqeuclidean", 96, 96, 0, 0),         # every point a landmark
    ("ward", "sqeuclidean", 32, 1, 0, 0),          # one landmark: all attach to it
]


@pytest.mark.parametrize("method,metric,n,k,refine,seed", LANDMARK_CASES,
                         ids=[f"{m}-{mt}-n{n}-k{k}-r{r}-s{s}"
                              for m, mt, n, k, r, s in LANDMARK_CASES])
def test_landmark_cluster_matches_reference(method, metric, n, k, refine, seed):
    pts, _ = _mixture(seed=n, n=n)
    kw = dict(metric=metric, n_landmarks=k, seed=seed, refine=refine)
    with jcount() as jb:
        want = jlandmark.landmark_cluster(pts, method, **kw)
    with count_distance_queries() as tb:
        got = landmark.landmark_cluster(pts, method, device="cpu", **kw)
    np.testing.assert_array_equal(got.landmarks, want.landmarks)
    np.testing.assert_array_equal(got.group_labels, want.group_labels)
    assert int(got.n_merges) == int(want.n_merges) == n - 1 and got.k == want.k
    assert_merges_match(got.merges, want.merges)
    assert tb.by_tag == jb.by_tag, (tb, jb)


def test_landmark_rmsd_matches_reference():
    C, truth = conformations(0, 48, 12, k=3, noise=0.05)
    kw = dict(metric="rmsd", n_landmarks=16, seed=0)
    with jcount() as jb:
        want = jlandmark.landmark_cluster(C, "average", **kw)
    with count_distance_queries() as tb:
        got = landmark.landmark_cluster(C, "average", device="cpu", **kw)
    np.testing.assert_array_equal(got.group_labels, want.group_labels)
    assert_merges_match(got.merges, want.merges, atol=RMSD_ATOL)
    assert tb.by_tag == jb.by_tag
    assert dg.label_agreement(dg.cut(got.merges, 3, n=48), truth) >= 0.9


@pytest.mark.parametrize("n", (0, 1))
def test_trivial_sizes(n):
    X = np.zeros((n, 3), np.float32)
    got = landmark.landmark_cluster(X, "ward", device="cpu")
    want = jlandmark.landmark_cluster(X, "ward")
    assert got.merges.shape == want.merges.shape == (0, 4)
    np.testing.assert_array_equal(got.landmarks, want.landmarks)
    np.testing.assert_array_equal(got.group_labels, want.group_labels)


@pytest.mark.parametrize("n", (2, 17, 1000, 4096, 131072))
def test_default_landmark_count_and_sample_match_reference(n):
    k = landmark.default_landmark_count(n)
    assert k == jlandmark.default_landmark_count(n)
    np.testing.assert_array_equal(landmark.sample_landmarks(n, k, 5),
                                  jlandmark.sample_landmarks(n, k, 5))


def test_query_budget_subquadratic():
    """The reference's gate (``tests/test_landmark.py``) on the port."""
    n = 1024
    pts, _ = _mixture(seed=1, n=n)
    k = landmark.default_landmark_count(n)
    with count_distance_queries() as budget:
        res = landmark.landmark_cluster(pts, "ward", metric="sqeuclidean", seed=0, device="cpu")
    assert budget.queries <= 3 * (n * k + k * k), budget
    assert budget.queries < n * n, budget
    assert budget.by_tag["sq_euclidean"] == (n - k) * k, budget
    assert budget.by_tag["landmark_chain"] % k == 0
    assert budget.by_tag["landmark_chain"] <= (4 * k + 8) * k
    assert res.n_merges == n - 1


def test_quality_gate_and_determinism():
    n, k_true = 512, 6
    pts, truth = _mixture(seed=3, n=n, k=k_true)
    res = landmark.landmark_cluster(pts, "ward", metric="sqeuclidean", seed=0, device="cpu")
    exact = dg.canonical_order(nn_chain_from_points(pts, "ward", device="cpu").merges.numpy(),
                               n=n)
    assert dg.cut_label_agreement(res.merges, exact, k_true, n=n) >= 0.95
    assert dg.adjusted_rand_index(dg.cut(res.merges, k_true, n=n), truth) >= 0.95
    again = landmark.landmark_cluster(pts, "ward", metric="sqeuclidean", seed=0, device="cpu")
    np.testing.assert_array_equal(res.merges, again.merges)
    other = landmark.landmark_cluster(pts, "ward", metric="sqeuclidean", seed=1, device="cpu")
    assert not np.array_equal(res.landmarks, other.landmarks)
    dg.validate_merges(res.merges, n=n)
    assert dg.is_monotone(res.merges)


# ---------------------------------------------------------------------------
# cluster() wiring
# ---------------------------------------------------------------------------


CLUSTER_CASES = [
    ("ward", dict(algorithm="landmark", seed=0)),
    ("ward", dict(algorithm="landmark", seed=0, stop_at_k=6)),
    ("ward", dict(algorithm="landmark", seed=0, distance_threshold=50.0)),
    ("ward", dict(n_landmarks=16, seed=0)),                   # the knob resolves "auto"
    ("ward", dict(refine=1, seed=2)),
    ("complete", dict(algorithm="landmark", backend="serial", seed=0)),
    ("average", dict(algorithm="landmark", metric="cosine", n_landmarks=30, seed=4)),
    ("ward", dict(algorithm="landmark", matrix_free=True, seed=0)),
]


@pytest.mark.parametrize("method,knobs", CLUSTER_CASES,
                         ids=[f"{m}-{'-'.join(map(str, k.items()))}" for m, k in CLUSTER_CASES])
def test_cluster_landmark_matches_reference(method, knobs):
    n = 300
    pts, _ = _mixture(seed=8, n=n)
    with jcount() as jb:
        want = jcluster(pts, method, **knobs)
    with count_distance_queries() as tb:
        got = cluster(pts, method, device="cpu", **knobs)
    assert (got.algorithm, got.backend, got.metric) == (want.algorithm, want.backend, want.metric)
    assert got.algorithm == "landmark" and got.distances is None
    assert got.points is not None and got.n == want.n == n
    assert_merges_match(got.merges, want.merges)
    assert tb.by_tag == jb.by_tag


def test_cluster_landmark_labels_and_keep_inputs():
    n = 300
    pts, truth = _mixture(seed=8, n=n)
    res = cluster(pts, "ward", algorithm="landmark", seed=0, device="cpu")
    assert dg.adjusted_rand_index(res.labels(6), truth) >= 0.95
    bare = cluster(pts, "ward", algorithm="landmark", seed=0, keep_inputs=False, device="cpu")
    assert bare.points is None
    np.testing.assert_array_equal(bare.merges, res.merges)


LANDMARK_ERRORS = [
    # (data kind, method, knobs, match) — each raises ValueError in both packages
    ("matrix", "ward", dict(algorithm="landmark"), "pre-built distance matrix"),
    ("points", "ward", dict(algorithm="landmark", backend="kernel"), "single-device"),
    ("points", "ward", dict(algorithm="landmark", backend="distributed"), "single-device"),
    ("points", "ward", dict(algorithm="lw", n_landmarks=16), "landmark tier"),
    ("points", "ward", dict(algorithm="nnchain", refine=1), "landmark tier"),
    ("points", "ward", dict(matrix_free=True, n_landmarks=16), "landmark tier"),
    ("points", "centroid", dict(algorithm="landmark"), "reducible"),
    ("points", "average", dict(algorithm="landmark", metric="cosine", refine=1), "refine"),
    ("points", "ward", dict(algorithm="landmark", refine=-1), "refine"),
    ("points", "ward", dict(algorithm="landmark", n_landmarks=33), "1 <= k <= n"),
    ("points", "ward", dict(algorithm="landmark", metric="rmsd"), "conformations"),
]


@pytest.mark.parametrize("kind,method,knobs,match", LANDMARK_ERRORS,
                         ids=[f"{i}-{e[3]}" for i, e in enumerate(LANDMARK_ERRORS)])
def test_cluster_landmark_validation(kind, method, knobs, match):
    pts, _ = _mixture(seed=10, n=32)
    data = (((pts[:, None] - pts[None]) ** 2).sum(-1) if kind == "matrix" else pts)
    with pytest.raises(ValueError, match=match):
        jcluster(data, method, **knobs)
    with pytest.raises(ValueError, match=match):
        cluster(data, method, device="cpu", **knobs)


@pytest.mark.parametrize("call,match", [
    (lambda lc, X: lc(X, "ward", metric="mahalanobis"), "metric"),
    (lambda lc, X: lc(X[:, :, None], "ward"), r"\(n, d\) points"),
])
def test_landmark_cluster_validation(call, match):
    pts, _ = _mixture(seed=10, n=32)
    with pytest.raises(ValueError, match=match):
        call(jlandmark.landmark_cluster, pts)
    with pytest.raises(ValueError, match=match):
        call(lambda *a, **k: landmark.landmark_cluster(*a, device="cpu", **k), pts)
    for k in (0, 9):
        with pytest.raises(ValueError, match="1 <= k <= n"):
            landmark.sample_landmarks(8, k, 0)
