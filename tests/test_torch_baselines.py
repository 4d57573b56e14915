"""The paper's baselines in the port (``repro_torch.core.baselines``)
against the JAX package's (``repro.core.baselines``): k-means's Lloyd
iterations from the reference's own k-means++ seeds, the port's k-means
on its own (the reference's quality tests, seeds, the degenerate case),
and Prim's-MST single linkage bit for bit, with its dendrogram equal to
LW(single) as ``tests/test_properties.py`` holds the reference.

The port runs with ``device="cpu"``; its card runs against the CPU are in
``test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as ref  # noqa: E402
from repro.core.distance import count_distance_queries as ref_count_queries  # noqa: E402
from repro.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import dendrogram as dg  # noqa: E402
from repro_torch.core.distance import count_distance_queries  # noqa: E402
from repro_torch.core.lance_williams import lance_williams  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: Prim's loop runs many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _ref_seeding():
    """The reference's k-means++ seeding, jit'd as its ``kmeans`` runs it."""
    return jax.jit(ref._kmeans_pp_init, static_argnums=2)


def _purity(labels, truth, k):
    p = 0
    for c in range(k):
        m = truth[labels == c]
        if len(m):
            p += np.bincount(m).max()
    return p / len(truth)


def _lloyd_from_ref_seeds(key, X, k, iters):
    cents = np.asarray(_ref_seeding()(key, jnp.asarray(X, jnp.float32), k))
    return baselines._lloyd(torch.as_tensor(X, dtype=torch.float32), torch.tensor(cents), iters)


def _assert_kmeans_equal(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_matches_reference_kmeans(seed, k):
    """The port's Lloyd iterations from the reference's own seeds give the
    reference's k-means: labels equal, values within rtol/atol 1e-5."""
    X, _ = gaussian_mixture(seed, 300, 8, k=5, spread=8.0)
    key = jax.random.PRNGKey(seed)
    want = ref.kmeans(key, X, k=k, iters=40)
    got = _lloyd_from_ref_seeds(key, X, k, 40)
    _assert_kmeans_equal(got, want)


def test_lloyd_matches_reference_with_an_empty_cluster():
    """Three distinct points, five clusters: the seeding repeats points, a
    repeated centroid loses every tie and its cluster stays empty, so it
    keeps its centroid."""
    rng = np.random.default_rng(7)
    X = np.repeat(rng.normal(size=(3, 4)), 10, axis=0)
    key = jax.random.PRNGKey(0)
    want = ref.kmeans(key, X, k=5, iters=10)
    got = _lloyd_from_ref_seeds(key, X, 5, 10)
    _assert_kmeans_equal(got, want)
    assert len(np.unique(got.labels.numpy())) < 5          # an empty cluster
    assert float(got.inertia) == 0.0


def test_lloyd_step_is_the_reference_body():
    """One step by hand: a cluster's new centroid is its points' mean."""
    X = torch.tensor([[0.0, 0.0], [0.0, 2.0], [10.0, 10.0]])
    cents = torch.tensor([[0.0, 1.0], [9.0, 9.0], [50.0, 50.0]])
    new = baselines._lloyd_step(X, cents)
    assert torch.equal(new, torch.tensor([[0.0, 1.0], [10.0, 10.0], [50.0, 50.0]]))


def test_kmeans_recovers_mixture():
    X, y = gaussian_mixture(0, 300, 8, k=5, spread=8.0)
    res = baselines.kmeans(torch.Generator().manual_seed(0), X, k=5, iters=40, device="cpu")
    assert _purity(res.labels.numpy(), y, 5) > 0.95
    assert float(res.inertia) > 0
    assert res.labels.dtype == torch.int64 and res.centroids.shape == (5, 8)


def test_kmeans_inertia_decreases_with_k():
    X, _ = gaussian_mixture(1, 200, 6, k=4)
    i2 = float(baselines.kmeans(torch.Generator().manual_seed(0), X, 2, device="cpu").inertia)
    i8 = float(baselines.kmeans(torch.Generator().manual_seed(0), X, 8, device="cpu").inertia)
    assert i8 < i2


def test_kmeans_same_seed_same_result():
    X, _ = gaussian_mixture(2, 250, 6, k=4)
    a = baselines.kmeans(torch.Generator().manual_seed(5), X, 6, device="cpu")
    b = baselines.kmeans(torch.Generator().manual_seed(5), X, 6, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = baselines.kmeans(torch.Generator().manual_seed(6), X, 6, device="cpu")
    assert not torch.equal(a.centroids, c.centroids)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_seeds_are_rows_of_x(seed):
    X, _ = gaussian_mixture(seed, 120, 5, k=4)
    Xt = torch.as_tensor(X, dtype=torch.float32)
    cents = baselines._kmeans_pp_init(torch.Generator().manual_seed(seed), Xt, 7)
    hits = (cents[:, None, :] == Xt[None]).all(-1)            # (k, n)
    assert hits.any(1).all()
    assert len({tuple(c) for c in cents.tolist()}) == 7       # D² sampling never repeats here


def test_kmeans_degenerate_two_points():
    """Every point is a seed after two draws: the probabilities are all 0,
    the draw takes index 0 (the reference's ``jax.random.choice`` does),
    and the result is exact."""
    X = np.array([[0.0, 0.0], [1.0, 1.0]] * 5)
    got = baselines.kmeans(torch.Generator().manual_seed(0), X, 4, device="cpu")
    want = ref.kmeans(jax.random.PRNGKey(0), X, k=4)
    assert float(got.inertia) == float(want.inertia) == 0.0
    cents = got.centroids.numpy()
    assert {tuple(c) for c in cents} == {(0.0, 0.0), (1.0, 1.0)}
    assert sum(tuple(c) == tuple(X[0]) for c in cents) >= 2   # the repeats are X[0]


def test_kmeans_records_no_distance_queries():
    """The reference's jit'd k-means records none; so does the port's."""
    X, _ = gaussian_mixture(0, 60, 4, k=3)
    with ref_count_queries() as want:
        ref.kmeans(jax.random.PRNGKey(0), X, k=3, iters=5)
    with count_distance_queries() as got:
        baselines.kmeans(torch.Generator().manual_seed(0), X, 3, 5, device="cpu")
    assert got.queries == want.queries == 0


def _distmat(X):
    return np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))


def _mst_inputs():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 4))
    ints = rng.integers(0, 4, size=(50, 50)).astype(np.float64)
    return {
        "random": _distmat(X),
        "random_float32": _distmat(X).astype(np.float32),
        "tie_dense": ints + ints.T,
        "upper_triangular": np.triu(_distmat(rng.normal(size=(30, 3))), 1),
        "n1": np.zeros((1, 1)),
        "n2": np.array([[0.0, 2.5], [2.5, 0.0]]),
        "n2_upper": np.array([[0.0, 2.5], [0.0, 0.0]]),
        "inf_and_nan": np.array([[0.0, np.nan, 1.0, np.inf], [np.nan, 0.0, 3.0, 1.0],
                                 [1.0, 3.0, 0.0, np.inf], [np.inf, 1.0, np.inf, 0.0]]),
    }


@pytest.mark.parametrize("name", list(_mst_inputs()))
def test_mst_single_linkage_bit_for_bit(name):
    D = _mst_inputs()[name]
    want = ref.mst_single_linkage(D)
    got = baselines.mst_single_linkage(D, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape == (D.shape[0] - 1, 4)
    assert np.array_equal(got, want, equal_nan=True)
    # a tensor input takes the same path
    assert np.array_equal(baselines.mst_single_linkage(torch.as_tensor(D), device="cpu"), want,
                          equal_nan=True)


def test_mst_structure():
    X = np.random.default_rng(0).normal(size=(30, 4))
    m = baselines.mst_single_linkage(_distmat(X), device="cpu")
    dg.validate_merges(m)
    assert (np.diff(m[:, 2]) >= -1e-9).all()     # heights sorted (Kruskal order)


def _canon(labels):
    m: dict = {}
    return tuple(m.setdefault(x, len(m)) for x in labels)


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@st.composite
def points(draw):
    n = draw(st.integers(4, 20))
    seed = draw(st.integers(0, 2**31 - 1))
    return np.random.default_rng(seed).normal(size=(n, 3))


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(points())
def test_single_linkage_equals_mst(X):
    """The port's LW(single) and its Prim's-MST produce identical
    partitions (at the reference property's cuts), and the MST merges are
    the reference's."""
    D = _distmat(X)
    n = X.shape[0]
    m_lw = lance_williams(D, "single", device="cpu").merges.numpy()
    m_mst = baselines.mst_single_linkage(D, device="cpu")
    assert np.array_equal(m_mst, ref.mst_single_linkage(D))
    np.testing.assert_allclose(np.sort(m_lw[:, 2]), np.sort(m_mst[:, 2]), rtol=1e-4, atol=1e-5)
    for k in (1, 2, max(2, n // 2)):
        assert _canon(dg.cut(m_lw, k)) == _canon(dg.cut(m_mst, k))
