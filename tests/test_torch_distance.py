"""Port distance builders vs the JAX package's: the query budget, cosine,
Kabsch RMSD (one pair, batched, the pair grid in chunks) and the rmsd
``build_distance_matrix`` / ``cluster(..., metric="rmsd")``.

Tolerances: rtol 1e-4 / atol 1e-5 (the JAX package's kernel tests); the
rmsd builders atol 1e-4, since the square root amplifies float noise
near 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core.api import build_distance_matrix as jbuild  # noqa: E402
from repro_torch.core import build_distance_matrix, cluster  # noqa: E402
from repro_torch.core import distance as tdist  # noqa: E402
from repro_torch.data.synthetic import conformations, gaussian_mixture  # noqa: E402

RTOL, ATOL, RMSD_ATOL = 1e-4, 1e-5, 1e-4


def _rand_rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the query budget
# ---------------------------------------------------------------------------


def test_budget_records_nests_and_rejects_negative():
    with tdist.count_distance_queries() as outer:
        tdist.record_queries(5, "a")
        with tdist.count_distance_queries() as inner:
            tdist.record_queries(7, "b")
        tdist.record_queries(1, "a")
    assert (outer.queries, outer.by_tag) == (13, {"a": 6, "b": 7})
    assert (inner.queries, inner.by_tag) == (7, {"b": 7})
    assert "a=6" in repr(outer)
    tdist.record_queries(3)                    # no scope open: a no-op
    with pytest.raises(ValueError, match="cannot record"):
        tdist.DistanceBudget().record(-1)


@pytest.mark.parametrize("name,args", [
    ("pairwise_sq_euclidean", ((9, 4), None)),
    ("pairwise_sq_euclidean", ((9, 4), (5, 4))),
    ("pairwise_euclidean", ((9, 4), (5, 4))),
    ("pairwise_cosine", ((9, 4), None)),
    ("pairwise_cosine", ((9, 4), (3, 4))),
    ("pairwise_rmsd", ((7, 5, 3),)),
    ("pairwise_rmsd_cross", ((7, 5, 3), (4, 5, 3))),
])
def test_budget_by_tag_matches_reference(name, args, rng):
    arrays = [None if s is None else rng.normal(size=s).astype(np.float32) for s in args]
    with jdist.count_distance_queries() as jb:
        getattr(jdist, name)(*arrays)
    with tdist.count_distance_queries() as tb:
        getattr(tdist, name)(*[None if a is None else t(a) for a in arrays])
    assert tb.by_tag == jb.by_tag and tb.queries == jb.queries


def test_budget_is_per_thread():
    import threading

    seen = []
    with tdist.count_distance_queries() as budget:
        th = threading.Thread(target=lambda: seen.append(tdist.pairwise_cosine(t(np.ones((3, 2))))))
        th.start()
        th.join()
    assert seen and budget.queries == 0


# ---------------------------------------------------------------------------
# Euclidean and cosine builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (17, 5, 3), (64, 130, 32), (200, 200, 7)])
def test_pairwise_cosine_matches_reference(n, m, d, rng):
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = rng.normal(size=(m, d)).astype(np.float32)
    np.testing.assert_allclose(tdist.pairwise_cosine(t(X), t(Y)).numpy(),
                               np.asarray(jdist.pairwise_cosine(X, Y)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tdist.pairwise_cosine(t(X)).numpy(),
                               np.asarray(jdist.pairwise_cosine(X)), rtol=RTOL, atol=ATOL)


def test_pairwise_cosine_zero_vectors_clamped():
    X = np.asarray([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0]], np.float32)
    Y = np.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    got = tdist.pairwise_cosine(t(X), t(Y)).numpy()
    assert np.all(np.isfinite(got)) and got.min() >= 0.0 and got.max() <= 2.0
    np.testing.assert_allclose(got, np.asarray(jdist.pairwise_cosine(X, Y)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("self_dist", (True, False))
def test_pairwise_sq_euclidean_matches_reference(self_dist, rng):
    X = rng.normal(size=(40, 6)).astype(np.float32)
    Y = None if self_dist else rng.normal(size=(23, 6)).astype(np.float32)
    got = tdist.pairwise_sq_euclidean(t(X), None if Y is None else t(Y)).numpy()
    want = np.asarray(jdist.pairwise_sq_euclidean(X, Y))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    if self_dist:
        assert np.all(np.diag(got) == 0.0)


# ---------------------------------------------------------------------------
# Kabsch RMSD
# ---------------------------------------------------------------------------


def test_kabsch_rmsd_single_pair_matches_reference(rng):
    A = rng.normal(size=(12, 3)).astype(np.float32)
    B = (A @ _rand_rot(rng).T + 0.1 * rng.normal(size=(12, 3))).astype(np.float32)
    got = float(tdist.kabsch_rmsd(t(A), t(B)))
    assert got == pytest.approx(float(jdist.kabsch_rmsd(A, B)), rel=RTOL, abs=RMSD_ATOL)
    # a rigid motion of A is at distance 0
    moved = (A @ _rand_rot(rng).T + np.asarray([1.0, -2.0, 3.0])).astype(np.float32)
    assert float(tdist.kabsch_rmsd(t(A), t(moved))) == pytest.approx(0.0, abs=1e-3)


def test_kabsch_rmsd_reflection_not_allowed(rng):
    """A mirror image is not a rotation: σ₃ enters with det(V Uᵀ)'s sign."""
    A = rng.normal(size=(10, 3)).astype(np.float32)
    B = A * np.asarray([-1.0, 1.0, 1.0], np.float32)
    got = float(tdist.kabsch_rmsd(t(A), t(B)))
    assert got > 0.1
    assert got == pytest.approx(float(jdist.kabsch_rmsd(A, B)), rel=RTOL, abs=RMSD_ATOL)


def test_kabsch_rmsd_batched_matches_vmap(rng):
    A = rng.normal(size=(4, 6, 9, 3)).astype(np.float32)
    B = rng.normal(size=(6, 9, 3)).astype(np.float32)       # broadcast over the first dim
    got = tdist.kabsch_rmsd(t(A), t(B)).numpy()
    want = np.asarray(jax.vmap(jax.vmap(jdist.kabsch_rmsd))(A, np.broadcast_to(B, A.shape)))
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RMSD_ATOL)


@pytest.mark.parametrize("chunk", (None, 7, 1))
def test_pairwise_rmsd_matches_reference(chunk, monkeypatch):
    """The full and cross pair grids, also cut into chunks of 7 and 1 pairs."""
    if chunk is not None:
        monkeypatch.setattr(tdist, "RMSD_CHUNK_PAIRS", chunk)
    C, _ = conformations(0, 23, 8, k=3, noise=0.1)
    Q, _ = conformations(1, 9, 8, k=3, noise=0.1)
    got = tdist.pairwise_rmsd(t(C)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdist.pairwise_rmsd(C)), rtol=RTOL, atol=RMSD_ATOL)
    np.testing.assert_array_equal(got, got.T)
    assert np.all(np.diag(got) == 0.0)
    np.testing.assert_allclose(tdist.pairwise_rmsd_cross(t(Q), t(C)).numpy(),
                               np.asarray(jdist.pairwise_rmsd_cross(Q, C)),
                               rtol=RTOL, atol=RMSD_ATOL)


def test_build_distance_matrix_rmsd_matches_reference():
    C, _ = conformations(2, 40, 12, k=4)
    got = build_distance_matrix(C, "rmsd", device="cpu")
    assert got.dtype == torch.float32 and got.shape == (40, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbuild(C, "rmsd")),
                               rtol=RTOL, atol=RMSD_ATOL)


@pytest.mark.parametrize("shape", [(10, 4), (10, 4, 2)])
def test_build_distance_matrix_rmsd_rejects_points(shape):
    X = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="conformations"):
        jbuild(X, "rmsd")
    with pytest.raises(ValueError, match="conformations"):
        build_distance_matrix(X, "rmsd", device="cpu")


@pytest.mark.parametrize("n,method", [(48, "complete"), (60, "average"), (300, "complete")])
def test_cluster_rmsd_matches_reference(n, method):
    """The paper's protein-conformation build through ``cluster``: the LW
    loop (n < 256) and the dense chain (n = 300), as the JAX package runs
    them."""
    C, _ = conformations(3, n, 10, k=4)
    got = cluster(C, method, metric="rmsd", device="cpu")
    want = jcluster(C, method, metric="rmsd")
    assert (got.algorithm, got.backend, got.metric) == (want.algorithm, want.backend, "rmsd")
    np.testing.assert_array_equal(got.merges[:, [0, 1, 3]], want.merges[:, [0, 1, 3]])
    np.testing.assert_allclose(got.merges[:, 2], want.merges[:, 2], rtol=RTOL, atol=RMSD_ATOL)
    np.testing.assert_array_equal(got.exemplars(4), want.exemplars(4))


def test_cluster_rmsd_needs_conformations():
    X = gaussian_mixture(seed=0, n=12, dim=4, return_labels=False)
    with pytest.raises(ValueError, match="conformations"):
        jcluster(X, "complete", metric="rmsd")
    with pytest.raises(ValueError, match="conformations"):
        cluster(X, "complete", metric="rmsd", device="cpu")
