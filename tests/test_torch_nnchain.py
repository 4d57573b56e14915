"""Port NN-chain engine vs the JAX package's: the dense and matrix-free
chains in chain order, the row build (kernel B5's plain version) against
the Pallas row kernel in interpret mode, one mid-run summary state fed to
both packages, and ``cluster()``'s routing over a table of inputs.

The port runs with ``device="cpu"``, so its row build is
``row_sq_euclidean_plain``; the CUDA kernel against it is in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import nnchain as jnnchain  # noqa: E402
from repro.kernels.pairwise import row_sq_euclidean_pallas  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cluster  # noqa: E402
from repro_torch.core import nnchain  # noqa: E402
from repro_torch.core.dendrogram import merges_equivalent  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.kernels.pairwise import row_sq_euclidean, row_sq_euclidean_plain  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402


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


def assert_chain_match(got, want, rtol, atol):
    """Raw chain-order merges: slots and sizes equal, heights close, and
    the same merge and trip counts."""
    gm, wm = got.merges.cpu().numpy(), np.asarray(want.merges)
    assert gm.shape == wm.shape
    np.testing.assert_array_equal(gm[:, [0, 1, 3]], wm[:, [0, 1, 3]])
    np.testing.assert_allclose(gm[:, 2], wm[:, 2], rtol=rtol, atol=atol)
    assert (got.n_merges, got.iters) == (int(want.n_merges), int(want.iters))


@pytest.mark.parametrize("method", nnchain.REDUCIBLE_METHODS)
@pytest.mark.parametrize("n", (2, 3, 17, 48))
def test_dense_chain_matches_reference(method, n, rng):
    D = random_distance_matrix(rng, n, squared=method == "ward")
    got = nnchain.nn_chain(D, method, device="cpu")
    assert_chain_match(got, jnnchain.nn_chain(jnp.asarray(D, jnp.float32), method),
                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
@pytest.mark.parametrize("n", (2, 21, 40))
def test_points_chain_matches_reference(method, n, rng):
    X = rng.normal(size=(n, 5)).astype(np.float32)
    got = nnchain.nn_chain_from_points(X, method, device="cpu")
    assert_chain_match(got, jnnchain.nn_chain_from_points(X, method, use_pallas=False),
                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
@pytest.mark.parametrize("n", (2, 21, 40))
def test_points_chain_matches_pallas_route(method, n, rng):
    """Against the reference chain whose rows come from the Pallas row
    kernel (interpret mode on the CPU), its padding included; Gram-form
    rows differ from the difference form by float error."""
    X = rng.normal(size=(n, 5)).astype(np.float32)
    got = nnchain.nn_chain_from_points(X, method, device="cpu")
    want = jnnchain.nn_chain_from_points(X, method, use_pallas=True, block_n=128)
    assert_chain_match(got, want, rtol=1e-4, atol=1e-4)


def test_points_chain_rejects_pair_statistic_methods(rng):
    with pytest.raises(ValueError, match="geometric-summary"):
        nnchain.nn_chain_from_points(rng.normal(size=(8, 3)), "complete", device="cpu")
    with pytest.raises(ValueError, match="points"):
        nnchain.nn_chain_from_points(rng.normal(size=(8, 3, 2)), "ward", device="cpu")
    with pytest.raises(ValueError, match="reducible"):
        nnchain.nn_chain(random_distance_matrix(rng, 8), "centroid", device="cpu")


def test_row_plain_matches_pallas(rng):
    Y = rng.normal(size=(256, 128)).astype(np.float32)
    want = np.asarray(row_sq_euclidean_pallas(jnp.asarray(Y[7]), jnp.asarray(Y),
                                              block_n=128, interpret=True))
    Yt = torch.from_numpy(Y)
    got = row_sq_euclidean(Yt[7], Yt)           # a CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), row_sq_euclidean_plain(Yt[7], Yt).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match=r"\(d,\)"):
        row_sq_euclidean(Yt[7, :5], Yt)


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_mid_run_summary_state(method, rng):
    """A JAX chain stopped after 100 merges hands its summaries to both
    packages: the row of every live slot agrees (with the jnp and the
    Pallas row builds), and the rest of the run from that state, with an
    empty chain, gives the same merges."""
    n, d, done = 256, 128, 100
    X = rng.normal(size=(n, d)).astype(np.float32)
    jops = jnnchain._points_nnchain_ops(method, n, use_pallas=False, block_n=128,
                                        interpret=False)
    pops = jnnchain._points_nnchain_ops(method, n, use_pallas=True, block_n=128,
                                        interpret=True)
    start = jnnchain._init_state((jnp.asarray(X), jnp.zeros(n, jnp.float32)),
                                 jnp.ones(n, bool), done)
    mid = jnnchain._chain_loop(jops, start, done)
    W, u = (np.asarray(a) for a in mid.rep)
    sizes, alive = np.asarray(mid.sizes), np.asarray(mid.alive)
    assert alive.sum() == n - done

    state = convert.summaries_from_numpy(W, u, sizes, alive, device="cpu")
    ops = nnchain._points_nnchain_ops(method)
    for top in np.flatnonzero(alive)[::7]:
        got = ops.row(state, int(top)).numpy()[alive]
        np.testing.assert_allclose(got, np.asarray(jops.row(mid, jnp.int32(top)))[alive],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(pops.row(mid, jnp.int32(top)))[alive],
                                   rtol=1e-4, atol=1e-4)

    rest = n - 1 - done
    want = jnnchain._chain_loop(jops, mid._replace(
        merges=jnp.zeros((rest, 4), jnp.float32), n_merges=jnp.int32(0),
        iters=jnp.int32(0), chain_len=jnp.int32(0)), rest)
    assert_chain_match(nnchain._chain_loop(ops, state, rest), want, rtol=1e-5, atol=1e-5)
    assert int(state.alive.sum()) == 1 and float(state.sizes.sum()) == n


# (n, method, knobs): cluster() routing against the JAX package.
ROUTING = [
    (200, "complete", {}),
    (200, "ward", {}),
    (200, "average", {}),
    (200, "centroid", {}),
    (200, "ward", dict(matrix_free=True)),
    (200, "average", dict(metric="sqeuclidean", matrix_free=True)),
    (200, "ward", dict(matrix_free=False)),
    (200, "complete", dict(stop_at_k=7)),
    (300, "complete", {}),
    (300, "ward", {}),
    (300, "average", {}),
    (300, "average", dict(metric="sqeuclidean")),
    (300, "centroid", {}),
    (300, "ward", dict(matrix_free=True)),
    (300, "weighted", dict(metric="sqeuclidean", matrix_free=True)),
    (300, "ward", dict(matrix_free=False)),
    (300, "complete", dict(stop_at_k=7)),
    (300, "ward", dict(distance_threshold=40.0)),
    (300, "average", dict(metric="sqeuclidean", matrix_free=True, stop_at_k=5,
                          distance_threshold=20.0)),
    (300, "complete", dict(algorithm="nnchain", backend="serial", matrix_free=False)),
    (300, "complete", dict(algorithm="lw")),
    (4096, "ward", {}),
    (4096, "ward", dict(stop_at_k=9)),
    (4096, "average", dict(metric="sqeuclidean")),
    (4096, "average", {}),
    (4096, "ward", dict(matrix_free=False)),
]


@pytest.mark.parametrize("n,method,knobs", ROUTING,
                         ids=[f"{n}-{m}-{'-'.join(map(str, k.items()))}" for n, m, k in ROUTING])
def test_cluster_routing_matches_reference(n, method, knobs):
    X = gaussian_mixture(seed=n, n=n, dim=16, return_labels=False)
    got = cluster(X, method, device="cpu", **knobs)
    want = jcluster(X, method, **knobs)
    assert (got.algorithm, got.backend) == (want.algorithm, want.backend)
    assert (got.distances is None) == (want.distances is None)
    assert got.n == want.n == n and got.n_merges == want.n_merges
    if n < 4096 or want.distances is None:
        np.testing.assert_array_equal(got.merges[:, [0, 1, 3]], want.merges[:, [0, 1, 3]])
        np.testing.assert_allclose(got.merges[:, 2], want.merges[:, 2], rtol=1e-4, atol=1e-5)
    else:
        # the two packages' Gram-form matrix builds differ by ~1e-6
        # relative; among 8M float32 distances some pairs tie exactly in
        # one build and not in the other, so tied merges may swap places
        # in the canonical order: the trees must still be the same
        assert merges_equivalent(got.merges, want.merges, n=n)
    for k in (1, 3, 7):
        if k >= n - got.n_merges:
            np.testing.assert_array_equal(got.labels(k), want.labels(k))


@pytest.mark.parametrize("n,method,knobs", [
    (200, "complete", dict(matrix_free=True)),
    (200, "centroid", dict(matrix_free=True)),
    (200, "average", dict(matrix_free=True)),
    (300, "ward", dict(algorithm="lw", matrix_free=True)),
    (300, "centroid", dict(algorithm="nnchain")),
    (300, "complete", dict(algorithm="nnchain", backend="kernel")),
    (300, "ward", dict(matrix_free="sometimes")),
    (300, "ward", dict(stop_at_k=0)),
])
def test_cluster_invalid_combinations_match_reference(n, method, knobs):
    X = gaussian_mixture(seed=n, n=n, dim=16, return_labels=False)
    with pytest.raises(ValueError) as want:
        jcluster(X, method, **knobs)
    with pytest.raises(ValueError) as got:
        cluster(X, method, device="cpu", **knobs)
    assert type(got.value) is type(want.value)


def test_nan_input_raises_like_reference():
    X = gaussian_mixture(seed=1, n=300, dim=4, return_labels=False)
    X[5, 0] = np.nan
    for run in (lambda: jcluster(X, "ward", matrix_free=True),
                lambda: cluster(X, "ward", matrix_free=True, device="cpu")):
        with pytest.raises(RuntimeError, match="NaN"):
            run()
