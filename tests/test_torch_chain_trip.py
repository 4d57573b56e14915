"""The matrix-free chain's resident loop (kernel B5's trip entry through its
plain twin, ``chain_trip_plain``) against the JAX package's chain and
against the port's host-driven loop.

On the CPU the loop calls ``chain_trip_plain`` trip by trip; the CUDA
kernel and its graph replay against it are in ``test_torch_cuda.py``.
Chain-order merges and the trip count must equal the JAX package's, with
its jnp row and with the Pallas row in interpret mode, and the host-driven
loop's bit for bit.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import count_distance_queries as jcount  # noqa: E402
from repro.core import landmark as jlandmark  # noqa: E402
from repro.core import dendrogram as jdendrogram  # noqa: E402
from repro.core import nnchain as jnnchain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cluster, count_distance_queries, landmark, nnchain  # noqa: E402
from repro_torch.core import dendrogram  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.kernels import pairwise  # noqa: E402


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


def host_loop(X, method):
    """The host-driven chain loop over the summary ops on the CPU."""
    W = torch.tensor(np.asarray(X, np.float32))
    n = W.shape[0]
    state = nnchain._init_state((W, torch.zeros(n)), n, "cpu")
    return nnchain._chain_loop(nnchain._points_nnchain_ops(method), state, n - 1)


def run_buffers(X, method):
    """A resident run on the CPU; returns the buffers it ends with."""
    n = len(X)
    b = pairwise.chain_buffers(torch.tensor(np.asarray(X, np.float32)), torch.zeros(n),
                               torch.ones(n, dtype=torch.bool), torch.ones(n), n - 1)
    while not nnchain._chain_done(b):
        pairwise.chain_trip(method, b)
    return b


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
@pytest.mark.parametrize("n", (2, 3, 57, 200))
def test_resident_chain_matches_reference(method, n, rng):
    """The jnp-row JAX chain: merges in chain order, merge and trip counts;
    the host-driven loop: bit for bit."""
    X = rng.normal(size=(n, 6)).astype(np.float32)
    got = nnchain.nn_chain_from_points(X, method, device="cpu")
    assert_chain_match(got, jnnchain.nn_chain_from_points(X, method, use_pallas=False),
                       rtol=1e-5, atol=1e-6)
    want = host_loop(X, method)
    assert torch.equal(got.merges, want.merges)
    assert (got.n_merges, got.iters) == (want.n_merges, want.iters) == (n - 1, want.iters)


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_resident_chain_matches_pallas_route(method, rng):
    """Against the JAX chain whose rows come from the Pallas row kernel in
    interpret mode (Gram form: heights within its float error)."""
    X = rng.normal(size=(45, 5)).astype(np.float32)
    got = nnchain.nn_chain_from_points(X, method, device="cpu")
    want = jnnchain.nn_chain_from_points(X, method, use_pallas=True, block_n=128)
    assert_chain_match(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_trips_past_the_end_change_nothing(method, rng):
    X = rng.normal(size=(30, 4)).astype(np.float32)
    b = run_buffers(X, method)
    assert b.count.tolist()[1:] == [29, nnchain.nn_chain_from_points(X, method,
                                                                     device="cpu").iters, 0]
    before = [t.clone() for t in b[:9]]
    for _ in range(5):
        pairwise.chain_trip(method, b)
    for name, a, want in zip(pairwise.ChainBuffers._fields, b, before):
        assert torch.equal(a, want), name


def test_trip_cap_ends_the_run(rng):
    """A run capped below the trips it needs stops at the cap, and later
    trips do nothing."""
    X = rng.normal(size=(40, 4)).astype(np.float32)
    b = pairwise.chain_buffers(torch.tensor(X), torch.zeros(40), torch.ones(40, dtype=torch.bool),
                               torch.ones(40), 39)._replace(cap=25)
    while not nnchain._chain_done(b):
        pairwise.chain_trip("ward", b)
    pairwise.chain_trip("ward", b)
    assert b.count.tolist()[2:] == [25, 0] and b.count.tolist()[1] < 39


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_nan_row_stops_the_loop(method, rng):
    """A NaN in the tip's live row sets the stop flag: no merge, the trip
    counted, as the host loop breaks; later trips do nothing."""
    X = rng.normal(size=(25, 4)).astype(np.float32)
    X[7, 2] = np.nan
    got = nnchain.nn_chain_from_points(X, method, device="cpu")
    want = host_loop(X, method)
    assert (got.n_merges, got.iters) == (want.n_merges, want.iters)
    assert got.n_merges < 24 and torch.equal(got.merges, want.merges)
    b = run_buffers(X, method)
    assert int(b.count[3]) == 1
    before = [t.clone() for t in b[:9]]
    pairwise.chain_trip(method, b)
    for a, w in zip(b, before):                  # W holds the NaN
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)


def test_nan_input_raises_like_reference():
    X = gaussian_mixture(seed=2, n=64, dim=4, return_labels=False)
    X[11, 1] = np.nan
    for run in (lambda: jcluster(X, "ward", matrix_free=True),
                lambda: cluster(X, "ward", matrix_free=True, device="cpu")):
        with pytest.raises(RuntimeError, match="NaN"):
            run()


def test_restart_pushes_first_live_slot():
    """Two far-apart pairs: the chain empties after the first merge and
    the trip that merges pushes the first live slot at once."""
    X = np.array([[0.0, 0.0], [100.0, 0.0], [0.5, 0.0], [100.25, 0.0]], np.float32)
    n = len(X)
    b = pairwise.chain_buffers(torch.tensor(X), torch.zeros(n), torch.ones(n, dtype=torch.bool),
                               torch.ones(n), n - 1)
    pairwise.chain_trip("ward", b)                 # 0 pushes 2
    assert b.count.tolist() == [2, 0, 1, 0] and b.chain[:2].tolist() == [0, 2]
    pairwise.chain_trip("ward", b)                 # 2 and 0 merge into 0, the first live slot
    assert b.count.tolist() == [1, 1, 2, 0] and int(b.chain[0]) == 0
    assert b.alive.tolist() == [True, True, False, True]
    assert b.bits.tolist() == [0b1011]
    np.testing.assert_array_equal(b.merges[0].numpy(), [0.0, 2.0, 0.25, 2.0])
    np.testing.assert_allclose(b.W[0].numpy(), [0.25, 0.0])


def test_previous_element_wins_ties():
    """Equidistant neighbors: the tip merges with the previous chain
    element, not the first index of the minimum."""
    X = np.array([[0.0], [2.0], [1.0], [5.0]], np.float32)
    n = len(X)
    b = pairwise.chain_buffers(torch.tensor(X), torch.zeros(n), torch.ones(n, dtype=torch.bool),
                               torch.ones(n), n - 1)
    b.chain[:2] = torch.tensor([1, 2], dtype=torch.int32)       # chain 1 -> 2: tip 2, prev 1
    b.count[0] = 2
    pairwise.chain_trip("average", b)            # 0 and 1 both at 1 from 2: prev 1 wins
    assert b.count.tolist() == [1, 1, 1, 0] and b.merges[0, :2].tolist() == [1.0, 2.0]


@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_mid_run_summary_state(method, rng):
    """A JAX chain stopped after 50 merges hands its summaries to the port
    through ``convert.summaries_from_numpy``; the resident loop from that
    state, with an empty chain, gives the JAX package's merges and trips."""
    n, d, done = 128, 16, 50
    X = rng.normal(size=(n, d)).astype(np.float32)
    jops = jnnchain._points_nnchain_ops(method, n, use_pallas=False, block_n=128,
                                        interpret=False)
    start = jnnchain._init_state((jnp.asarray(X), jnp.zeros(n, jnp.float32)),
                                 jnp.ones(n, bool), done)
    mid = jnnchain._chain_loop(jops, start, done)
    W, u = (np.asarray(a) for a in mid.rep)
    state = convert.summaries_from_numpy(W, u, np.asarray(mid.sizes), np.asarray(mid.alive),
                                         device="cpu")
    rest = n - 1 - done
    want = jnnchain._chain_loop(jops, mid._replace(
        merges=jnp.zeros((rest, 4), jnp.float32), n_merges=jnp.int32(0),
        iters=jnp.int32(0), chain_len=jnp.int32(0)), rest)
    assert_chain_match(nnchain._resident_chain(method, state, rest), want, rtol=1e-5, atol=1e-5)
    assert int(state.alive.sum()) == 1 and float(state.sizes.sum()) == n


@pytest.mark.parametrize("method", ("ward", "average"))
def test_landmark_budget_by_tag_unchanged(method):
    """The landmark chain records its trips times k: the budget by tag
    equals the JAX package's."""
    pts, _ = gaussian_mixture(seed=3, n=600, dim=8, k=6, spread=10.0)
    with jcount() as jb:
        want = jlandmark.landmark_cluster(pts, method, metric="sqeuclidean")
    with count_distance_queries() as tb:
        got = landmark.landmark_cluster(pts, method, metric="sqeuclidean", device="cpu")
    assert tb.by_tag == jb.by_tag and tb.queries == jb.queries
    assert tb.by_tag["landmark_chain"] > 0
    np.testing.assert_array_equal(got.merges[:, [0, 1, 3]], np.asarray(want.merges)[:, [0, 1, 3]])


NOISE = np.float32(1.0) - np.float32(2.0**-23) * 2      # one ulp below 1.0


@pytest.mark.parametrize("case", ("chain", "ulp below its child", "float64", "inversion",
                                  "dead slot", "empty"))
def test_canonical_order_matches_reference(case, rng):
    """The chain's host post-processing (the canonical order and the
    structural check, loops over Python scalars) against the JAX
    package's: the same rows, or the same error."""
    if case in ("chain", "float64"):
        X = rng.normal(size=(80, 3)).astype(np.float32)
        merges = nnchain.nn_chain_from_points(X, "ward", device="cpu").merges.numpy()
        merges = merges.astype(np.float64) if case == "float64" else merges
    else:
        merges = {"ulp below its child": [[0, 1, 1.0, 2], [0, 2, NOISE, 3], [0, 3, 2.0, 4]],
                  "inversion": [[0, 1, 1.0, 2], [0, 2, 0.5, 3]],
                  "dead slot": [[0, 1, 1.0, 2], [1, 2, 2.0, 2]],
                  "empty": np.zeros((0, 4))}[case]
        merges = np.asarray(merges, np.float32)
    n = merges.shape[0] + 1
    try:
        want = jdendrogram.canonical_order(merges, n=n)
    except AssertionError as err:
        with pytest.raises(AssertionError, match=f"^{re.escape(str(err))}$"):
            dendrogram.canonical_order(merges, n=n)
        return
    got = dendrogram.canonical_order(merges, n=n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case == "ulp below its child":
        assert got[1, 2] == 1.0


def test_chain_trip_rejects_bad_operands(rng):
    b = pairwise.chain_buffers(torch.tensor(rng.normal(size=(8, 3)).astype(np.float32)),
                               torch.zeros(8), torch.ones(8, dtype=torch.bool), torch.ones(8), 7)
    with pytest.raises(ValueError, match="methods"):
        pairwise.chain_trip("complete", b)
    with pytest.raises(ValueError, match="operand"):
        pairwise.chain_trip("ward", b._replace(chain=b.chain.long()))
    with pytest.raises(ValueError, match="operand"):
        pairwise.chain_trip("ward", b._replace(merges=torch.zeros(3, 4)))
