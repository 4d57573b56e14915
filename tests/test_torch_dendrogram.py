"""The port's vectorized ``to_linkage_matrix`` against the JAX package's
loop, bit for bit (float64): random, early-stopped and tie-dense merge
lists, the engines' own lists, and n = 1 and 2."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dendrogram as jdg  # noqa: E402
from repro_torch.core import METHODS, cluster  # noqa: E402
from repro_torch.core import dendrogram as dg  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402


def random_merges(rng, n: int, n_merges: int, *, ties: bool = False) -> np.ndarray:
    """A valid slot-convention list: ``n_merges`` merges of live slots
    ``i < j`` (slot ``i`` keeps the union), float32 as the engines emit."""
    alive = list(range(n))
    sizes = np.ones(n)
    rows = []
    for _ in range(n_merges):
        a, b = sorted(rng.choice(len(alive), 2, replace=False))
        i, j = alive[a], alive[b]
        h = float(rng.integers(0, 3)) if ties else float(rng.random())
        sizes[i] += sizes[j]
        rows.append((i, j, h, sizes[i]))
        alive.pop(b)
    return np.asarray(rows, np.float32).reshape(-1, 4)


def assert_same_linkage(merges, n):
    got, want = dg.to_linkage_matrix(merges, n=n), jdg.to_linkage_matrix(merges, n=n)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", (3, 7, 64, 300))
@pytest.mark.parametrize("kind", ("full", "early", "ties"))
def test_random_lists(n, kind):
    rng = np.random.default_rng([n, len(kind)])
    for _ in range(5):
        k = n - 1 if kind != "early" else int(rng.integers(0, n - 1))
        assert_same_linkage(random_merges(rng, n, k, ties=kind == "ties"), n)


def test_smallest_problems():
    assert_same_linkage(np.zeros((0, 4), np.float32), 1)
    assert dg.to_linkage_matrix(np.zeros((0, 4), np.float32)).shape == (0, 4)
    assert_same_linkage(np.array([[0, 1, 0.5, 2]], np.float32), 2)
    assert_same_linkage(np.zeros((0, 4), np.float32), 2)       # stopped at k = 2


@pytest.mark.parametrize("method", METHODS)
def test_engine_lists(method, rng):
    """The lists the engines emit (tie-dense integer matrices too), and the
    default leaf count of a full list."""
    D = random_distance_matrix(rng, 40)
    ints = np.round(D).astype(np.float32)
    for data, k in ((D, 1), (ints, 1), (D, 9)):
        res = cluster(data, method, algorithm="lw", stop_at_k=k, device="cpu")
        assert_same_linkage(res.merges, 40)
        assert np.array_equal(res.linkage_matrix, jdg.to_linkage_matrix(res.merges, n=40))
    full = cluster(D, method, algorithm="lw", device="cpu").merges
    assert np.array_equal(dg.to_linkage_matrix(full), jdg.to_linkage_matrix(full))
