"""Port kernels vs the Pallas kernels: the min-scan seed (B1), the fused
merge step (B2) and the pairwise distance build (B4, through
``ops.pairwise``).

On the CPU the port's wrappers take the plain torch versions, which are
held against the JAX package's kernels run as ``tests/test_kernels.py``
runs them (interpret mode).  The CUDA kernels against their plain
versions on the card are in ``test_torch_cuda.py``, which needs no jax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.linkage import METHODS  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.lw_step import lw_step_pallas  # noqa: E402
from repro_torch.core.distance import count_distance_queries  # noqa: E402
from repro_torch.kernels import lw_step, minscan, pairwise  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402
from tests.test_torch_cuda import step_problem, torch_step_args  # noqa: E402


@pytest.mark.parametrize("n", (16, 100, 256, 385))
def test_masked_argmin_sweep(n, rng):
    D = random_distance_matrix(rng, n).astype(np.float32)
    alive = rng.random(n) > 0.3
    alive[:2] = True
    vk, fk = ops.masked_argmin(jnp.asarray(D), jnp.asarray(alive))
    vt, ft = minscan.masked_argmin(torch.from_numpy(D), torch.from_numpy(alive))
    assert vt.dtype == torch.float32 and ft.dtype == torch.int64 and vt.ndim == ft.ndim == 0
    assert float(vt) == float(vk)
    assert int(ft) == int(fk)


def test_masked_argmin_tie_break():
    """Row-major first-minimum tie-breaking (the reference's tie case)."""
    n = 64
    D = np.full((n, n), 5.0, np.float32)
    D[3, 7] = D[7, 3] = 1.0
    D[10, 20] = D[20, 10] = 1.0            # tie — earlier row-major cell wins
    np.fill_diagonal(D, 0.0)
    v, f = minscan.masked_argmin(torch.from_numpy(D), torch.ones(n, dtype=torch.bool))
    vk, fk = ops.masked_argmin(jnp.asarray(D), jnp.ones(n, bool))
    assert (int(f) // n, int(f) % n) == (3, 7) == (int(fk) // n, int(fk) % n)
    assert float(v) == float(vk) == 1.0


@pytest.mark.parametrize("n_live", (0, 1))
def test_masked_argmin_fully_masked(n_live, rng):
    n = 48
    D = random_distance_matrix(rng, n).astype(np.float32)
    alive = np.zeros(n, bool)
    alive[5:5 + n_live] = True
    v, f = minscan.masked_argmin(torch.from_numpy(D), torch.from_numpy(alive))
    vr, fr = ref.ref_masked_argmin(D, alive)
    assert (float(v), int(f)) == (float(vr), int(fr)) == (np.inf, 0)


@pytest.mark.parametrize("method", METHODS)
def test_lw_step_matches_pallas(method, rng):
    n = 256
    D, alive, sizes, i, j = step_problem(rng, n, method)
    Dk, rmin_k, rarg_k = lw_step_pallas(
        method, jnp.asarray(D), jnp.asarray(D[:, i]), jnp.asarray(D[:, j]),
        D[i, j], sizes[i], sizes[j], jnp.asarray(sizes), jnp.asarray(alive),
        i, j, block_m=128, interpret=True,
    )
    args = torch_step_args(D, alive, sizes, i, j)
    Dt, rmin_t, rarg_t = lw_step.lw_step(method, *args)
    assert Dt is args[0]                   # committed in place
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rmin_t.numpy(), np.asarray(rmin_k), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rarg_t.numpy(), np.asarray(rarg_k))
    dead = ~alive | (np.arange(n) == j)
    assert np.isinf(rmin_t.numpy()[dead]).all() and (rarg_t.numpy()[dead] == 0).all()


def test_wrappers_reject_bad_operands():
    D = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="square"):
        minscan.masked_argmin(D, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="alive"):
        minscan.masked_argmin(torch.zeros(4, 4), torch.ones(4))
    with pytest.raises(ValueError, match="unknown linkage method"):
        lw_step.lw_step("nope", *torch_step_args(np.zeros((4, 4)), np.ones(4, bool),
                                                 np.ones(4), 0, 1))


def test_cpu_wrappers_launch_nothing(rng):
    """CPU tensors take the plain versions: no kernel, no launch counted."""
    def counts():
        return (minscan.masked_argmin.launches, lw_step.lw_step.launches,
                pairwise.pairwise_sq_euclidean.launches)

    before = counts()
    D, alive, sizes, i, j = step_problem(rng, 32, "complete")
    minscan.masked_argmin(torch.from_numpy(D), torch.from_numpy(alive))
    lw_step.lw_step("complete", *torch_step_args(D, alive, sizes, i, j))
    tops.pairwise(torch.from_numpy(D))
    assert counts() == before


@pytest.mark.parametrize("n,m,d", [(64, 64, 16), (128, 96, 32), (300, 300, 50),
                                   (256, 256, 128), (70, 130, 7)])
@pytest.mark.parametrize("dtype", (jnp.float32, jnp.bfloat16))
def test_pairwise_sweep(n, m, d, dtype, rng):
    """``ops.pairwise`` against the JAX ``ops.pairwise`` (the Pallas kernel in
    interpret mode) over ``tests/test_kernels.py``'s shapes.  Both cast to
    float32 first, so the bf16 inputs reach both builds as the same float32
    values, and the tolerance is the float32 one, 1e-4."""
    X = jnp.asarray(rng.normal(size=(n, d)), dtype)
    Y = jnp.asarray(rng.normal(size=(m, d)), dtype)
    want = np.asarray(ops.pairwise(X, Y))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    Xt = torch.from_numpy(np.array(X, np.float32)).to(tdtype)
    Yt = torch.from_numpy(np.array(Y, np.float32)).to(tdtype)
    got = tops.pairwise(Xt, Yt)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_pairwise_self_keeps_gram_diagonal(rng):
    """With ``Y=None`` the kernel route does not zero the diagonal (the
    reference route's contract), unlike the distance builder."""
    X = (rng.normal(size=(50, 9)) * 30.0).astype(np.float32)
    got = tops.pairwise(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(ops.pairwise(jnp.asarray(X))), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, got.T, rtol=1e-5, atol=1e-2)
    assert np.all(got >= 0.0)
    gram = pairwise.pairwise_sq_euclidean_plain(torch.from_numpy(X), torch.from_numpy(X))
    np.testing.assert_array_equal(np.diag(got), np.diag(gram.numpy()))


@pytest.mark.parametrize("n,m,d", [(0, 5, 3), (4, 0, 3), (3, 2, 0), (1, 1, 1)])
def test_pairwise_ragged_and_empty(n, m, d, rng):
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    got = pairwise.pairwise_sq_euclidean(X, Y)
    assert got.shape == (n, m) and got.dtype == torch.float32
    want = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_pairwise_records_no_queries_and_rejects_bad_shapes():
    X = torch.zeros(4, 3)
    with count_distance_queries() as budget:
        tops.pairwise(X, X)
    assert budget.queries == 0
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        pairwise.pairwise_sq_euclidean(X, torch.zeros(4, 2))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        pairwise.pairwise_sq_euclidean(torch.zeros(4), X)
