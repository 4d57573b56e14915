"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no jax, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.linkage import METHODS  # noqa: E402
from repro_torch.kernels import lw_step, minscan  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def random_distance_matrix(rng, n, squared=False):
    """Distances of n random points in 4-D (as tests/conftest.py makes them;
    not imported from there, so that this file runs wherever the port does)."""
    X = rng.normal(size=(n, 4))
    D = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return D if squared else np.sqrt(D)


def step_problem(rng, n, method, dead=0.3):
    """A mid-run state: symmetric D, dead slots, sizes, and a live i < j."""
    D = random_distance_matrix(rng, n, squared=method in ("centroid", "median", "ward"))
    D = D.astype(np.float32)
    alive = rng.random(n) > dead
    alive[:3] = True
    live = np.flatnonzero(alive)
    i, j = sorted(rng.choice(live, 2, replace=False))
    sizes = np.where(alive, rng.integers(1, 7, n), 0).astype(np.float32)
    return D, alive, sizes, int(i), int(j)


def torch_step_args(D, alive, sizes, i, j, device="cpu"):
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    Dt = t(D)
    return (Dt, Dt[i].clone(), Dt[j].clone(), t([D[i, j]]), t([sizes[i]]), t([sizes[j]]),
            t(sizes), t(alive, torch.bool), t([i], torch.int64), t([j], torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 97, 1968))
def test_cuda_masked_argmin_matches_plain(n, cuda, rng):
    D = torch.tensor(random_distance_matrix(rng, n).astype(np.float32), device=cuda)
    alive = torch.tensor(rng.random(n) > 0.3, device=cuda)
    alive[0] = True
    launches = minscan.masked_argmin.launches
    v, f = minscan.masked_argmin(D, alive)
    vp, fp = minscan.masked_argmin_plain(D, alive)
    torch.cuda.synchronize()
    assert minscan.masked_argmin.launches == launches + 1
    assert (float(v), int(f)) == (float(vp), int(fp))


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", (97, 1968))
def test_cuda_lw_step_matches_plain(method, n, cuda, rng):
    D, alive, sizes, i, j = step_problem(rng, n, method)
    args = torch_step_args(D, alive, sizes, i, j, device=cuda)
    plain = [a.clone() for a in args]
    launches = lw_step.lw_step.launches
    Dk, rmin_k, rarg_k = lw_step.lw_step(method, *args)
    Dp, rmin_p, rarg_p = lw_step.lw_step_plain(method, *plain)
    torch.cuda.synchronize()
    assert lw_step.lw_step.launches == launches + 1
    # the kernel rounds each operation as torch does: equal, not just close
    assert torch.equal(Dk, Dp) and torch.equal(rmin_k, rmin_p) and torch.equal(rarg_k, rarg_p)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_cuda_cluster_matches_cpu(method, cuda):
    """The whole loop on the card: index-identical to the CPU run, one seed
    launch and n - 1 step launches."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=4, n=97, dim=8, return_labels=False)
    minscan.masked_argmin.launches = lw_step.lw_step.launches = 0
    got = cluster(X, method)                       # the default device is CUDA
    assert (minscan.masked_argmin.launches, lw_step.lw_step.launches) == (1, 96)
    want = cluster(X, method, device="cpu")
    np.testing.assert_array_equal(got.merges[:, :2], want.merges[:, :2])
    np.testing.assert_allclose(got.merges[:, 2], want.merges[:, 2], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_strided_matrix(cuda):
    D = torch.zeros(8, 16, device=cuda)[:, :8]
    with pytest.raises(ValueError, match="contiguous"):
        minscan.masked_argmin(D, torch.ones(8, dtype=torch.bool, device=cuda))
