"""Port merge loop vs the JAX engines: one step from a shared mid-run
state, and full runs for all 7 methods.

Contract (as in ``tests/test_kernels.py``): merge slots equal, heights
within rtol 1e-4 / atol 1e-5, sizes equal.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.lance_williams import lance_williams  # noqa: E402
from repro.core.linkage import METHODS  # noqa: E402
from repro.core.naive import naive_lw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.dendrogram import validate_merges  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402

GEOMETRIC = ("centroid", "median", "ward")


def assert_merges_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


@pytest.mark.parametrize("form", ("full", "upper", "asymmetric"))
def test_symmetrize_matches_reference(form, rng):
    D = rng.random((9, 9)).astype(np.float32)
    if form == "full":
        D = D + D.T
    elif form == "upper":
        D = np.triu(D, 1)
    want = np.asarray(jengine.symmetrize(D))
    got = engine.symmetrize(torch.from_numpy(D))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="square"):
        engine.symmetrize(torch.zeros(3, 4))


def test_resolve_n_steps_matches_reference():
    for n, k in ((10, 1), (10, 4), (10, 10), (10, 30), (1, 1)):
        assert engine.resolve_n_steps(n, k) == jengine.resolve_n_steps(n, k)
    with pytest.raises(ValueError):
        engine.resolve_n_steps(10, 0)


@pytest.mark.parametrize("method", ("complete", "average", "centroid", "ward"))
def test_one_step_from_shared_state(method, rng):
    """Both engines resume from the same mid-run state and take one step."""
    n, block_m, t = 128, 128, 5
    D = random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)
    alive = rng.random(n) > 0.25
    sizes = np.where(alive, rng.integers(1, 5, n), 0).astype(np.float32)
    merges = np.zeros((n - 1, 4), np.float32)
    merges[:t] = rng.random((t, 4))

    jops_ = jengine.kernel_ops(method, n, "baseline", block_m=block_m, interpret=True)
    zero = jnp.zeros((), jnp.int32)
    jstate = jengine.LWState(
        D=jnp.asarray(D), alive=jnp.asarray(alive), sizes=jnp.asarray(sizes),
        merges=jnp.asarray(merges), n_merges=jnp.int32(t),
        cand=(zero, zero, jnp.float32(0)), cache=(),
    )
    jstate = jops_.seed(jstate)
    jnext = jax.jit(jengine.make_step(jops_))(jstate)

    state = convert.lwstate_from_numpy(
        np.asarray(jstate.D), np.asarray(jstate.alive), np.asarray(jstate.sizes),
        np.asarray(jstate.merges), np.asarray(jstate.n_merges),
        tuple(np.asarray(x) for x in jstate.cand), device="cpu",
    )
    nxt = convert.to_numpy(engine.make_step(engine.kernel_ops(method, n))(state))

    assert nxt.n_merges == int(jnext.n_merges) == t + 1
    np.testing.assert_allclose(nxt.D, np.asarray(jnext.D), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nxt.alive, np.asarray(jnext.alive))
    np.testing.assert_array_equal(nxt.sizes, np.asarray(jnext.sizes))
    assert_merges_match(nxt.merges, np.asarray(jnext.merges))
    r, c, dmin = nxt.cand
    jr, jc, jdmin = (np.asarray(x) for x in jnext.cand)
    assert (int(r), int(c)) == (int(jr), int(jc))
    np.testing.assert_allclose(dmin, jdmin, rtol=1e-5)


@functools.cache
def reference_run(method, n):
    """One problem per (method, n) and the full merge lists of the JAX kernel
    backend, the JAX serial backend and the numpy mirror.  A run stopped
    at ``k`` clusters records exactly the first ``n - k`` of these merges."""
    rng = np.random.default_rng([n, METHODS.index(method)])
    D = random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)
    kernel = np.asarray(jops.lance_williams_kernelized(jnp.asarray(D), method).merges)
    serial = np.asarray(lance_williams(D, method).merges)
    return D, (kernel, serial, naive_lw(D, method))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", (40, 97))
@pytest.mark.parametrize("stop_at_k", (1, 9))
def test_full_run_matches_reference_engines(method, n, stop_at_k):
    D, references = reference_run(method, n)
    res = ops.lance_williams_kernelized(D, method, stop_at_k=stop_at_k, device="cpu")
    got = res.merges.numpy()
    assert res.n_merges == got.shape[0] == n - stop_at_k
    for want in references:
        assert_merges_match(got, want[: n - stop_at_k])
    if stop_at_k == 1:
        validate_merges(got)


def test_nothing_to_merge_and_input_untouched(rng):
    D = random_distance_matrix(rng, 12).astype(np.float32)
    copy = D.copy()
    res = ops.lance_williams_kernelized(D, stop_at_k=12, device="cpu")
    assert res.merges.shape == (0, 4) and res.n_merges == 0
    ops.lance_williams_kernelized(D, device="cpu")
    np.testing.assert_array_equal(D, copy)    # the loop works on its own copy


def test_to_numpy_round_trip(rng):
    n = 8
    D = random_distance_matrix(rng, n).astype(np.float32)
    alive = np.ones(n, bool)
    state = convert.lwstate_from_numpy(D, alive, alive.astype(np.float32),
                                       np.zeros((n - 1, 4)), 0, (1, 2, 0.5), device="cpu")
    back = convert.to_numpy(state)
    assert type(back) is engine.LWState
    np.testing.assert_array_equal(back.D, D)
    assert back.alive.dtype == bool and back.n_merges == 0
    assert (int(back.cand[0]), int(back.cand[1]), float(back.cand[2])) == (1, 2, 0.5)
