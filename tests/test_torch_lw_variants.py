"""The LW loop's serial backend, its ``rowmin``/``lazy`` variants and
``distance_threshold`` vs the JAX package, and the row update (kernel B3's
plain version) vs the Pallas kernel in interpret mode.

Contract (as in ``tests/test_kernels.py``): merge slots equal, heights
within rtol 1e-4 / atol 1e-5, sizes equal; the row update within rtol
1e-5.  The JAX references run at ``compaction=False``: the merges are the
same as staged, with one compile.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.lance_williams import lance_williams as jlance_williams  # noqa: E402
from repro.core.lance_williams import (  # noqa: E402
    lance_williams_from_points as jlance_williams_from_points,
)
from repro.core.linkage import METHODS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import VARIANTS  # noqa: E402
from repro_torch.core.lance_williams import lance_williams, lance_williams_from_points  # noqa: E402
from repro_torch.core.naive import definition_oracle, naive_lw  # noqa: E402
from repro_torch.kernels import lw_update  # noqa: E402
from repro_torch.kernels.ops import lance_williams_kernelized  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402
from tests.test_torch_cuda import lw_update_args, step_problem  # noqa: E402
from tests.test_torch_engine import assert_merges_match  # noqa: E402


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

GEOMETRIC = ("centroid", "median", "ward")
PORT = {"serial": lance_williams, "kernel": lance_williams_kernelized}


@functools.cache
def problem(method: str, n: int = 40) -> np.ndarray:
    rng = np.random.default_rng([n, METHODS.index(method), 14])
    return random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)


@functools.cache
def reference(backend: str, method: str, variant: str, n: int = 40, thr=None):
    """The JAX package's merges and merge count on ``problem(method, n)``."""
    D = problem(method, n)
    if backend == "serial":
        res = jlance_williams(D, method, variant=variant, distance_threshold=thr,
                              compaction=False)
    else:
        res = jops.lance_williams_kernelized(jnp.asarray(D), method, variant=variant,
                                             distance_threshold=thr, compaction=False)
    return np.asarray(res.merges), int(res.n_merges)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_serial_matches_reference(method, variant):
    want, _ = reference("serial", method, variant)
    res = lance_williams(problem(method), method, variant=variant, device="cpu")
    assert res.n_merges == 39
    assert_merges_match(res.merges.numpy(), want)


@pytest.mark.parametrize("method", METHODS)
def test_serial_matches_naive(method):
    D = problem(method, 30)
    got = lance_williams(D, method, variant="lazy", device="cpu").merges.numpy()
    assert_merges_match(got, naive_lw(D, method))


@pytest.mark.parametrize("method", ("single", "complete", "average", "centroid", "ward"))
def test_serial_matches_definition_oracle(method, rng):
    """Each merge from the linkage's definition (no recurrence at all)."""
    X = rng.normal(size=(16, 3))
    D = ((X[:, None] - X[None]) ** 2).sum(-1)
    if method not in ("centroid", "ward"):
        D = np.sqrt(D)
    got = lance_williams(D, method, variant="rowmin", device="cpu").merges.numpy()
    assert_merges_match(got, definition_oracle(D, method, X=X))


@pytest.mark.parametrize("method,variant", [("complete", "baseline"), ("ward", "lazy")])
def test_from_points_matches_reference(method, variant, rng):
    X = rng.normal(size=(50, 6)).astype(np.float32)
    want = np.asarray(jlance_williams_from_points(X, method, variant=variant, stop_at_k=3).merges)
    res = lance_williams_from_points(X, method, variant=variant, stop_at_k=3, device="cpu")
    assert res.n_merges == 47
    assert_merges_match(res.merges.numpy(), want)


@pytest.mark.parametrize("method", ("single", "complete", "centroid", "ward"))
@pytest.mark.parametrize("variant", ("rowmin", "lazy"))
def test_kernel_variants_match_reference(method, variant):
    want, _ = reference("kernel", method, variant)
    res = lance_williams_kernelized(problem(method), method, variant=variant, device="cpu")
    assert res.n_merges == 39
    assert_merges_match(res.merges.numpy(), want)


THRESHOLDS = ("on a merge height", "a float64 hair under a height", "between two heights",
              "below the first", "above the last")


@pytest.mark.parametrize("backend", ("serial", "kernel"))
@pytest.mark.parametrize("variant", ("baseline", "lazy"))
@pytest.mark.parametrize("where", THRESHOLDS)
def test_distance_threshold_matches_reference(backend, variant, where):
    """A threshold stops before the first merge above ``float32(threshold)``.
    Complete linkage: its heights are bit-equal in both packages, so a
    threshold on a height is on it in both; one a float64 hair under a
    height rounds onto it in float32."""
    h = reference("serial", "complete", "baseline", 60)[0][:, 2]
    thr = {"on a merge height": h[30], "a float64 hair under a height": float(h[30]) - 1e-9,
           "between two heights": (h[30] + h[31]) / 2,
           "below the first": h[0] / 2, "above the last": 2 * h[-1]}[where]
    want, n_want = reference(backend, "complete", "baseline", 60, float(thr))
    res = PORT[backend](problem("complete", 60), "complete", variant=variant,
                        distance_threshold=float(thr), device="cpu")
    assert res.n_merges == n_want == int(np.sum(h <= np.float32(thr)))
    assert_merges_match(res.merges.numpy(), want)          # rows past the stop are zero


def test_distance_threshold_checked_between_chunks(monkeypatch):
    """A stop in the middle of a check chunk, and on its last trip."""
    full = lance_williams(problem("average", 60), "average", device="cpu").merges.numpy()
    monkeypatch.setattr(engine, "THRESHOLD_CHECK_TRIPS", 8)
    for t in (20, 23):        # chunks [16, 24): mid-chunk, and the chunk's last trip
        thr = float(full[t, 2])
        k = int(np.argmax(full[:, 2] > np.float32(thr)))
        res = lance_williams(problem("average", 60), "average", distance_threshold=thr,
                             device="cpu")
        assert res.n_merges == k > t
        np.testing.assert_array_equal(res.merges.numpy()[:k], full[:k])
        assert not res.merges.numpy()[k:].any()


@pytest.mark.parametrize("backend", ("serial", "kernel"))
def test_variant_ties_duplicate_points(backend, rng):
    """Exact-zero ties (duplicate points) keep the cached argmin's row-major
    first-minimum tie-breaking (the reference's tie case)."""
    X = rng.normal(size=(14, 3))
    X[4] = X[0]
    X[9] = X[2]
    X[10] = X[2]
    D = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    base = np.asarray(jlance_williams(D, "single").merges)
    for variant in VARIANTS:
        got = PORT[backend](D, "single", variant=variant, device="cpu").merges.numpy()
        assert_merges_match(got, base)


@pytest.mark.parametrize("backend", ("serial", "kernel"))
@pytest.mark.parametrize("method", ("average", "ward"))
def test_one_lazy_step_from_shared_state(backend, method, rng):
    """Both engines resume from the same mid-run ``lazy`` state, cache
    included, and take one step: the refresh's invalidation and drain."""
    n, t = 128, 5
    D = random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)
    alive = rng.random(n) > 0.25
    alive[:2] = True
    sizes = np.where(alive, rng.integers(1, 5, n), 0).astype(np.float32)
    merges = np.zeros((n - 1, 4), np.float32)
    merges[:t] = rng.random((t, 4))

    if backend == "serial":
        jops_ = jengine.dense_ops(method, n, "lazy")
        D = np.asarray(jengine.premask(jnp.asarray(D), jnp.asarray(alive)))
        ops = engine.dense_ops(method, n, "lazy", "cpu")
    else:
        jops_ = jengine.kernel_ops(method, n, "lazy", block_m=128, interpret=True)
        ops = engine.kernel_ops(method, n, "lazy", "cpu")
    zero = jnp.zeros((), jnp.int32)
    jstate = jops_.seed(jengine.LWState(
        D=jnp.asarray(D), alive=jnp.asarray(alive), sizes=jnp.asarray(sizes),
        merges=jnp.asarray(merges), n_merges=jnp.int32(t),
        cand=(zero, zero, jnp.float32(0)), cache=jengine._dense_cache(n, "lazy"),
    ))
    jnext = jax.jit(jengine.make_step(jops_))(jstate)

    state = convert.lwstate_from_numpy(
        *(np.asarray(x) for x in jstate[:5]), tuple(np.asarray(x) for x in jstate.cand),
        cache=tuple(np.asarray(x) for x in jstate.cache), device="cpu",
    )
    nxt = convert.to_numpy(engine.make_step(ops)(state))

    assert nxt.n_merges == int(jnext.n_merges) == t + 1
    np.testing.assert_allclose(nxt.D, np.asarray(jnext.D), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nxt.alive, np.asarray(jnext.alive))
    np.testing.assert_array_equal(nxt.sizes, np.asarray(jnext.sizes))
    assert_merges_match(nxt.merges, np.asarray(jnext.merges))
    np.testing.assert_allclose(nxt.cache[0], np.asarray(jnext.cache[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nxt.cache[1], np.asarray(jnext.cache[1]))
    assert [int(x) for x in nxt.cand[:2]] == [int(x) for x in jnext.cand[:2]]
    np.testing.assert_allclose(nxt.cand[2], np.asarray(jnext.cand[2]), rtol=1e-5)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", (200, 513))
def test_lw_update_matches_pallas(method, n, rng):
    """The row update against the reference oracle and the Pallas kernel
    (interpret mode), with the reference sweep's inputs."""
    d_ki = np.abs(rng.normal(size=n)).astype(np.float32)
    d_kj = np.abs(rng.normal(size=n)).astype(np.float32)
    sizes = rng.integers(1, 6, n).astype(np.float32)
    keep = rng.random(n) > 0.25
    want_ref = np.asarray(ref.ref_lw_update(method, d_ki, d_kj, 0.41, 2.0, 5.0, sizes, keep))
    want_kernel = np.asarray(jops.lw_update(method, jnp.asarray(d_ki), jnp.asarray(d_kj),
                                            0.41, 2.0, 5.0, jnp.asarray(sizes),
                                            jnp.asarray(keep)))

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype)

    got = lw_update.lw_update(method, t(d_ki), t(d_kj), t([0.41]), t([2.0]), t([5.0]),
                              t(sizes), t(keep, torch.bool)).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-6)
    assert (got[~keep] == 0).all()


def test_lw_update_cpu_takes_plain_and_checks_method(rng):
    D, alive, sizes, i, j = step_problem(rng, 32, "ward")
    args = lw_update_args(D, alive, sizes, i, j)
    before = lw_update.lw_update.launches
    np.testing.assert_array_equal(lw_update.lw_update("ward", *args).numpy(),
                                  lw_update.lw_update_plain("ward", *args).numpy())
    assert lw_update.lw_update.launches == before          # no kernel on the CPU
    with pytest.raises(ValueError, match="unknown linkage method"):
        lw_update.lw_update("nope", *args)


@pytest.mark.parametrize("fn", (lance_williams, lance_williams_kernelized))
def test_engine_knobs_checked(fn, rng):
    D = random_distance_matrix(rng, 6)
    with pytest.raises(ValueError, match="unknown variant"):
        fn(D, variant="nope", device="cpu")
    staged = fn(D, compaction=True, device="cpu")
    assert torch.equal(staged.merges, fn(D, compaction=False, device="cpu").merges)
    copy = D.copy()
    assert fn(D, stop_at_k=6, device="cpu").n_merges == 0
    fn(D, variant="lazy", device="cpu")
    np.testing.assert_array_equal(D, copy)    # the loop works on its own copy
