"""Port kernels vs the Pallas kernels: the min-scan seed (B1) and its
batch form, the fused merge step (B2) and the pairwise distance build (B4,
through ``ops.pairwise``); and B1's batch plan.

On the CPU the port's wrappers take the plain torch versions, which are
held against the JAX package's kernels run as ``tests/test_kernels.py``
runs them (interpret mode).  The CUDA kernels against their plain
versions on the card are in ``test_torch_cuda.py``, which needs no jax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.linkage import METHODS  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.lw_step import lw_step_pallas  # noqa: E402
from repro_torch.core.batched import BUCKETS  # noqa: E402
from repro_torch.core.distance import count_distance_queries  # noqa: E402
from repro_torch.kernels._build import MAX_CLUSTER  # noqa: E402
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


@pytest.mark.parametrize("n", (16, 130))
def test_masked_argmin_batch_matches_jax_vmap(n, rng):
    """The batch form (its plain twin on the CPU) against ``jax.vmap`` of the
    JAX package's ``ops.masked_argmin`` (the Pallas kernel in interpret
    mode): a live prefix, scattered slots, no live slot, one live slot and
    a minimum tied across two rows (the earlier row wins); equal values and
    equal flat indices."""
    B = 5
    D = np.stack([random_distance_matrix(rng, n) for _ in range(B)]).astype(np.float32)
    alive = np.zeros((B, n), bool)
    alive[0, :n - 3] = True                    # a live prefix, as a stage's seed finds it
    alive[1] = rng.random(n) > 0.4             # scattered
    alive[1, :2] = True
    alive[3, n // 2] = True                    # one live slot: no live cell; lane 2 has none
    alive[4] = True
    D[4, 3, 10] = D[4, 10, 3] = D[4, 7, 12] = D[4, 12, 7] = -1.0   # the tie: (3, 10) wins
    vj, fj = jax.vmap(ops.masked_argmin)(jnp.asarray(D), jnp.asarray(alive))
    vt, ft = minscan.masked_argmin_batch(torch.from_numpy(D), torch.from_numpy(alive))
    assert vt.dtype == torch.float32 and ft.dtype == torch.int64 and vt.shape == ft.shape == (B,)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert np.isinf(vt.numpy()[2:4]).all() and (ft.numpy()[2:4] == 0).all()
    assert int(ft[4]) == 3 * n + 10


def live_ranges(alive_row: np.ndarray, blocks: int) -> list:
    """The rows each block of a lane's cluster scans in the batch kernel
    (argmin_batch.cu): rank k takes the rows from its share's first live row
    to the next rank's, clamped to the live span."""
    live = np.flatnonzero(alive_row)
    n = len(alive_row)
    if not len(live):
        return [range(0) for _ in range(blocks)]

    def row_of_live(t):
        return int(live[t]) if t < len(live) else n

    out = []
    for k in range(blocks):
        first = 0 if k == 0 else row_of_live(k * len(live) // blocks)
        last = n if k + 1 == blocks else row_of_live((k + 1) * len(live) // blocks)
        out.append(range(max(first, int(live[0])), min(last, int(live[-1]) + 1)))
    return out


# the plans argmin_batch.cu instantiates (argmin_kernel): (group, unroll, threads), and whether
# a cluster may own a lane under it
ARGMIN_KERNELS = {(0, 4, 128): False, (0, 1, 128): False, (4, 0, 256): True, (8, 0, 256): True,
                  (16, 0, 256): True, (32, 0, 256): True, (32, 0, 512): True,
                  (32, 8, 256): True, (4, 4, 256): False, (4, 8, 512): True, (8, 8, 512): True}


@pytest.mark.parametrize("lanes", (1, 2, 3, 7, 64, 66, 133, 256, 1024, 4096))
def test_argmin_batch_plan(lanes, rng):
    """B1's batch plan over the bucket grid and odd sizes: a warp a lane up
    to 32 slots (float4 loads on aligned rows); one pass of 512 threads in
    registers from 65 to 128 slots, and up to 256 where a cluster owns the
    lane or rows are not aligned; else B2's batch rule; bulk copies only on
    aligned rows of more than 128 slots; a cluster only past 128 slots, of
    a power of two up to MAX_CLUSTER blocks; every plan one the kernel
    instantiates; and a cluster's blocks own every live row of a lane once,
    on a prefix and on a scattered state."""
    for n in sorted({*BUCKETS, 17, 33, 127, 255, 300, 1023, 4095}):
        for aligned in (True, False):
            plan = minscan.argmin_batch_plan(lanes, n, 132, aligned)
            assert plan.blocks in {1 << k for k in range(MAX_CLUSTER.bit_length())}
            assert plan.blocks <= MAX_CLUSTER and (plan.blocks == 1 or n > 128)
            if n <= minscan.WARP_LANE_MAX_N:
                assert plan == (0, 4 if aligned and n % 4 == 0 else 1, 128, 1)
                continue
            b2 = lw_step.merge_batch_plan(lanes, n, 132, aligned)
            assert plan.blocks == b2.blocks
            if 64 < n <= 256 and (n <= 128 or b2.blocks > 1 or b2.unroll != 0):
                assert plan == (4 if n <= 128 else 8, 8, 512, b2.blocks)
            else:
                assert tuple(plan) == tuple(b2)
            assert (plan.unroll == 0) == (aligned and n % 4 == 0 and n > 128 and
                                          (n > 256 or plan.blocks == 1))
            cluster_ok = ARGMIN_KERNELS.get(plan[:3])
            assert cluster_ok is not None and (plan.blocks == 1 or cluster_ok), plan
            for alive_row in (np.arange(n) < n - n // 3, rng.random(n) > 0.4):
                owned = [r for rows in live_ranges(alive_row, plan.blocks) for r in rows
                         if alive_row[r]]
                assert owned == list(np.flatnonzero(alive_row)), (n, plan)
    with pytest.raises(ValueError, match="lanes and slots"):
        minscan.argmin_batch_plan(0, 16)


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
