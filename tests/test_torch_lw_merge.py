"""The kernel backend's device-resident merge (kernel B2's ``lw_merge``
entry, through its plain twin on the CPU) against the per-row step composed
in torch and against the JAX package's kernel engine.

Contracts: bit for bit against the per-row composition (copies of rows
``i`` and ``j``, the per-row step ``lw_step_plain``, then the first row
attaining the minimum and its first column, and the bookkeeping, one torch
op at a time); index-identical to the JAX kernel engine run in interpret mode,
with heights within rtol 1e-4 / atol 1e-5 (``tests/test_kernels.py``'s
contract).  The kernel against its plain twin on the card is in
``test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.linkage import METHODS  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.batched import BUCKETS  # noqa: E402
from repro_torch.kernels import lw_step, lw_update, minscan  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402
from tests.test_torch_cuda import merge_problem  # noqa: E402
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
N = 256          # two 128-row slabs of the reference kernels
CASES = ("full", "stop_at_k", "threshold")


@functools.cache
def problem(method: str, data: str):
    """A matrix of N slots with 37 dead from the start: ``random`` distances,
    or ``ties``, small integers that tie all over the matrix."""
    rng = np.random.default_rng([N, METHODS.index(method), data == "ties"])
    if data == "ties":
        A = rng.integers(1, 6, (N, N)).astype(np.float32)
        D = np.triu(A, 1) + np.triu(A, 1).T
    else:
        D = random_distance_matrix(rng, N, squared=method in GEOMETRIC).astype(np.float32)
    alive = np.ones(N, bool)
    alive[rng.choice(N, 37, replace=False)] = False
    return D, alive


#: Where the compiled reference rounds the recurrence otherwise: XLA fuses
#: centroid's and ward's multiply-adds (an ulp apart from rounding each
#: operation, which the port and the JAX package run op by op both do), and
#: on tie-dense integers that ulp reorders tied merges.
FUSED_ROUNDING = {("ties", "centroid"), ("ties", "ward")}


@functools.cache
def reference(method: str, data: str):
    """The JAX kernel engine's full run on ``problem`` (Pallas in interpret
    mode): a run stopped early records a prefix of these merges.  In
    :data:`FUSED_ROUNDING`, the JAX serial engine run op by op instead."""
    D, alive = problem(method, data)
    n_steps = int(alive.sum()) - 1
    if (data, method) in FUSED_ROUNDING:
        with jax.disable_jit():
            out = jengine.run_dense(jnp.asarray(D), jnp.asarray(alive), method=method,
                                    n_steps=n_steps)
    else:
        out = jengine.run_kernel(jnp.asarray(D), jnp.asarray(alive), method=method,
                                 n_steps=n_steps, block_m=128, interpret=True)
    return np.asarray(out.merges)


def per_row_composition(method, D, alive, n_steps, distance_threshold=None):
    """The per-row step composed with the selection and the bookkeeping in
    torch, step for step, on state it allocates anew each step; a threshold
    trims the merges from the first one above it."""
    n = D.shape[0]
    v, flat = minscan.masked_argmin_plain(D, alive)
    r, c, dmin = flat // n, flat % n, v
    sizes = alive.to(torch.float32)
    merges = torch.zeros((n_steps, 4))
    for t in range(n_steps):
        ij = torch.stack((torch.minimum(r, c), torch.maximum(r, c)))
        rows = D.index_select(0, ij)
        n_ij = sizes.index_select(0, ij)
        new_size = n_ij.sum()
        merges[t] = torch.cat((ij.to(torch.float32), dmin.reshape(1), new_size.reshape(1)))
        D, rmin, rarg = lw_step.lw_step_plain(method, D, rows[0], rows[1], dmin, n_ij[0],
                                              n_ij[1], sizes, alive, ij[0], ij[1])
        alive = alive.index_fill(0, ij[1:], False)
        sizes = sizes.index_fill(0, ij[1:], 0.0).index_put_((ij[:1],), new_size.reshape(1))
        dmin, r = torch.min(rmin, dim=0)
        c = rarg.index_select(0, r.reshape(1)).reshape(())
    if distance_threshold is not None:
        over = np.flatnonzero(~(merges[:, 2].numpy() <= np.float32(distance_threshold)))
        if over.size:
            merges[int(over[0]):] = 0.0
    return merges, D


def run_resident(method, D, alive, n_steps, distance_threshold=None):
    """The engine's kernel backend on the CPU: the resident merge's plain twin."""
    out = engine.run_merge_loop(engine.kernel_ops(method, D.shape[0], device="cpu"),
                                engine._init_state(D, alive, n_steps), n_steps,
                                distance_threshold)
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("data", ("random", "ties"))
@pytest.mark.parametrize("case", CASES)
def test_resident_merge_matches_per_row_step_and_reference(method, data, case):
    """Dead slots from the start; ``stop_at_k`` 9; a threshold at merge 170
    of 218, which the check after the second chunk of 128 finds."""
    D, alive = problem(method, data)
    full = reference(method, data)
    n_steps = int(alive.sum()) - (9 if case == "stop_at_k" else 1)
    assert n_steps % engine.THRESHOLD_CHECK_TRIPS != 0
    thr = float(full[170, 2]) if case == "threshold" else None
    over = [] if thr is None else np.flatnonzero(~(full[:n_steps, 2] <= np.float32(thr)))
    k = int(over[0]) if len(over) else n_steps
    if thr is not None and data == "random" and method not in ("centroid", "median"):   # monotone
        assert engine.THRESHOLD_CHECK_TRIPS < k < n_steps

    out = run_resident(method, torch.tensor(D), torch.tensor(alive), n_steps, thr)
    want, D_want = per_row_composition(method, torch.tensor(D), torch.tensor(alive), n_steps, thr)
    assert out.n_merges == k
    assert torch.equal(out.merges, want)             # bit for bit, zeros past a stop included
    if thr is None:
        assert torch.equal(out.D, D_want)
    assert_merges_match(out.merges.numpy()[:k], full[:k])


@pytest.mark.parametrize("method", ("single", "average", "ward"))
def test_matrix_stays_exactly_symmetric(method):
    """``symmetrize`` gives an exactly symmetric matrix, and every merge
    keeps it so, dead rows and columns included: the kernel reads rows i
    and j from ``D`` itself on that invariant."""
    rng = np.random.default_rng(7)
    D = engine.symmetrize(torch.tensor(np.triu(rng.random((90, 90)), 1).astype(np.float32)))
    assert torch.equal(D, D.T)
    alive = torch.ones(90, dtype=torch.bool)
    alive[[3, 50]] = False
    state = engine.kernel_ops(method, 90).seed(engine._init_state(D, alive, 80))
    step = engine.make_step(engine.kernel_ops(method, 90))
    for t in range(80):
        state = step(state, t)
        assert torch.equal(state.D, state.D.T), t
    assert int(state.cache.count) == state.n_merges == 80


@pytest.mark.parametrize("method", METHODS)
def test_lw_merge_plain_is_one_per_row_step(method, rng):
    """One merge from a mid-run state: the buffers the plain twin leaves
    hold one per-row step, its record and bookkeeping, and the next
    candidate from its per-row minima."""
    b = merge_problem(rng, 64, method)
    D0, alive0, sizes0 = b.D.clone(), b.alive.clone(), b.sizes.clone()
    r, c = (int(x) for x in b.cand)
    i, j = min(r, c), max(r, c)
    _, rmin, rarg = lw_step.lw_step_plain(method, D0, D0[i].clone(), D0[j].clone(), b.dmin[0],
                                          sizes0[i], sizes0[j], sizes0, alive0,
                                          torch.tensor(i), torch.tensor(j))
    dmin = b.dmin.clone()
    lw_step.lw_merge(method, b)                       # a CPU tensor: the plain twin
    assert torch.equal(b.D, D0) and torch.equal(b.rmin, rmin) and torch.equal(b.rarg, rarg)
    assert b.merges[0].tolist() == [i, j, float(dmin), float(sizes0[i] + sizes0[j])]
    assert b.merges[1:].abs().sum() == 0 and int(b.count) == 1
    assert not b.alive[j] and int(b.alive.sum()) == int(alive0.sum()) - 1
    assert float(b.sizes[j]) == 0.0 and float(b.sizes[i]) == float(sizes0[i] + sizes0[j])
    assert torch.equal(b.bits, lw_step.alive_bits(b.alive))
    m, r_next = torch.min(rmin, 0)
    assert (int(b.cand[0]), int(b.cand[1])) == (int(r_next), int(rarg[r_next]))
    assert torch.equal(b.dmin, m.reshape(1))


@pytest.mark.parametrize("n", (1, 31, 32, 33, 100))
def test_alive_bits(n, rng):
    alive = torch.tensor(rng.random(n) > 0.4)
    words = lw_step.alive_bits(alive)
    assert words.dtype == torch.int32 and words.shape == (-(-n // 32),)
    got = [(int(words[c // 32]) >> (c % 32)) & 1 for c in range(n)]
    assert got == alive.to(torch.int64).tolist()


def test_last_merge_leaves_an_unused_candidate(rng):
    """After the last merge every row minimum is +inf: the candidate is
    (0, 0, +inf), as torch.min gives it, and it is never used."""
    b = merge_problem(rng, 12, "complete", dead=0.0)
    total = float(b.sizes.sum())
    for _ in range(11):
        lw_step.lw_merge("complete", b)
    assert torch.isinf(b.rmin).all() and (b.rarg == 0).all()
    assert (int(b.cand[0]), int(b.cand[1]), float(b.dmin)) == (0, 0, float("inf"))
    assert int(b.alive.sum()) == 1 and float(b.sizes.max()) == total


def test_lw_merge_rejects_bad_operands(rng):
    """As ``lw_step`` does, and on the CPU too: the buffers' types and
    shapes are checked before either version runs."""
    b = merge_problem(rng, 40, "complete")
    with pytest.raises(ValueError, match="unknown linkage method"):
        lw_step.lw_merge("nope", b)
    with pytest.raises(ValueError, match="square"):
        lw_step.lw_merge("complete", b._replace(D=b.D[:, :39]))
    with pytest.raises(ValueError, match="operand"):
        lw_step.lw_merge("complete", b._replace(rarg=b.rarg.to(torch.int32)))
    with pytest.raises(ValueError, match="operand"):
        lw_step.lw_merge("complete", b._replace(bits=b.bits[:1]))
    with pytest.raises(ValueError, match=r"\(cap, 4\)"):
        lw_step.lw_merge("complete", b._replace(merges=torch.zeros(40, 3)))
    with pytest.raises(ValueError, match="operand"):
        lw_step.lw_merge("complete", b._replace(cand=b.cand[:1]))
    before = lw_step.lw_merge.launches
    lw_step.lw_merge("complete", b)
    assert lw_step.lw_merge.launches == before        # no kernel on the CPU


# ---------------------------------------------------------------------------
# the batch form's launch plan (kernels/lw_step.py merge_batch_plan)
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("lanes", (1, 3, 64, 256, 4096))
@pytest.mark.parametrize("n", BUCKETS)
def test_merge_batch_plan_owns_every_lane_once(lanes, n):
    """Every bucket's plan: each lane owned by one block or one cluster of
    at most 8 blocks (block x is rank x % k of lane x // k), each of a
    cluster's blocks given at least a bitmask word of rows, the fewest
    blocks that cover the card's SMs, a grid within CUDA's limits; rows of
    128 slots and more bulk-copied, whole into a 4 KiB buffer a warp or in
    chunks that fill it, and shorter rows in one pass of registers, every
    thread of a row group on a float4 from bucket 16 on."""
    plan = lw_step.merge_batch_plan(lanes, n, H100_SMS)
    k = plan.blocks
    assert 1 <= k <= lw_step.MAX_CLUSTER and k & (k - 1) == 0
    assert lanes * k <= 2**31 - 1
    assert plan.group in (4, 8, 16, 32) and plan.threads % plan.group == 0
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    owners = {}
    for block in range(lanes * k):
        owners.setdefault(block // k, []).append(block % k)
    assert sorted(owners) == list(range(lanes))
    assert all(ranks == list(range(k)) for ranks in owners.values())
    if n >= 128:
        assert plan.unroll == 0 and plan.threads == (512 if n > 1024 else 256)
        assert 32 * plan.group >= min(n, 1024)               # a row, or a chunk, a group
        assert 32 * plan.group <= max(2 * n, 128)            # no thread without a float4
    else:
        assert k == 1 and plan.group == 4 and 4 * plan.group * plan.unroll >= n
        assert plan.group * plan.unroll * 4 <= max(2 * n, 16)
        assert plan.threads <= max(plan.group * n, 32)
    if n <= 128:
        assert k == 1
    else:   # the fewest blocks whose warps give each scheduler (4 an SM) one
        warps = plan.threads // 32
        assert 32 * k <= n
        assert k == 1 or lanes * (k // 2) * warps < 4 * H100_SMS
        assert k == lw_step.MAX_CLUSTER or lanes * k * warps >= 4 * H100_SMS or 64 * k > n


@pytest.mark.parametrize("n", (97, 129, 1023, 4094))
def test_merge_batch_plan_keeps_unaligned_rows_in_registers(n):
    """Rows that are not 16-byte aligned (n % 4 != 0, or a matrix that
    starts off a 16-byte boundary) cannot be bulk-copied: they are read
    into registers, a warp a row where they are long."""
    plan = lw_step.merge_batch_plan(8, n, H100_SMS)
    assert plan.unroll > 0 and plan.group == (4 if n <= 128 else 32)
    assert (lw_step.merge_batch_plan(8, 1024, H100_SMS, aligned=False)
            == lw_step.BatchPlan(32, 8, 256, 8))


def test_merge_batch_plan_follows_the_card():
    """The cluster grows as lanes fall, and on a card of fewer SMs sooner."""
    assert [lw_step.merge_batch_plan(b, 1024, H100_SMS).blocks
            for b in (256, 66, 65, 33, 32, 17, 16, 1)] == [1, 1, 2, 2, 4, 4, 8, 8]
    assert lw_step.merge_batch_plan(64, 512, 114).blocks == 1
    assert lw_step.merge_batch_plan(64, 512, H100_SMS).blocks == 2
    with pytest.raises(ValueError, match="lanes and slots"):
        lw_step.merge_batch_plan(0, 16)


# ---------------------------------------------------------------------------
# B3's batch form's launch plan (kernels/lw_update.py lazy_batch_plan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", (1, 3, 64, 256, 4096))
@pytest.mark.parametrize("n", (*BUCKETS, 300, 8192))
def test_lazy_batch_plan_owns_every_lane_once(lanes, n):
    """Every bucket's plan (and an unaligned n, and rows longer than any
    bucket): each lane owned by one block or one cluster of at most 8 blocks
    (block x is rank x % k of lane x // k), a grid within CUDA's limits; a
    stale row rescanned in one pass of a float4 a thread by n / 4 threads up
    to n = 64, by a warp above; a block a lane up to n = 1024, and above the
    largest cluster whose blocks each have an SM of their own."""
    plan = lw_update.lazy_batch_plan(lanes, n, H100_SMS)
    k = plan.blocks
    assert 1 <= k <= lw_step.MAX_CLUSTER and k & (k - 1) == 0
    assert lanes * k <= 2**31 - 1
    assert plan.group in (4, 8, 16, 32) and plan.threads % plan.group == 0
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    owners = {}
    for block in range(lanes * k):
        owners.setdefault(block // k, []).append(block % k)
    assert sorted(owners) == list(range(lanes))
    assert all(ranks == list(range(k)) for ranks in owners.values())
    if plan.group < 32:
        assert 4 * plan.group >= n and (plan.group == 4 or 2 * plan.group < n)   # one pass
    else:
        assert n > 64
    if n <= 128:
        assert plan.threads <= max(n, 32)
    else:
        assert plan.threads == 256
    if n <= 1024:
        assert k == 1 and 4 * plan.threads >= n           # one pass of the update
    else:
        assert k == 1 or lanes * k <= H100_SMS              # doubled from k / 2
        assert k == lw_step.MAX_CLUSTER or 2 * lanes * k > H100_SMS


def test_lazy_batch_plan_follows_the_card():
    """The cluster grows as lanes fall, for rows past 1024 slots only, and
    on a card of fewer SMs it stops sooner."""
    assert [lw_update.lazy_batch_plan(b, 2048, H100_SMS).blocks
            for b in (256, 67, 66, 33, 17, 16, 1)] == [1, 1, 2, 4, 4, 8, 8]
    assert lw_update.lazy_batch_plan(1, 1024, H100_SMS).blocks == 1
    assert lw_update.lazy_batch_plan(64, 2048, 114).blocks == 1
    assert lw_update.lazy_batch_plan(64, 2048, H100_SMS).blocks == 2
    assert str(lw_update.lazy_batch_plan(16, 2048, H100_SMS)) == (
        "a cluster of 8 a lane, 32 threads a stale row, 256 a block")
    with pytest.raises(ValueError, match="lanes and slots"):
        lw_update.lazy_batch_plan(3, 0)
