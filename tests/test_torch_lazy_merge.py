"""The kernel backend's device-resident ``lazy`` merge (kernel B3's
``lazy_merge`` entry, through its plain twin on the CPU) against the
host-driven ``lazy`` loop and against the JAX package's kernel ``lazy`` run.

Contracts: bit for bit against the host-driven loop, merge after merge
(the matrix, the record, liveness, sizes, the cached row minima and the
candidate); index-identical to the JAX kernel engine run in interpret mode,
with heights within rtol 1e-4 / atol 1e-5 (``tests/test_kernels.py``'s
contract).  The kernels against their plain twins on the card are in
``test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.linkage import METHODS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import lw_update  # noqa: E402
from tests.conftest import random_distance_matrix  # noqa: E402
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


@functools.cache
def problem(method: str, n: int, data: str = "random", dead: int = 0):
    """A matrix of ``n`` slots with ``dead`` dead from the start: ``random``
    distances, or ``ties``, small integers that tie all over the matrix."""
    rng = np.random.default_rng([n, METHODS.index(method), data == "ties", dead])
    if data == "ties":
        A = rng.integers(1, 6, (n, n)).astype(np.float32)
        D = np.triu(A, 1) + np.triu(A, 1).T
    else:
        D = random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)
    alive = np.ones(n, bool)
    alive[rng.choice(n, dead, replace=False)] = False
    return D, alive


def run(ops, D, alive, n_steps, distance_threshold=None):
    out = engine.run_merge_loop(ops, engine._init_state(torch.tensor(D), torch.tensor(alive),
                                                        n_steps), n_steps, distance_threshold)
    return engine.LWResult(merges=out.merges, n_merges=out.n_merges), out


def host_ops(method, n):
    return engine._lazy_ops(method, n, lw_update.lw_update, "cpu")


def resident_ops(method, n):
    return engine._lazy_resident_ops(method, n, lw_update.lazy_merge)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,data,dead", [(97, "random", 11), (130, "ties", 0), (64, "random", 0)])
def test_resident_merges_equal_host_loop_merge_by_merge(method, n, data, dead):
    """Ragged n, slots dead from the start and tie-dense integers: after
    every merge both loops hold the same state, bit for bit."""
    D, alive = problem(method, n, data, dead)
    n_steps = int(alive.sum()) - 1
    host, res = host_ops(method, n), resident_ops(method, n)
    hs = host.seed(engine._init_state(torch.tensor(D), torch.tensor(alive), n_steps))
    rs = res.seed(engine._init_state(torch.tensor(D), torch.tensor(alive), n_steps))
    h_step, r_step = engine.make_step(host), engine.make_step(res)
    rescanned = 0
    for t in range(n_steps):
        hs, rs = h_step(hs, t), r_step(rs, t)
        b = rs.cache
        assert isinstance(b, lw_update.LazyBuffers)
        for name, got, want in (("D", b.D, hs.D), ("alive", b.alive, hs.alive),
                                ("sizes", b.sizes, hs.sizes), ("merges", b.merges, hs.merges),
                                ("rmin", b.rmin, hs.cache[0]), ("rarg", b.rarg, hs.cache[1])):
            assert torch.equal(got, want), (t, name)
        assert [int(b.cand[0]), int(b.cand[1])] == [int(hs.cand[0]), int(hs.cand[1])], t
        assert torch.equal(b.dmin[0], hs.cand[2]), t
        assert int(b.count) == t + 1 and int(b.n_stale) == 0
        assert int(b.rescanned) >= rescanned
        rescanned = int(b.rescanned)


@pytest.mark.parametrize("method", ("single", "average", "centroid", "ward"))
@pytest.mark.parametrize("case", ("stop_at_k", "threshold"))
def test_resident_stops_as_host_loop(method, case):
    """``stop_at_k`` shrinks the trip count; a threshold after the second
    chunk of THRESHOLD_CHECK_TRIPS merges stops both loops at one merge,
    zeros past it."""
    D, alive = problem(method, N, "random", 37)
    live = int(alive.sum())
    n_steps = live - (9 if case == "stop_at_k" else 1)
    thr = None
    if case == "threshold":
        full, _ = run(host_ops(method, N), D, alive, n_steps)
        thr = float(full.merges[170, 2])
    want, _ = run(host_ops(method, N), D, alive, n_steps, thr)
    got, _ = run(resident_ops(method, N), D, alive, n_steps, thr)
    assert got.n_merges == want.n_merges
    if case == "threshold" and method in ("single", "average", "ward"):   # monotone heights
        assert engine.THRESHOLD_CHECK_TRIPS < got.n_merges < n_steps
    assert torch.equal(got.merges, want.merges)


@pytest.mark.parametrize("method", ("complete", "ward"))
@pytest.mark.parametrize("n", (1, 2, 3))
def test_resident_tiny(method, n):
    D, alive = problem(method, n)
    n_steps = n - 1
    want, _ = run(host_ops(method, n), D, alive, n_steps)
    got, state = run(resident_ops(method, n), D, alive, n_steps)
    assert torch.equal(got.merges, want.merges)
    if n_steps:
        assert int(state.cache.count) == n_steps and int(state.alive.sum()) == 1


@functools.cache
def jax_reference(method: str, n: int, dead: int, n_steps: int, thr):
    """The JAX kernel engine's ``lazy`` run (Pallas in interpret mode): at a
    ragged n through ``lance_williams_kernelized`` (it pads to the lanes),
    with dead slots through ``run_kernel`` on N = 256."""
    D, alive = problem(method, n, "random", dead)
    if dead:
        out = jengine.run_kernel(jnp.asarray(D), jnp.asarray(alive), method=method,
                                 n_steps=n_steps, variant="lazy", distance_threshold=thr,
                                 block_m=128, interpret=True)
    else:
        out = jops.lance_williams_kernelized(jnp.asarray(D), method, variant="lazy",
                                             stop_at_k=n - n_steps, distance_threshold=thr,
                                             compaction=False)
    return np.asarray(out.merges), int(out.n_merges)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", ("ragged", "dead slots", "stop_at_k", "threshold"))
def test_resident_matches_jax_kernel_lazy(method, case):
    """Slots equal, heights within rtol 1e-4 / atol 1e-5."""
    n, dead = (97, 0) if case == "ragged" else (N, 37)
    D, alive = problem(method, n, "random", dead)
    live = int(alive.sum())
    n_steps = live - (9 if case == "stop_at_k" else 1)
    thr = None
    if case == "threshold":   # between two heights: the packages round them an ulp apart
        h = jax_reference(method, n, dead, n_steps, None)[0][:, 2]
        thr = float((h[170] + h[171]) / 2)
    want, k = jax_reference(method, n, dead, n_steps, thr)
    got, _ = run(resident_ops(method, n), D, alive, n_steps, thr)
    assert got.n_merges == k
    assert_merges_match(got.merges.numpy()[:k], want[:k])


def test_lazy_merge_plain_is_update_then_rescan(rng):
    """One merge from a seeded state: the merge launch's plain half lists
    the stale rows but row i (ascending, padded with n) and leaves the
    candidate; the rescan's takes the list, sets the candidate and empties
    the list; together they are ``lazy_merge_plain``."""
    n = 64
    D, alive = problem("complete", n, "random", 5)
    b = resident_ops("complete", n).seed(engine._init_state(torch.tensor(D),
                                                            torch.tensor(alive), n - 6)).cache
    whole = lw_update.LazyBuffers(*(t.clone() for t in b))
    cand = b.cand.clone()
    i = int(cand.min())
    lw_update._lazy_update_plain("complete", b)
    listed = b.stale[:int(b.n_stale)]
    assert torch.equal(b.cand, cand) and i not in listed.tolist()
    assert torch.equal(listed, listed.sort().values) and (b.stale[int(b.n_stale):] == n).all()
    lw_update.lazy_rescan_plain(b)
    assert int(b.n_stale) == 0 and int(b.rescanned) == len(listed)
    lw_update.lazy_merge_plain("complete", whole)
    for name, got, want in zip(lw_update.LazyBuffers._fields, b, whole):
        assert torch.equal(got, want), name


def test_lazy_wrappers_on_cpu_take_plain_and_check_operands():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; operands are checked before either runs."""
    n = 40
    D, alive = problem("ward", n)
    b = resident_ops("ward", n).seed(engine._init_state(torch.tensor(D),
                                                        torch.tensor(alive), n - 1)).cache
    want = lw_update.lazy_merge_plain("ward", lw_update.LazyBuffers(*(t.clone() for t in b)))
    before = (lw_update.lazy_merge.launches, lw_update.lazy_rescan.launches)
    lw_update.lazy_merge("ward", b)
    assert (lw_update.lazy_merge.launches, lw_update.lazy_rescan.launches) == before
    for name, got, w in zip(lw_update.LazyBuffers._fields, b, want):
        assert torch.equal(got, w), name
    with pytest.raises(ValueError, match="unknown linkage method"):
        lw_update.lazy_merge("nope", b)
    with pytest.raises(ValueError, match="square"):
        lw_update.lazy_merge("ward", b._replace(D=b.D[:, :39]))
    with pytest.raises(ValueError, match="operand"):
        lw_update.lazy_merge("ward", b._replace(stale=b.stale.to(torch.int64)))
    with pytest.raises(ValueError, match="operand"):
        lw_update.lazy_rescan(b._replace(sync=b.sync[:2]))
    with pytest.raises(ValueError, match=r"\(cap, 4\)"):
        lw_update.lazy_merge("ward", b._replace(merges=torch.zeros(40, 3)))


def test_cpu_kernel_lazy_stays_host_driven():
    """``cluster(..., backend="kernel", variant="lazy")`` on the CPU runs
    the host-driven loop: no resident buffers, the row update's plain
    version once a merge."""
    ops = engine.kernel_ops("complete", 50, "lazy", device="cpu")
    assert ops.merge is None and ops.update is not None
    D, alive = problem("complete", 50)
    state = ops.seed(engine._init_state(torch.tensor(D), torch.tensor(alive), 49))
    assert isinstance(state.cache, tuple) and len(state.cache) == 2
