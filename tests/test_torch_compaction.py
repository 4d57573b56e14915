"""Compaction in the port vs the JAX package: the stage plan and the
switch, the live-slot gather and the merge remap, the ``compaction`` knob
through ``cluster()``, and staged runs on both LW backends.

Contract: a staged run's merges equal the same backend and variant run
unstaged bit for bit (slots, heights, sizes), with ``stop_at_k`` and
``distance_threshold`` too; against the JAX package's staged runs the
slots are equal and the heights within rtol 1e-4 / atol 1e-5 (continuous
random data: on tie-dense data the reference's fused rounding can reorder
tied merges, ROADMAP.md §C).  The kernel backend runs on the CPU through
its kernels' plain twins: the host-driven ``lazy`` loop, and the resident
merge entries with a stand-in for the CUDA graph.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import cluster as jcluster  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.lance_williams import lance_williams as jlance_williams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import cluster, engine  # noqa: E402
from repro_torch.core.lance_williams import lance_williams  # noqa: E402
from repro_torch.core.linkage import METHODS  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.kernels import lw_step, lw_update, minscan, ops  # noqa: E402
from repro_torch.kernels.ops import lance_williams_kernelized  # noqa: E402
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
PORT = {"serial": lance_williams, "kernel": lance_williams_kernelized}
KNOB_FLAGS = (True, False, "auto", "on", "off", None, "sometimes")


@functools.cache
def problem(method: str, n: int) -> np.ndarray:
    rng = np.random.default_rng([n, METHODS.index(method), 19])
    return random_distance_matrix(rng, n, squared=method in GEOMETRIC).astype(np.float32)


@functools.cache
def unstaged(backend: str, method: str, n: int, variant: str = "baseline") -> np.ndarray:
    res = PORT[backend](problem(method, n), method, variant=variant, compaction=False,
                        device="cpu")
    assert res.n_merges == n - 1
    return res.merges.numpy()


def stages(backend: str, n: int, n_steps: int):
    floor = engine.KERNEL_MIN_STAGE if backend == "kernel" else engine.MIN_STAGE_N
    return engine.plan_stages(n, n_steps, min_stage=floor)


# ---------------------------------------------------------------------------
# the plan, the switch, the gather and the remap
# ---------------------------------------------------------------------------

PLAN_NS = (0, 1, 2, 3, 6, 31, 32, 63, 64, 65, 100, 127, 128, 255, 256, 260, 300, 384, 520,
           1000, 1968, 4096, 16384)


def plan_steps(n: int):
    return sorted({n - 1, n, n // 2, n - n // 2, n // 2 + 1, n - 60, n - 5, 0, -3})


@pytest.mark.parametrize("min_stage,align", [(32, 1), (128, 1), (128, 128), (8, 2), (2, 1),
                                             (1, 1), (32, 4), (64, 3)])
def test_plan_stages_matches_reference(min_stage, align):
    for n in PLAN_NS:
        for n_steps in plan_steps(n):
            got = engine.plan_stages(n, n_steps, min_stage=min_stage, align=align)
            assert got == jengine.plan_stages(n, n_steps, min_stage=min_stage, align=align)
            assert sum(steps for _, steps in got) == max(n_steps, 0)


def test_plan_stages_defaults_and_bad_align():
    assert engine.MIN_STAGE_N == jengine.MIN_STAGE_N
    for n in PLAN_NS:
        assert engine.plan_stages(n, n - 1) == jengine.plan_stages(n, n - 1)
    for mod in (engine, jengine):
        with pytest.raises(ValueError, match="align"):
            mod.plan_stages(64, 63, align=0)


@pytest.mark.parametrize("flag", (*KNOB_FLAGS, 0, 1, "yes"), ids=repr)
def test_resolve_compaction_matches_reference(flag):
    for n in PLAN_NS:
        for n_steps in plan_steps(n):
            for kw in ({}, dict(min_stage=128), dict(min_stage=128, align=128),
                       dict(min_stage=8, align=2)):
                try:
                    want = jengine.resolve_compaction(flag, n, n_steps, **kw)
                except ValueError:
                    with pytest.raises(ValueError, match="compaction must be"):
                        engine.resolve_compaction(flag, n, n_steps, **kw)
                    continue
                assert engine.resolve_compaction(flag, n, n_steps, **kw) is want


def test_kernel_plan():
    """The kernel plan halves down to KERNEL_MIN_STAGE (256, twice the
    reference's 128-lane floor) with no lane alignment: 3 stages at
    n = 1968, 2 at n = 520, none below n = 512; the reference pads to 128
    lanes and does not stage n = 520."""
    assert engine.KERNEL_MIN_STAGE == 2 * jengine.KERNEL_STAGE_ALIGN
    assert [s for s, _ in stages("kernel", 1968, 1967)] == [1968, 984, 492]
    assert stages("kernel", 520, 519) == ((520, 260), (260, 259))
    for n, k, want in ((1968, 1, True), (520, 1, True), (512, 1, True), (511, 1, False),
                       (300, 1, False), (520, 260, False), (520, 259, True), (100, 1, False)):
        n_steps = engine.resolve_n_steps(n, k)
        assert ops.resolve_kernel_compaction("auto", n, n_steps) is want
        assert ops.resolve_kernel_compaction(False, n, n_steps) is False
    assert jops.resolve_kernel_compaction("auto", 520, 519) is False
    with pytest.raises(ValueError):
        ops.resolve_kernel_compaction("sometimes", 520, 519)


def dead_slot_state(rng, n: int, squared: bool = False):
    D = random_distance_matrix(rng, n, squared=squared).astype(np.float32)
    alive = np.zeros(n, bool)    # a few slots short of half, the last one dead
    alive[rng.choice(n - 1, n // 2 - 3, replace=False)] = True
    sizes = np.where(alive, rng.integers(1, 7, n), 0).astype(np.float32)
    remap = rng.permutation(3 * n)[:n].astype(np.int32)
    return D, alive, sizes, remap


@pytest.mark.parametrize("n", (40, 41))
def test_compact_dense_matches_reference(n, rng):
    """A premasked state with dead slots (the last one dead) gathered to
    half size: the matrix, liveness, sizes and remap of the reference."""
    D, alive, sizes, remap = dead_slot_state(rng, n)
    half = n // 2
    assert alive.sum() <= half
    Dm = np.asarray(jengine.premask(D, alive))
    want = [np.asarray(a) for a in jengine.compact_dense(Dm, alive, sizes, remap, half)]
    got = engine.compact_dense(torch.tensor(Dm), torch.tensor(alive), torch.tensor(sizes),
                               torch.tensor(remap, dtype=torch.int64), half)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].shape == (half, half) and got[3].dtype == torch.int64


def test_compact_dense_keeps_garbage_representation(rng):
    """Without the premask (the kernel backend) the live block is copied
    untouched and the dead tail holds finite cells of the input."""
    n = 41
    D, alive, sizes, remap = dead_slot_state(rng, n)
    Dn, live, sizes_n, remap_n = engine.compact_dense(
        torch.tensor(D), torch.tensor(alive), torch.tensor(sizes),
        torch.tensor(remap, dtype=torch.int64), n // 2, premasked=False)
    L = int(alive.sum())
    idx = np.flatnonzero(alive)
    np.testing.assert_array_equal(Dn[:L, :L].numpy(), D[np.ix_(idx, idx)])
    assert torch.isfinite(Dn).all()
    assert live[:L].all() and not live[L:].any()
    np.testing.assert_array_equal(sizes_n.numpy(), np.r_[sizes[idx], np.zeros(n // 2 - L)])
    np.testing.assert_array_equal(remap_n[:L].numpy(), remap[idx])


@pytest.mark.parametrize("n_merges", (30, 17, 12, 10))
def test_remap_merges_matches_reference(n_merges, rng):
    """Only the stage's rows below n_merges are rewritten; rows past a
    threshold stop keep their zeros."""
    n_steps, start, steps, size = 30, 12, 10, 16
    remap = np.sort(rng.permutation(64)[:size]).astype(np.int32)
    merges = np.zeros((n_steps, 4), np.float32)
    rows = min(n_merges, n_steps)
    i = rng.integers(0, size - 1, rows)
    merges[:rows] = np.c_[i, i + 1 + rng.integers(0, size - 1 - i), rng.random(rows),
                          rng.integers(2, 9, rows)]
    want = np.asarray(jengine.remap_merges(jnp.asarray(merges), n_merges, jnp.asarray(remap),
                                           start, steps))
    got = engine.remap_merges(torch.tensor(merges), n_merges,
                              torch.tensor(remap, dtype=torch.int64), start, steps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(jcore.__all__))
def test_package_surface_matches_reference(name):
    """``repro_torch.core`` exports every name of ``repro.core``."""
    assert name in core.__all__
    assert getattr(core, name) is not None
    if name in ("METHODS", "VARIANTS", "REDUCIBLE_METHODS", "POINTS_METHODS"):
        assert tuple(getattr(core, name)) == tuple(getattr(jcore, name))


# ---------------------------------------------------------------------------
# the knob through cluster()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", (6, 300))
@pytest.mark.parametrize("backend", ("serial", "kernel"))
@pytest.mark.parametrize("flag", KNOB_FLAGS, ids=repr)
def test_compaction_knob_matches_reference(flag, backend, n):
    """Every value of the knob: the JAX package's algorithm, backend and
    merges, or the same exception type."""
    X = gaussian_mixture(seed=n, n=n, dim=8, k=min(n, 8), return_labels=False)
    try:
        want = jcluster(X, "complete", backend=backend, compaction=flag)
    except Exception as err:    # noqa: BLE001 — the type is what is compared
        with pytest.raises(type(err)):
            cluster(X, "complete", backend=backend, compaction=flag, device="cpu")
        return
    got = cluster(X, "complete", backend=backend, compaction=flag, device="cpu")
    assert (got.algorithm, got.backend) == (want.algorithm, want.backend)
    assert_merges_match(got.merges, want.merges)


# ---------------------------------------------------------------------------
# staged runs: bit for bit against unstaged, slots against the JAX package
# ---------------------------------------------------------------------------


def assert_staged_equals_unstaged(backend, method, n, variant="baseline", **knobs):
    assert len(stages(backend, n, n - 1)) > 1
    got = PORT[backend](problem(method, n), method, variant=variant, compaction=True,
                        device="cpu", **knobs)
    assert got.n_merges == n - 1
    np.testing.assert_array_equal(got.merges.numpy(), unstaged(backend, method, n, variant))


@pytest.mark.parametrize("n", (64, 100))
@pytest.mark.parametrize("variant", engine.VARIANTS)
def test_serial_staged_equals_unstaged_variants(variant, n):
    assert_staged_equals_unstaged("serial", "complete", n, variant)


@pytest.mark.parametrize("method", METHODS)
def test_serial_staged_equals_unstaged_methods(method):
    assert_staged_equals_unstaged("serial", method, 70)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("variant", ("baseline", "lazy"))
def test_kernel_staged_equals_unstaged(variant, method):
    """n = 520, two stages (520, 260): the resident fused merge's plain
    twin (baseline) and the host-driven loop (lazy)."""
    assert_staged_equals_unstaged("kernel", method, 520, variant)


class FakeGraph:
    """Stands in for :class:`~repro_torch.kernels.lw_step.MergeGraph` on the
    CPU: ``replay`` makes ``k`` merges of the resident entry one by one."""

    captures = replays = 0

    def __init__(self, method, b, k, merge=None):
        self.method, self.b, self.merges = method, b, k
        self.merge = lw_step.lw_merge if merge is None else merge
        FakeGraph.captures += 1

    def replay(self):
        for _ in range(self.merges):
            self.merge(self.method, self.b)
        FakeGraph.replays += 1


@pytest.mark.parametrize("method", ("complete", "ward"))
@pytest.mark.parametrize("variant", ("baseline", "lazy"))
def test_resident_stages_capture_their_own_graphs(variant, method, monkeypatch, kernel_floor):
    """The card's composition on the CPU: each stage builds its own
    resident buffers around the gathered state and captures its own graph
    at its first replay, the record continuing across stages; the merges
    equal the unstaged resident run's bit for bit."""
    def card_ops(method, n, variant="baseline", device=None):
        if variant == "lazy":
            return engine._lazy_resident_ops(
                method, n, lw_update.lazy_merge,
                functools.partial(FakeGraph, merge=lw_update.lazy_merge))
        return engine._fused_ops(method, n, minscan.masked_argmin, lw_step.lw_merge, FakeGraph)

    monkeypatch.setattr(engine, "kernel_ops", card_ops)
    kernel_floor(128)       # two stages of at least 128 merges at a small n
    n, k, D = 300, 20, problem(method, 300)
    want = lance_williams_kernelized(D, method, variant=variant, stop_at_k=k, compaction=False,
                                     device="cpu")
    FakeGraph.captures = FakeGraph.replays = 0
    got = lance_williams_kernelized(D, method, variant=variant, stop_at_k=k, device="cpu")
    assert stages("kernel", n, n - k) == ((300, 150), (150, 130))
    assert (FakeGraph.captures, FakeGraph.replays) == (2, 2)
    assert got.n_merges == n - k
    assert torch.equal(got.merges, want.merges)


@pytest.mark.parametrize("method", METHODS)
def test_staged_slots_match_reference(method, kernel_floor):
    """n = 260 on continuous data: the JAX serial backend staged (260 / 130
    / 65 / 32) against the port's serial backend staged the same way and
    its kernel backend staged (260 / 130, its plan at a floor of 128: n =
    260 is below its own floor's first stage)."""
    n = 260
    kernel_floor(128)
    D = problem(method, n)
    want = np.asarray(jlance_williams(D, method, compaction=True).merges)
    for backend in ("serial", "kernel"):
        assert len(stages(backend, n, n - 1)) > 1
        got = PORT[backend](D, method, device="cpu")
        assert_merges_match(got.merges, want)


# ---------------------------------------------------------------------------
# stop_at_k and distance_threshold across stage boundaries
# (a mirror of tests/test_engine.py::test_compaction_early_stop_matrix)
# ---------------------------------------------------------------------------

# the kernel backend at its own floor, and at floors that give the plan
# more stages on the CPU's small n (100 / 50 at 32, 520 / 260 / 130 at 128)
EARLY_STOP = [("serial", 100, None), ("kernel", 100, 32), ("kernel", 520, None),
              ("kernel", 520, 128)]
# the thresholds sit between the heights of merges t and t + 1: in stage 0,
# in stage 1, and in the last stage (stage 2 where there are three)
THRESHOLD_MERGES = {100: (30, 60, 90), 520: (200, 330, 450)}


@pytest.fixture
def kernel_floor(monkeypatch):
    def set_floor(floor):
        if floor is not None:
            monkeypatch.setattr(engine, "KERNEL_MIN_STAGE", floor)
            monkeypatch.setattr(ops, "KERNEL_MIN_STAGE", floor)
    return set_floor


@pytest.mark.parametrize("k", (60, 50, 20, 5))
@pytest.mark.parametrize("backend,n,floor", EARLY_STOP)
def test_compaction_stop_at_k(backend, n, floor, k, kernel_floor):
    """stop_at_k before the first boundary (the plan degenerates), on it
    and past it: the unstaged run's prefix."""
    kernel_floor(floor)
    full = unstaged(backend, "complete", n)
    got = PORT[backend](problem("complete", n), "complete", stop_at_k=k, compaction=True,
                        device="cpu")
    assert got.n_merges == n - k
    np.testing.assert_array_equal(got.merges.numpy(), full[: n - k])
    want_stages = 1 if n - k <= n // 2 else 3 if floor == 128 else 2
    assert len(stages(backend, n, n - k)) == want_stages


@pytest.mark.parametrize("stage", (0, 1, 2))
@pytest.mark.parametrize("backend,n,floor", EARLY_STOP)
def test_compaction_threshold(backend, n, floor, stage, kernel_floor):
    """A threshold stop inside stage 0, stage 1 and the tail: the unstaged
    run's prefix, later stages run no trip, rows past the stop stay zero.
    The threshold sits between two heights, where the JAX package stops
    too (the packages may round a height an ulp apart)."""
    kernel_floor(floor)
    full = unstaged(backend, "complete", n)
    t = THRESHOLD_MERGES[n][stage]
    thr = float((full[t, 2] + full[t + 1, 2]) / 2)
    got = PORT[backend](problem("complete", n), "complete", distance_threshold=thr,
                        compaction=True, device="cpu")
    nm, m = got.n_merges, got.merges.numpy()
    np.testing.assert_array_equal(m[:nm], full[:nm])
    assert full[nm, 2] > thr
    assert not m[nm:].any(), "rows past n_merges must stay zero"
    assert nm == t + 1
    want = jlance_williams(problem("complete", n), "complete", distance_threshold=thr,
                           compaction=True)
    assert int(want.n_merges) == nm
