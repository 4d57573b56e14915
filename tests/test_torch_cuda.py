"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no jax, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import nnchain  # noqa: E402
from repro_torch.core.engine import VARIANTS  # noqa: E402
from repro_torch.core.linkage import METHODS  # noqa: E402
from repro_torch.kernels import lw_step, lw_update, minscan, pairwise  # noqa: E402


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
    """A mid-run state: symmetric D, dead slots, sizes, and a live i < j
    (at n = 1, the one slot merged with itself)."""
    D = random_distance_matrix(rng, n, squared=method in ("centroid", "median", "ward"))
    D = D.astype(np.float32)
    alive = rng.random(n) > dead
    alive[:3] = True
    live = np.flatnonzero(alive)
    i, j = sorted(rng.choice(live, 2, replace=False)) if n > 1 else (0, 0)
    sizes = np.where(alive, rng.integers(1, 7, n), 0).astype(np.float32)
    return D, alive, sizes, int(i), int(j)


def torch_step_args(D, alive, sizes, i, j, device="cpu"):
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    Dt = t(D)
    return (Dt, Dt[i].clone(), Dt[j].clone(), t([D[i, j]]), t([sizes[i]]), t([sizes[j]]),
            t(sizes), t(alive, torch.bool), t([i], torch.int64), t([j], torch.int64))


def lw_update_args(D, alive, sizes, i, j, device="cpu"):
    """The row update's operands for the merge of i and j in a step problem."""
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    keep = alive & (np.arange(len(alive)) != i) & (np.arange(len(alive)) != j)
    return (t(D[i]), t(D[j]), t([D[i, j]]), t([sizes[i]]), t([sizes[j]]), t(sizes),
            t(keep, torch.bool))


def merge_problem(rng, n, method, device="cpu", dead=0.3):
    """A step problem as the resident loop holds it: its buffers, with the
    candidate the masked first minimum of D."""
    D, alive, sizes, _, _ = step_problem(rng, n, method, dead)
    Dt = torch.tensor(D, device=device)
    alive_t = torch.tensor(alive, device=device)
    v, flat = minscan.masked_argmin_plain(Dt, alive_t)
    cand = (flat // n, flat % n, v)
    merges = torch.zeros((n, 4), device=device)
    return lw_step.merge_buffers(Dt, alive_t, torch.tensor(sizes, device=device), merges, cand, 0)


def clone_buffers(b):
    return lw_step.MergeBuffers(*(t.clone() for t in b))


def reset_launches():
    minscan.masked_argmin.launches = lw_step.lw_step.launches = 0
    lw_step.lw_merge.launches = lw_update.lw_update.launches = 0
    lw_update.lazy_merge.launches = lw_update.lazy_rescan.launches = 0


def launches():
    """Launch counts of (B1, B2's per-row entry, B2's merge entry, B3's
    per-row entry, B3's lazy merge, B3's rescan)."""
    return (minscan.masked_argmin.launches, lw_step.lw_step.launches,
            lw_step.lw_merge.launches, lw_update.lw_update.launches,
            lw_update.lazy_merge.launches, lw_update.lazy_rescan.launches)


def assert_same_merges(got, want):
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-5)


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
@pytest.mark.parametrize("n", (1, 2, 97, 1967, 1968, 4099))
def test_cuda_lw_step_matches_plain(method, n, cuda, rng):
    """B2's per-row entry: rows read whole (n % 4 == 0) and with a
    misaligned head and a ragged tail, a warp a row (n <= 4096) and a block
    a row (n = 4099)."""
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
@pytest.mark.parametrize("n", (2, 97, 1967, 4099))
def test_cuda_lw_merge_matches_plain(method, n, cuda, rng):
    """B2's merge entry against its plain twin over successive merges from
    a mid-run state: every buffer bit for bit, and the kernel's running
    minimum and ticket back at their values between launches."""
    got = merge_problem(rng, n, method, device=cuda)
    want = clone_buffers(got)
    sync = got.sync.clone()
    before = lw_step.lw_merge.launches
    for _ in range(min(n - 1, 6)):
        lw_step.lw_merge(method, got)
        lw_step.lw_merge_plain(method, want)
    torch.cuda.synchronize()
    assert lw_step.lw_merge.launches == before + min(n - 1, 6)
    for name, a, b in zip(lw_step.MergeBuffers._fields, got, want):
        if name != "sync":
            assert torch.equal(a, b), name
    assert torch.equal(got.sync, sync)
    assert torch.equal(got.D, got.D.T)          # D stays exactly symmetric


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("single", "complete", "centroid", "ward"))
def test_cuda_graph_replays_eager_merges(method, cuda, rng):
    """A captured chunk of merges, replayed twice, equals the same merges
    launched one by one; the capture counts no launch, each replay its
    merges."""
    got = merge_problem(rng, 300, method, device=cuda)
    want = clone_buffers(got)
    reset_launches()
    graph = lw_step.MergeGraph(method, got, 16)
    assert launches() == (0, 0, 0, 0, 0, 0)
    graph.replay()
    graph.replay()
    assert launches() == (0, 0, 32, 0, 0, 0)
    for _ in range(32):
        lw_step.lw_merge(method, want)
    torch.cuda.synchronize()
    for name, a, b in zip(lw_step.MergeBuffers._fields, got, want):
        assert torch.equal(a, b), name
    assert int(got.count) == 32


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", ("full", "stop_at_k", "threshold", "dead slots"))
def test_cuda_graph_run_matches_eager_and_cpu(method, case, cuda, rng):
    """A graph-replayed run (chunks of THRESHOLD_CHECK_TRIPS) against the
    same loop launching every merge, against its plain twin on the card
    (bit for bit) and against the CPU run (merge for merge); the counters
    read one seed and one merge launch a merge."""
    from repro_torch.core import engine
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS

    n = 2 * THRESHOLD_CHECK_TRIPS + 45
    D = torch.tensor(random_distance_matrix(rng, n, squared=method == "ward").astype(np.float32))
    alive = torch.ones(n, dtype=torch.bool)
    if case == "dead slots":
        alive[rng.choice(n, 20, replace=False)] = False
    live = int(alive.sum())
    n_steps = live - (9 if case == "stop_at_k" else 1)
    thr = None
    if case == "threshold":     # crosses inside the second chunk
        full = engine.run_kernel(D.clone(), alive.clone(), method=method, n_steps=n_steps)
        thr = float(full.merges[THRESHOLD_CHECK_TRIPS + 50, 2])

    def run(device, ops=None):
        Dd, alive_d = D.to(device), alive.to(device)
        if ops is None:
            return engine.run_kernel(Dd, alive_d, method=method, n_steps=n_steps,
                                     distance_threshold=thr)
        out = engine.run_merge_loop(ops, engine._init_state(Dd, alive_d, n_steps), n_steps, thr)
        return engine.LWResult(merges=out.merges, n_merges=out.n_merges)

    reset_launches()
    graphed = run(cuda)
    counts = launches()
    eager = run(cuda, engine._fused_ops(method, n, minscan.masked_argmin, lw_step.lw_merge))
    plain = run(cuda, engine._fused_ops(method, n, minscan.masked_argmin_plain,
                                        lw_step.lw_merge_plain))
    cpu = run("cpu")
    k = cpu.n_merges
    if case == "threshold":
        assert 0 < k < n_steps and counts[2] == min(n_steps, 2 * THRESHOLD_CHECK_TRIPS)
    else:
        assert k == n_steps and counts == (1, 0, n_steps, 0, 0, 0)
    assert graphed.n_merges == eager.n_merges == plain.n_merges == k
    assert torch.equal(graphed.merges, eager.merges) and torch.equal(graphed.merges, plain.merges)
    assert_same_merges(graphed.merges.cpu().numpy(), cpu.merges.numpy())


@pytest.mark.cuda
def test_cuda_lw_merge_rejects_bad_operands(cuda, rng):
    b = merge_problem(rng, 40, "complete", device=cuda)
    with pytest.raises(ValueError, match="unknown linkage method"):
        lw_step.lw_merge("nope", b)
    with pytest.raises(ValueError, match="operand"):
        lw_step.lw_merge("complete", b._replace(rarg=b.rarg.to(torch.int32)))
    with pytest.raises(ValueError, match="contiguous"):
        lw_step.lw_merge("complete", b._replace(sizes=torch.zeros(80, device=cuda)[::2]))
    with pytest.raises(ValueError, match="one device"):
        lw_step.lw_merge("complete", b._replace(count=b.count.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_cuda_cluster_matches_cpu(method, cuda):
    """The whole loop on the card: index-identical to the CPU run, one seed
    launch and n - 1 step launches."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=4, n=97, dim=8, return_labels=False)
    reset_launches()
    got = cluster(X, method, algorithm="lw", backend="kernel")  # the default device is CUDA
    assert launches() == (1, 0, 96, 0, 0, 0)
    want = cluster(X, method, algorithm="lw", backend="kernel", device="cpu")
    assert_same_merges(got.merges, want.merges)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", (97, 1968))
def test_cuda_lw_update_matches_plain(method, n, cuda, rng):
    """B3 on a ragged n with dead slots: equal to its plain version, 0 on
    the dropped lanes."""
    D, alive, sizes, i, j = step_problem(rng, n, method)
    args = lw_update_args(D, alive, sizes, i, j, device=cuda)
    before = lw_update.lw_update.launches
    got = lw_update.lw_update(method, *args)
    want = lw_update.lw_update_plain(method, *args)
    torch.cuda.synchronize()
    assert lw_update.lw_update.launches == before + 1
    # the kernel rounds each operation as torch does: equal, not just close
    assert torch.equal(got, want)
    assert (got[~args[-1]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("complete", "centroid", "ward"))
def test_cuda_kernel_variants_match_baseline(method, cuda):
    """Kernel ``lazy`` is B3's resident merge, two launches a merge (the
    merge and the rescan), and no B1/B2; ``rowmin`` is the fused path.
    Both give the baseline's merges; the fused path seeds once a stage."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=5, n=300, dim=8, return_labels=False)
    runs, counts = {}, {}
    for variant in VARIANTS:
        reset_launches()
        runs[variant] = cluster(X, method, algorithm="lw", backend="kernel", variant=variant)
        counts[variant] = launches()
    seeds = len(kernel_plan(300, 299))
    assert counts == {"baseline": (seeds, 0, 299, 0, 0, 0), "rowmin": (seeds, 0, 299, 0, 0, 0),
                      "lazy": (0, 0, 0, 0, 299, 299)}
    for variant in ("rowmin", "lazy"):
        assert_same_merges(runs[variant].merges, runs["baseline"].merges)


def lazy_problem(rng, n, method, device, dead=0.3):
    """A step problem as the resident lazy loop holds it: its buffers, with
    every row's cached minimum and the candidate from them."""
    from repro_torch.core import engine

    D, alive, sizes, _, _ = step_problem(rng, n, method, dead)
    Dt = torch.tensor(D, device=device)
    alive_t = torch.tensor(alive, device=device)
    ks = torch.arange(n, device=device)
    rmin, rarg = engine._masked_row_mins(Dt, alive_t, ks, ks)
    cand = engine._cached_cand(alive_t, rmin, rarg, ks)
    return lw_update.lazy_buffers(Dt, alive_t, torch.tensor(sizes, device=device),
                                  torch.zeros((n, 4), device=device), cand, (rmin, rarg), 0)


def assert_same_lazy(got, want):
    """Every buffer bit for bit but the stale list (the kernel fills it in
    no order; it is empty between merges)."""
    for name, a, b in zip(lw_update.LazyBuffers._fields, got, want):
        if name != "stale":
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", (2, 97, 1967, 1968))
def test_cuda_lazy_merge_matches_plain(method, n, cuda, rng):
    """B3's resident lazy merge against its plain twin over 64 successive
    merges from a mid-run state (rows misaligned at n = 97 and 1967):
    every buffer bit for bit, the keys and tickets back at their values
    between launches, the list empty."""
    got = lazy_problem(rng, n, method, cuda)
    want = lw_update.LazyBuffers(*(t.clone() for t in got))
    sync = got.sync.clone()
    merges = min(int(got.alive.sum()) - 1, 64)
    reset_launches()
    for _ in range(merges):
        lw_update.lazy_merge(method, got)
        lw_update.lazy_merge_plain(method, want)
    torch.cuda.synchronize()
    assert launches() == (0, 0, 0, 0, merges, merges)
    assert_same_lazy(got, want)
    assert torch.equal(got.sync, sync) and int(got.n_stale) == 0
    assert torch.equal(got.D, got.D.T)          # D stays exactly symmetric


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("single", "complete", "centroid", "ward"))
def test_cuda_lazy_graph_replays_eager_merges(method, cuda, rng):
    """A captured chunk of lazy merges, replayed twice, equals the same
    merges launched one by one; the capture counts no launch, each replay
    its merges' two launches each."""
    got = lazy_problem(rng, 300, method, cuda)
    want = lw_update.LazyBuffers(*(t.clone() for t in got))
    reset_launches()
    replays = lw_step.MergeGraph.replays
    graph = lw_step.MergeGraph(method, got, 16, merge=lw_update.lazy_merge)
    assert launches() == (0,) * 6
    graph.replay()
    graph.replay()
    assert launches() == (0, 0, 0, 0, 32, 32) and lw_step.MergeGraph.replays == replays + 2
    for _ in range(32):
        lw_update.lazy_merge(method, want)
    torch.cuda.synchronize()
    assert_same_lazy(got, want)
    assert int(got.count) == 32


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", ("full", "stop_at_k", "threshold", "dead slots"))
def test_cuda_lazy_run_matches_eager_and_cpu(method, case, cuda, rng):
    """Kernel ``lazy`` on the card (graph replays of THRESHOLD_CHECK_TRIPS
    merges, two launches a merge) against the same loop launching every
    merge and its plain twin on the card (bit for bit) and against the
    CPU's host-driven loop (merge for merge)."""
    from repro_torch.core import engine
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS

    n = 2 * THRESHOLD_CHECK_TRIPS + 45
    D = torch.tensor(random_distance_matrix(rng, n, squared=method == "ward").astype(np.float32))
    alive = torch.ones(n, dtype=torch.bool)
    if case == "dead slots":
        alive[rng.choice(n, 20, replace=False)] = False
    live = int(alive.sum())
    n_steps = live - (9 if case == "stop_at_k" else 1)
    thr = None
    if case == "threshold":     # crosses inside the second chunk
        full = engine.run_kernel(D.clone(), alive.clone(), method=method, n_steps=n_steps,
                                 variant="lazy")
        thr = float(full.merges[THRESHOLD_CHECK_TRIPS + 50, 2])

    def run(device, ops=None):
        Dd, alive_d = D.to(device), alive.to(device)
        if ops is None:
            return engine.run_kernel(Dd, alive_d, method=method, n_steps=n_steps, variant="lazy",
                                     distance_threshold=thr)
        out = engine.run_merge_loop(ops, engine._init_state(Dd, alive_d, n_steps), n_steps, thr)
        return engine.LWResult(merges=out.merges, n_merges=out.n_merges)

    reset_launches()
    graphed = run(cuda)
    counts = launches()
    eager = run(cuda, engine._lazy_resident_ops(method, n, lw_update.lazy_merge))
    plain = run(cuda, engine._lazy_resident_ops(method, n, lw_update.lazy_merge_plain))
    cpu = run("cpu")
    k = cpu.n_merges
    if case == "threshold":
        trips = min(n_steps, 2 * THRESHOLD_CHECK_TRIPS)
        assert 0 < k < n_steps and counts == (0, 0, 0, 0, trips, trips)
    else:
        assert k == n_steps and counts == (0, 0, 0, 0, n_steps, n_steps)
    assert graphed.n_merges == eager.n_merges == plain.n_merges == k
    assert torch.equal(graphed.merges, eager.merges) and torch.equal(graphed.merges, plain.merges)
    assert_same_merges(graphed.merges.cpu().numpy(), cpu.merges.numpy())


@pytest.mark.cuda
def test_cuda_lazy_merge_rejects_bad_operands(cuda, rng):
    b = lazy_problem(rng, 40, "complete", cuda)
    with pytest.raises(ValueError, match="unknown linkage method"):
        lw_update.lazy_merge("nope", b)
    with pytest.raises(ValueError, match="operand"):
        lw_update.lazy_merge("complete", b._replace(rarg=b.rarg.to(torch.int32)))
    with pytest.raises(ValueError, match="contiguous"):
        lw_update.lazy_merge("complete", b._replace(sizes=torch.zeros(80, device=cuda)[::2]))
    with pytest.raises(ValueError, match="one device"):
        lw_update.lazy_rescan(b._replace(count=b.count.cpu()))


STRESS_RUNS = 150       # n = 97 runs a method, each merge launched on its own
STRESS_GRAPH_RUNS = 20  # n = 300 runs a method and variant, replayed from graphs


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_cuda_resident_merges_stable_under_load(method, cuda):
    """The resident merges' last-block protocol under load: a matrix
    product loop runs on a second stream while the kernel backend's LW
    loop (B2's merge entry, launched merge by merge at n = 97 and replayed
    from graphs at n = 300) and kernel ``lazy`` (B3's merge entry) run
    again and again.  Every run equals the first bit for bit, slots and
    heights, and the CPU's run on the same matrix merge for merge; a
    differing run prints its rows."""
    from repro_torch.core import cluster

    a = torch.randn(4096, 4096, device=cuda)
    c = torch.empty_like(a)
    load = torch.cuda.Stream(device=cuda)

    def more_load():
        with torch.cuda.stream(load):
            for _ in range(8):
                torch.matmul(a, a, out=c)

    cases = [(97, "baseline", STRESS_RUNS), (300, "baseline", STRESS_GRAPH_RUNS),
             (300, "lazy", STRESS_GRAPH_RUNS)]
    for n, variant, runs in cases:
        # one matrix for both devices: built on each, they differ in the last bits
        D = random_distance_matrix(np.random.default_rng(n), n,
                                   squared=method in ("centroid", "median", "ward"))
        D = D.astype(np.float32)
        want = cluster(D, method, algorithm="lw", backend="kernel", variant=variant,
                       device="cpu").merges
        first = None
        for run in range(runs):
            if run % 4 == 0:
                more_load()
            got = cluster(D, method, algorithm="lw", backend="kernel", variant=variant).merges
            if first is None:
                first = got
                assert_same_merges(got, want)
            bad = np.flatnonzero((got != first).any(axis=1))
            assert not bad.size, (f"n={n} {variant} run {run}: merges {bad[:8].tolist()} differ "
                                  f"from the first run: {got[bad[:4]].tolist()} vs "
                                  f"{first[bad[:4]].tolist()}")
    load.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_serial_matches_kernel(variant, cuda):
    """The serial backend on the card launches no kernel and gives the
    kernel backend's merges, also under a threshold on a merge height."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=6, n=300, dim=8, return_labels=False)
    reset_launches()
    got = cluster(X, "centroid", variant=variant)
    assert (got.algorithm, got.backend, launches()) == ("lw", "serial", (0,) * 6)
    want = cluster(X, "centroid", algorithm="lw", backend="kernel")
    assert_same_merges(got.merges, want.merges)
    thr = float(want.merges[150, 2])
    for backend in ("serial", "kernel"):
        cut = cluster(X, "centroid", algorithm="lw", backend=backend, variant=variant,
                      distance_threshold=thr)
        k = int(np.argmax(~(want.merges[:, 2] <= np.float32(thr))))
        assert cut.n_merges == k > 0
        assert_same_merges(cut.merges, want.merges[:k])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_strided_matrix(cuda):
    D = torch.zeros(8, 16, device=cuda)[:, :8]
    with pytest.raises(ValueError, match="contiguous"):
        minscan.masked_argmin(D, torch.ones(8, dtype=torch.bool, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 3), (1968, 64), (4097, 130), (32768, 128), (5, 20000)])
def test_cuda_row_sq_matches_plain(m, d, cuda, rng):
    """B5 on its vector path (d % 4 == 0), its scalar path (d = 3, 130)
    and on rows wider than a warp's one pass (d = 20000)."""
    Y = torch.tensor(rng.normal(size=(m, d)).astype(np.float32), device=cuda)
    x = Y[m // 2]
    launches = pairwise.row_sq_euclidean.launches
    got = pairwise.row_sq_euclidean(x, Y)
    want = pairwise.row_sq_euclidean_plain(x, Y)
    torch.cuda.synchronize()
    assert pairwise.row_sq_euclidean.launches == launches + 1
    assert got.shape == (m,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert float(got[m // 2]) == 0.0


@pytest.mark.cuda
def test_cuda_row_sq_unaligned_tip(cuda, rng):
    """A tip that is not 16-byte aligned takes the scalar path."""
    Y = torch.tensor(rng.normal(size=(300, 64)).astype(np.float32), device=cuda)
    x = torch.tensor(rng.normal(size=65).astype(np.float32), device=cuda)[1:]
    torch.testing.assert_close(pairwise.row_sq_euclidean(x, Y),
                               pairwise.row_sq_euclidean_plain(x, Y), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_row_sq_rejects_bad_operands(cuda):
    Y = torch.zeros(16, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pairwise.row_sq_euclidean(Y[0].double(), Y.double())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise.row_sq_euclidean(Y[0], torch.zeros(16, 16, device=cuda)[:, :8])
    with pytest.raises(ValueError, match="one device"):
        pairwise.row_sq_euclidean(Y[0].cpu(), Y)
    with pytest.raises(ValueError, match=r"\(d,\)"):
        pairwise.row_sq_euclidean(Y[0, :4], Y)


def reset_trips():
    pairwise.chain_trip.launches = pairwise.TripGraph.replays = 0
    pairwise.row_sq_euclidean.launches = 0


def assert_trip_counts(iters):
    """The resident chain's launches: whole replays of CHAIN_GRAPH_TRIPS
    trips, the last one past the end by less than a replay; no row
    launch."""
    k = nnchain.CHAIN_GRAPH_TRIPS
    assert pairwise.chain_trip.launches == pairwise.TripGraph.replays * k
    assert iters <= pairwise.chain_trip.launches < iters + k
    assert pairwise.row_sq_euclidean.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_cuda_points_chain_counts_rows(method, cuda):
    """The matrix-free chain on the card: one trip launch a trip, replayed
    from graphs, and the merges and trips of the CPU run."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture

    X = gaussian_mixture(seed=6, n=300, dim=16, return_labels=False)
    reset_trips()
    res = nnchain.nn_chain_from_points(X, method)       # the default device is CUDA
    assert res.merges.device.type == "cuda" and res.n_merges == 299
    assert_trip_counts(res.iters)
    want = nnchain.nn_chain_from_points(X, method, device="cpu")
    assert res.iters == want.iters
    np.testing.assert_array_equal(res.merges.cpu().numpy()[:, [0, 1, 3]],
                                  want.merges.numpy()[:, [0, 1, 3]])
    np.testing.assert_allclose(res.merges.cpu().numpy()[:, 2], want.merges.numpy()[:, 2],
                               rtol=1e-4, atol=1e-5)
    reset_trips()
    got = cluster(X, method, metric="sqeuclidean", matrix_free=True)
    assert (got.algorithm, got.backend, got.distances) == ("nnchain", "serial", None)
    assert_trip_counts(res.iters)


def to_device(b, device):
    """A copy of trip buffers on ``device``."""
    return b._replace(**{f: getattr(b, f).to(device, copy=True)
                         for f in pairwise.ChainBuffers._fields[:9]})


def chain_state(X, method, trips, device="cpu"):
    """Trip buffers of the points X after ``trips`` plain trips on the CPU,
    moved to ``device``."""
    n = len(X)
    b = pairwise.chain_buffers(torch.tensor(np.asarray(X, np.float32)), torch.zeros(n),
                               torch.ones(n, dtype=torch.bool), torch.ones(n), n - 1)
    for _ in range(trips):
        pairwise.chain_trip_plain(method, b)
    return to_device(b, device)


def assert_same_trip(got, want):
    """Kernel and plain twin after the same trips: the same decisions,
    slots and counts; the summaries within the row's float error (its sum
    runs in another order); the kernel's key and ticket reset."""
    for name in ("alive", "bits", "sizes", "chain", "count"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name).cpu()), name
    torch.testing.assert_close(got.merges.cpu()[:, [0, 1, 3]], want.merges.cpu()[:, [0, 1, 3]],
                               rtol=0, atol=0)
    torch.testing.assert_close(got.merges.cpu(), want.merges.cpu(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.W.cpu(), want.W.cpu(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.u.cpu(), want.u.cpu(), rtol=1e-5, atol=1e-5)
    assert got.sync[:2].tolist() == [-1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
@pytest.mark.parametrize("d", (16, 64, 128, 7, 200))
def test_cuda_chain_trip_matches_plain(method, d, cuda, rng):
    """One trip of the kernel against its plain twin from every state of a
    run's first trips: push trips, merge trips and the restarts after the
    chain empties.  d = 16, 64, 128 keep the tip in registers; d = 7 and
    200 take the scalar path."""
    X = rng.normal(size=(97, d)).astype(np.float32)
    kinds = set()
    b = chain_state(X, method, 0)
    for _ in range(120):
        got = to_device(b, cuda)
        before = b.count.tolist()
        launches = pairwise.chain_trip.launches
        pairwise.chain_trip(method, got)
        pairwise.chain_trip_plain(method, b)
        torch.cuda.synchronize()
        assert pairwise.chain_trip.launches == launches + 1
        assert_same_trip(got, b)
        after = b.count.tolist()
        kinds.add("merge" if after[1] > before[1] else "push")
        if after[1] > before[1] and before[0] == 2:
            kinds.add("restart")
    assert kinds == {"push", "merge", "restart"}


@pytest.mark.cuda
def test_cuda_chain_trip_previous_element_wins_ties(cuda):
    """Equidistant neighbors of the tip: the kernel merges with the previous
    chain element, as the plain twin does."""
    X = np.array([[0.0], [2.0], [1.0], [5.0]], np.float32)
    got, want = chain_state(X, "average", 0, cuda), chain_state(X, "average", 0)
    for b in (got, want):
        b.chain[:2] = torch.tensor([1, 2], dtype=torch.int32)
        b.count[0] = 2
    pairwise.chain_trip("average", got)
    pairwise.chain_trip_plain("average", want)
    torch.cuda.synchronize()
    assert_same_trip(got, want)
    assert got.merges[0, :2].tolist() == [1.0, 2.0]


@pytest.mark.cuda
def test_cuda_chain_trip_unaligned_and_past_the_end(cuda, rng):
    """Summaries that are not 16-byte aligned take the scalar path; a trip
    past the last merge, and one after a NaN stop, change nothing."""
    X = rng.normal(size=(60, 32)).astype(np.float32)
    b = chain_state(X, "ward", 10, cuda)
    W = torch.zeros(60 * 32 + 1, device=cuda)[1:].view(60, 32)   # 4 bytes past 16-byte alignment
    W.copy_(b.W)
    got = b._replace(W=W)
    want = chain_state(X, "ward", 10)
    pairwise.chain_trip("ward", got)
    pairwise.chain_trip_plain("ward", want)
    torch.cuda.synchronize()
    assert_same_trip(got, want)
    done = chain_state(X, "ward", 0, cuda)
    while not nnchain._chain_done(done):
        pairwise.chain_trip("ward", done)
    X[3, 0] = np.nan
    stopped = chain_state(X, "ward", 0, cuda)
    while not nnchain._chain_done(stopped):
        pairwise.chain_trip("ward", stopped)
    assert stopped.count.tolist()[3] == 1
    for b in (done, stopped):
        before = [t.clone() for t in b[:9]]
        pairwise.chain_trip("ward", b)
        torch.cuda.synchronize()
        for a, w in zip(b, before):
            torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_cuda_trip_graph_replays_eager_trips(method, cuda, rng):
    """A captured chunk of trips, replayed twice, equals the same trips
    launched one by one, bit for bit; the capture counts no launch, each
    replay its trips."""
    X = rng.normal(size=(300, 128)).astype(np.float32)
    got, want = chain_state(X, method, 5, cuda), chain_state(X, method, 5, cuda)
    reset_trips()
    graph = pairwise.TripGraph(method, got, 40)
    assert (pairwise.chain_trip.launches, pairwise.TripGraph.replays) == (0, 0)
    graph.replay()
    graph.replay()
    assert (pairwise.chain_trip.launches, pairwise.TripGraph.replays) == (80, 2)
    for _ in range(80):
        pairwise.chain_trip(method, want)
    torch.cuda.synchronize()
    for name in pairwise.ChainBuffers._fields[:9]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.count[2]) == 85


@pytest.mark.cuda
@pytest.mark.parametrize("method", nnchain.POINTS_METHODS)
def test_cuda_resident_chain_matches_host_loop(method, cuda):
    """At n = 4096 the resident chain's dendrogram is the host-driven
    loop's (the plain row on the card)."""
    from repro_torch.core.dendrogram import canonical_order, merges_equivalent
    from repro_torch.data.synthetic import gaussian_mixture

    n = 4096
    X = gaussian_mixture(seed=7, n=n, dim=32, return_labels=False)
    reset_trips()
    got = nnchain.nn_chain_from_points(X, method)
    assert got.n_merges == n - 1
    assert_trip_counts(got.iters)
    W = torch.tensor(X, device=cuda)
    state = nnchain._init_state((W, torch.zeros(n, device=cuda)), n, cuda)
    want = nnchain._chain_loop(nnchain._points_nnchain_ops(method, pairwise.row_sq_euclidean_plain),
                               state, n - 1)
    assert merges_equivalent(canonical_order(got.merges.cpu().numpy(), n=n),
                             canonical_order(want.merges.cpu().numpy(), n=n), n=n,
                             rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", nnchain.REDUCIBLE_METHODS)
def test_cuda_dense_chain_matches_cpu(method, cuda, rng):
    D = random_distance_matrix(rng, 97, squared=method == "ward").astype(np.float32)
    got = nnchain.nn_chain(D, method)
    want = nnchain.nn_chain(D, method, device="cpu")
    assert (got.n_merges, got.iters) == (want.n_merges, want.iters)
    np.testing.assert_array_equal(got.merges.cpu().numpy()[:, [0, 1, 3]],
                                  want.merges.numpy()[:, [0, 1, 3]])
    np.testing.assert_allclose(got.merges.cpu().numpy()[:, 2], want.merges.numpy()[:, 2],
                               rtol=1e-4, atol=1e-5)


def pairwise_tolerance(X, Y):
    """B4's tolerance against its plain version: rtol 1e-4 and an atol of
    1e-6 · max(‖x‖² + ‖y‖²), the scale of the Gram form's cancellation."""
    scale = float((X * X).sum(1).max()) + float((Y * Y).sum(1).max()) if len(X) and len(Y) else 0.0
    return dict(rtol=1e-4, atol=1e-6 * max(scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(70, 130, 7), (300, 300, 50), (1, 1, 1), (257, 65, 1),
                                   (129, 200, 128), (0, 5, 3), (4, 0, 3), (3, 2, 0),
                                   (129, 130, 3), (1000, 6155, 129), (257, 300, 13),
                                   (300, 129, 132)])
def test_cuda_pairwise_matches_plain(n, m, d, cuda, rng):
    """B4 on ragged n, m and d (none a multiple of the 128-row tile or the
    8-column chunk; d % 4 != 0 takes scalar loads), d = 1, an odd m with
    unaligned output rows, and empty operands."""
    X = torch.tensor((rng.normal(size=(n, d)) * 5).astype(np.float32), device=cuda)
    Y = torch.tensor((rng.normal(size=(m, d)) * 5).astype(np.float32), device=cuda)
    before = pairwise.pairwise_sq_euclidean.launches
    got = pairwise.pairwise_sq_euclidean(X, Y)
    want = pairwise.pairwise_sq_euclidean_plain(X, Y)
    torch.cuda.synchronize()
    assert pairwise.pairwise_sq_euclidean.launches == before + (n > 0 and m > 0)
    assert got.shape == (n, m) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **pairwise_tolerance(X, Y))
    assert bool((got >= 0).all())


@pytest.mark.cuda
def test_cuda_pairwise_rejects_bad_operands(cuda):
    X = torch.zeros(16, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pairwise.pairwise_sq_euclidean(X.double(), X.double())
    with pytest.raises(ValueError, match="float32"):
        pairwise.pairwise_sq_euclidean(X, X.half())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise.pairwise_sq_euclidean(X, torch.zeros(16, 16, device=cuda)[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        pairwise.pairwise_sq_euclidean(torch.zeros(8, 16, device=cuda).T, X)
    with pytest.raises(ValueError, match="one device"):
        pairwise.pairwise_sq_euclidean(X, X.cpu())
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        pairwise.pairwise_sq_euclidean(X, X[:, :4])


@pytest.mark.cuda
def test_cuda_ops_pairwise_casts_and_launches_once(cuda, rng):
    from repro_torch.kernels import ops

    X = torch.tensor(rng.normal(size=(100, 20)), device=cuda)          # float64
    pairwise.pairwise_sq_euclidean.launches = 0
    got = ops.pairwise(X[:, ::2])                                       # strided, Y = X
    assert pairwise.pairwise_sq_euclidean.launches == 1 and got.dtype == torch.float32
    Xf = X[:, ::2].float().contiguous()
    torch.testing.assert_close(got, pairwise.pairwise_sq_euclidean_plain(Xf, Xf),
                               **pairwise_tolerance(Xf, Xf))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ("sqeuclidean", "euclidean"))
def test_cuda_assign_kernel_matches_auto(metric, cuda):
    """``assign(backend="kernel")`` launches B4 once and gives the labels of
    the Gram builder, on the card and against the CPU."""
    from repro_torch.core import cluster
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.service.assign import assign, build_index

    pts, _ = gaussian_mixture(seed=0, n=600, dim=16, k=6, spread=8.0)
    Q = gaussian_mixture(seed=0, n=3000, dim=16, k=6, spread=8.0, return_labels=False)
    res = cluster(pts, "ward")
    for kind in ("exemplar", "centroid"):
        idx = build_index(res, 6, kind=kind, metric=metric)
        pairwise.pairwise_sq_euclidean.launches = 0
        got = assign(idx, Q, backend="kernel")
        assert pairwise.pairwise_sq_euclidean.launches == 1
        np.testing.assert_array_equal(got, assign(idx, Q, backend="auto"))
        np.testing.assert_array_equal(got, assign(idx, Q, backend="kernel", device="cpu"))
        assert pairwise.pairwise_sq_euclidean.launches == 1


@pytest.mark.cuda
def test_cuda_landmark_matches_cpu(cuda):
    """The landmark tier on the card: the CPU run's landmarks, groups and
    merges; its chain launches B5's trip entry, its assignment takes the
    Gram builder."""
    from repro_torch.core import landmark
    from repro_torch.data.synthetic import gaussian_mixture

    pts, _ = gaussian_mixture(seed=1, n=2000, dim=16, k=6, spread=10.0)
    reset_trips()
    pairwise.pairwise_sq_euclidean.launches = 0
    got = landmark.landmark_cluster(pts, "ward")
    assert pairwise.chain_trip.launches > 0 and pairwise.row_sq_euclidean.launches == 0
    assert pairwise.pairwise_sq_euclidean.launches == 0
    want = landmark.landmark_cluster(pts, "ward", device="cpu")
    np.testing.assert_array_equal(got.landmarks, want.landmarks)
    np.testing.assert_array_equal(got.group_labels, want.group_labels)
    assert_same_merges(got.merges, want.merges)


@pytest.mark.cuda
def test_cuda_rmsd_matches_cpu(cuda):
    from repro_torch.core import build_distance_matrix
    from repro_torch.core.distance import kabsch_rmsd
    from repro_torch.data.synthetic import conformations

    C, _ = conformations(0, 150, 24)
    got = build_distance_matrix(C, "rmsd")
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), build_distance_matrix(C, "rmsd", device="cpu"),
                               rtol=1e-4, atol=1e-4)
    A, B = torch.tensor(C[:75], device=cuda), torch.tensor(C[75:], device=cuda)
    torch.testing.assert_close(kabsch_rmsd(A, B).cpu(), kabsch_rmsd(A.cpu(), B.cpu()),
                               rtol=1e-4, atol=1e-4)


STAGED_N = 2000     # the kernel plan: (2000, 1000), (1000, 500), (500, 499)


def staged_problem(method, n=STAGED_N):
    D = random_distance_matrix(np.random.default_rng([n, METHODS.index(method)]), n,
                               squared=method in ("centroid", "median", "ward"))
    return D.astype(np.float32)


def kernel_plan(n, n_steps):
    from repro_torch.core import engine

    return engine.plan_stages(n, n_steps, min_stage=engine.KERNEL_MIN_STAGE)


def expected_launches(variant, n_stages, merges):
    """(B1, B2's per-row entry, B2's merge entry, B3's per-row entry, B3's
    lazy merge, B3's rescan) of a staged kernel run: one seed a stage for
    the fused path, one merge launch a merge (two for ``lazy``)."""
    if variant == "lazy":
        return (0, 0, 0, 0, merges, merges)
    return (n_stages, 0, merges, 0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_staged_equals_unstaged(variant, method, cuda):
    """The kernel backend staged (the default knobs: three stages at
    n = 2000) against the same run unstaged, bit for bit; each stage seeds
    once and captures its own graph of 128 merges."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS
    from repro_torch.kernels.ops import lance_williams_kernelized

    n, D = STAGED_N, staged_problem(method)
    plan = kernel_plan(n, n - 1)
    assert [s for s, _ in plan] == [2000, 1000, 500]
    runs = {}
    for compaction in (True, False):
        reset_launches()
        replays = lw_step.MergeGraph.replays
        runs[compaction] = lance_williams_kernelized(D, method, variant=variant,
                                                     compaction=compaction)
        torch.cuda.synchronize()
        stages = plan if compaction else ((n, n - 1),)
        assert launches() == expected_launches(variant, len(stages), n - 1)
        assert lw_step.MergeGraph.replays - replays == sum(
            steps // THRESHOLD_CHECK_TRIPS for _, steps in stages)
    assert runs[True].n_merges == runs[False].n_merges == n - 1
    assert torch.equal(runs[True].merges, runs[False].merges)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("complete", "ward"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_staged_threshold_stops_in_stage_2(variant, method, cuda):
    """A threshold between the heights of merges 1700 and 1701, inside the
    third stage (merges 1500-1998): the unstaged run's merges, bit for bit;
    stages 0-2 seed, and the stage of the stop launches up to the end of
    the chunk that holds it."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS
    from repro_torch.kernels.ops import lance_williams_kernelized

    n, D = STAGED_N, staged_problem(method)
    full = lance_williams_kernelized(D, method, variant=variant, compaction=False)
    h = full.merges[:, 2].cpu().numpy()
    thr = float((h[1700] + h[1701]) / 2)
    reset_launches()
    got = lance_williams_kernelized(D, method, variant=variant, distance_threshold=thr)
    # merges 0-1499 in stages 0 and 1, then two chunks of stage 2 (1500-1755)
    assert launches() == expected_launches(variant, 3, 1500 + 2 * THRESHOLD_CHECK_TRIPS)
    want = lance_williams_kernelized(D, method, variant=variant, distance_threshold=thr,
                                     compaction=False)
    assert got.n_merges == want.n_merges == 1701
    assert torch.equal(got.merges, want.merges)
    assert torch.equal(got.merges[:1701], full.merges[:1701]) and not got.merges[1701:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("baseline", "lazy"))
def test_cuda_staged_loop_reads_nothing_back(variant, cuda):
    """The staged kernel loop, no threshold, under the sync debug mode
    "error": no stage boundary (the sort, the gathers, the remap, the new
    buffers, the seed, the graph capture) and no merge waits for the card."""
    from repro_torch.core import engine
    from repro_torch.kernels.ops import lance_williams_kernelized

    n, method = STAGED_N, "complete"
    D = torch.tensor(staged_problem(method), device=cuda)
    want = lance_williams_kernelized(D, method, variant=variant, compaction=False)
    D = engine.symmetrize(D)
    alive = torch.ones(n, dtype=torch.bool, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engine.run_kernel(D, alive, method=method, n_steps=n - 1, variant=variant,
                                compaction=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.merges, want.merges)


# ---------------------------------------------------------------------------
# the batch-grid forms of B1, B2 and B3, and the batched kernel engine
# ---------------------------------------------------------------------------

BATCH_BUCKETS = (8, 64, 1024)
# B2's batch form: 7 lanes at every row width it plans for, on each side of each cut of
# merge_batch_plan (rows in registers, 4 threads and 1, 2, 4 or 8 float4 a thread; bulk-copied
# rows, 4, 8, 16 or 32 threads a row; a warp a row in registers where n % 4 != 0; clusters of
# 4 and 8 blocks), and rows copied in 1024-column chunks (2048, 4096)
MERGE_BATCH_BUCKETS = (8, 16, 17, 32, 33, 64, 65, 127, 128, 129, 256, 512, 1023, 1024, 2048,
                       4096)
# (lanes, n): one lane; a block a lane on the bulk path (B >= 66); clusters of 2 (rows in
# registers, n % 4 != 0) and 4 (odd B); 3 lanes of chunked rows
MERGE_BATCH_LANES = ((1, 16), (1, 256), (133, 256), (133, 1024), (67, 300), (33, 301), (17, 300),
                     (3, 2048))


def batch_lanes(n, lanes=7):
    """Each bucket's real sizes: an empty lane, one slot, two, the full
    bucket, and a few in between, repeated to ``lanes`` lanes."""
    sizes = (0, 1, 2, n, max(n // 2, 3), n - 1, 3)
    return tuple(sizes[b % len(sizes)] for b in range(lanes))


def batch_state(rng, n, method, device, lanes=7):
    """A bucket as the batched engine holds it after its seed: stacked
    symmetric matrices (padding zero), liveness, sizes, every lane's masked
    first minimum, and each lane's merge limit (its real merges)."""
    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch

    n_real = batch_lanes(n, lanes)
    B = len(n_real)
    D = torch.zeros((B, n, n), device=device)
    for b, k in enumerate(n_real):      # random_distance_matrix's, built on the card
        X = torch.tensor(rng.normal(size=(k, 4)), device=device)
        Dk = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        D[b, :k, :k] = Dk if method in ("centroid", "median", "ward") else Dk.sqrt()
    alive = torch.arange(n, device=device) < torch.tensor(n_real, device=device)[:, None]
    sizes = alive.to(torch.float32)
    limit = torch.tensor([max(k - 1, 0) for k in n_real], device=device)
    rmin, rarg = masked_row_mins_batch(D, alive)
    return D, alive, sizes, limit, (rmin, rarg), cached_cand_batch(alive, rmin, rarg), n_real


def fused_batch(state, device, cap):
    D, alive, sizes, limit, _, cand, _ = state
    merges = torch.zeros((D.shape[0], cap, 4), device=device)
    return lw_step.merge_batch_buffers(D.clone(), alive.clone(), sizes.clone(), merges, cand, 0,
                                       limit)


def lazy_batch(state, device, cap):
    D, alive, sizes, limit, (rmin, rarg), cand, _ = state
    merges = torch.zeros((D.shape[0], cap, 4), device=device)
    return lw_update.lazy_batch_buffers(D.clone(), alive.clone(), sizes.clone(), merges, cand,
                                        (rmin.clone(), rarg.clone()), 0, limit)


def assert_batch_equal(got, want, skip=("stale",)):
    for name, a, b in zip(type(got)._fields, got, want):
        if name not in skip:
            assert torch.equal(a, b), f"{name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("n", BATCH_BUCKETS)
def test_cuda_masked_argmin_batch_matches_plain_and_single(n, cuda, rng):
    """B1's batch form against its plain twin and against one single-problem
    launch a lane (empty, one-slot and full lanes among them), bit for bit."""
    D, alive, *_ = batch_state(rng, n, "complete", cuda)
    alive[3, 1::3] = False                       # dead slots inside a full lane
    launches = minscan.masked_argmin_batch.launches
    v, flat = minscan.masked_argmin_batch(D, alive)
    assert minscan.masked_argmin_batch.launches == launches + 1
    vp, flatp = minscan.masked_argmin_batch_plain(D, alive)
    assert torch.equal(v, vp) and torch.equal(flat, flatp)
    for b in range(D.shape[0]):
        vs, fs = minscan.masked_argmin(D[b], alive[b])
        assert (float(vs), int(fs)) == (float(v[b]), int(flat[b])), b


# B1's batch form on each path of argmin_batch_plan, (lanes, n): a warp a lane (float4 loads,
# and single floats where n % 4 != 0); a block a lane with rows in registers (4 threads a row
# and 4 float4 at n = 64; one pass of 512 threads at 127, 128 and, unaligned, 255); a block a
# lane on the bulk-copy path (B >= 66 at n = 256, 300; 1024-column chunks at (67, 2048));
# clusters of 2 (rows in registers, one pass of 512 threads, at n = 256 and, a warp a row, at
# n = 301), 4 and 8 (bulk copies); chunked rows in clusters at 2048 and 4096
ARGMIN_BATCH_LANES = ((5, 8), (9, 16), (9, 17), (9, 32), (7, 64), (7, 127), (7, 128),
                      (67, 255), (133, 256), (66, 256), (33, 256), (17, 512), (7, 1024),
                      (67, 300), (17, 300), (33, 301), (17, 301), (67, 2048), (3, 2048),
                      (2, 4096))
ARGMIN_BATCH_STATES = ("prefix", "scattered", "span_lo", "last_slot", "row_tie", "column_tie")


def argmin_batch_state(rng, lanes, n, state, device):
    """A bucket of random distances and a liveness ``state``: each lane a
    live prefix of batch_lanes' sizes (empty, padding and one-slot lanes
    among them); dead slots at random; a live span from a slot that is not
    a multiple of 4; only slot n - 1 live (no live cell); all live with the
    minimum twice, in an early row and a late one (owned by different
    blocks of a cluster), or twice in one row (the first column wins)."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
    D = torch.rand((lanes, n, n), generator=gen, device=device) + 1.0
    ks = torch.arange(n, device=device)
    if state == "prefix":
        alive = ks < torch.tensor(batch_lanes(n, lanes), device=device)[:, None]
    elif state == "scattered":
        alive = torch.tensor(rng.random((lanes, n)) > 0.4, device=device)
        alive[0] = False                          # an empty lane
    elif state == "span_lo":
        lo = torch.tensor([1 + b % 3 for b in range(lanes)], device=device)[:, None]
        hi = torch.tensor([n - b % 5 for b in range(lanes)], device=device)[:, None]
        alive = (ks >= lo) & (ks < hi)
    elif state == "last_slot":
        alive = (ks == n - 1).expand(lanes, n).clone()
    else:
        alive = torch.ones((lanes, n), dtype=torch.bool, device=device)
        if state == "row_tie":   # in row 2 and in row n - 3: the earlier row wins
            D[:, 2, 5] = D[:, n - 3, 1] = -1.0
        else:                    # in one row at columns 3 and n - 2: the first column wins
            D[:, n // 2, 3] = D[:, n // 2, n - 2] = -1.0
    return D, alive


@pytest.mark.cuda
@pytest.mark.parametrize("state", ARGMIN_BATCH_STATES)
@pytest.mark.parametrize("lanes,n", ARGMIN_BATCH_LANES)
def test_cuda_masked_argmin_batch_plan_paths(lanes, n, state, cuda, rng):
    """B1's batch form on every plan path and liveness state against its
    plain twin and one single-problem launch a lane, bit for bit, one
    launch a call; ties go to the first row, then the first column, across
    a cluster's blocks."""
    D, alive = argmin_batch_state(rng, lanes, n, state, cuda)
    launches = minscan.masked_argmin_batch.launches
    v, flat = minscan.masked_argmin_batch(D, alive)
    assert minscan.masked_argmin_batch.launches == launches + 1
    vp, flatp = minscan.masked_argmin_batch_plain(D, alive)
    assert torch.equal(v, vp) and torch.equal(flat, flatp)
    single = [minscan.masked_argmin(D[b], alive[b]) for b in range(lanes)]
    assert torch.equal(torch.stack([s[0] for s in single]), v)
    assert torch.equal(torch.stack([s[1] for s in single]), flat)
    if state in ("last_slot", "prefix"):        # no live cell: (+inf, 0)
        none = alive.sum(1) < 2
        assert torch.isinf(v[none]).all() and (flat[none] == 0).all()
    if state == "row_tie":
        assert (v == -1.0).all() and (flat == 2 * n + 5).all()
    if state == "column_tie":
        assert (v == -1.0).all() and (flat == n // 2 * n + 3).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n", ((4096, 16), (4096, 17), (256, 64), (256, 127), (256, 128),
                                     (256, 255), (33, 256), (256, 256), (256, 1024), (64, 512),
                                     (16, 1024), (16, 2048), (2, 4096), (16, 1023)))
def test_cuda_masked_argmin_batch_no_spills(lanes, n, cuda):
    """Every kernel B1's batch form launches keeps its registers: no local
    (spilled) bytes, and at least one block an SM."""
    res = minscan.argmin_batch_resources(n, lanes=lanes, aligned=n % 4 == 0)
    assert res["local_bytes"] == 0 and res["blocks_per_sm"] >= 1, res


@pytest.mark.cuda
def test_cuda_masked_argmin_batch_refuses(cuda, monkeypatch):
    """No fallback: a plan the kernel cannot take raises, and so do lanes
    past 4096 slots; an empty batch launches nothing."""
    D = torch.rand((3, 256, 256), device=cuda)
    alive = torch.ones((3, 256), dtype=torch.bool, device=cuda)
    warp_plan = minscan.ArgminPlan(0, 4, 128, 1)          # a warp a lane: rows of up to 32 only
    monkeypatch.setattr(minscan, "argmin_batch_plan", lambda *a, **k: warp_plan)
    launches = minscan.masked_argmin_batch.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        minscan.masked_argmin_batch(D, alive)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="4096"):
        minscan.masked_argmin_batch(torch.zeros((1, 4097, 4097), device=cuda),
                                    torch.ones((1, 4097), dtype=torch.bool, device=cuda))
    v, flat = minscan.masked_argmin_batch(D[:0], alive[:0])
    assert v.shape == flat.shape == (0,)
    assert minscan.masked_argmin_batch.launches == launches


def check_merge_batch(rng, n, method, cuda, lanes=7):
    """B2's batch merge entry over lockstep merges past every lane's limit:
    against its plain twin (every buffer, bit for bit) and against the
    single-problem merge entry launched on each lane alone as many times as
    its limit (the lanes of 0, 1 and 2 slots and the full bucket among
    them); the key and the tickets end as they began, and each launch adds
    one to the counter."""
    state = batch_state(rng, n, method, cuda, lanes)
    steps = min(n + 1, 40)
    launches = lw_step.lw_merge_batch.launches
    bk, bp = fused_batch(state, cuda, n), fused_batch(state, cuda, n)
    sync = bk.sync.clone()
    for _ in range(steps):
        lw_step.lw_merge_batch(method, bk)
        lw_step.lw_merge_batch_plain(method, bp)
    torch.cuda.synchronize()
    assert lw_step.lw_merge_batch.launches == launches + steps
    assert_batch_equal(bk, bp)
    assert torch.equal(bk.sync, sync)
    assert bk.count.tolist() == [steps] * len(state[-1])
    D, alive, sizes, limit, _, (r, c, v), n_real = state
    for b in range(D.shape[0]):
        cand = (r[b], c[b], v[b])
        single = lw_step.merge_buffers(D[b].clone(), alive[b].clone(), sizes[b].clone(),
                                       torch.zeros((n, 4), device=cuda), cand, 0)
        for _ in range(min(steps, int(limit[b]))):
            lw_step.lw_merge(method, single)
        for name in ("D", "alive", "bits", "sizes", "merges", "cand", "dmin", "rmin", "rarg"):
            assert torch.equal(getattr(single, name).reshape(-1),
                               getattr(bk, name)[b].reshape(-1)), (b, n_real[b], name)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", MERGE_BATCH_BUCKETS)
def test_cuda_lw_merge_batch_matches_plain_and_single(method, n, cuda, rng):
    """B2's batch form on 7 lanes (an empty, one-slot and two-slot lane, the
    full bucket, ...) at every ownership path and on each side of each cut:
    see :func:`check_merge_batch`."""
    check_merge_batch(rng, n, method, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("lanes,n", MERGE_BATCH_LANES)
def test_cuda_lw_merge_batch_lane_counts(method, lanes, n, cuda, rng):
    """B2's batch form at lane counts that change its plan (one lane; a
    block a lane from 132 lanes on; clusters of 2 and 4 blocks), finished
    and padding lanes among them: see :func:`check_merge_batch`."""
    check_merge_batch(rng, n, method, cuda, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("lanes,n", ((4096, 16), (1024, 32), (256, 64), (256, 127), (256, 128),
                                     (256, 256), (256, 512), (256, 1024), (64, 256), (64, 512),
                                     (16, 1024), (256, 2048), (16, 2048), (256, 1023),
                                     (16, 1023)))
def test_cuda_lw_merge_batch_spills_nothing(method, lanes, n, cuda):
    """Every instantiation of B2's batch form that a plan takes (rows in
    registers or bulk-copied, each row group, a block or a cluster a lane)
    spills nothing: no local bytes."""
    got = lw_step.kernel_resources(method, n, "lw_merge_batch", lanes=lanes)
    assert got["local_bytes"] == 0, (str(lw_step.merge_batch_plan(lanes, n)), got)


# B3's batch form: every path of lazy_batch_plan (a block a lane with 4, 8, 16 and 32
# threads a stale row and blocks of 32, 64, 128 and 256 threads, at 300 unaligned; rows past
# 1024 slots by clusters of 2 (66 lanes), 4 (17 lanes, 2044 unaligned) and 8 (7 lanes), and
# by one block of 256 a lane (67 lanes) or a cluster of 2 (34 lanes of 4096) whose blocks
# update 2048 columns each in passes; a stale row to a warp or, where a block has few, to
# the block)
LAZY_BATCH_SHAPES = ((7, 8), (7, 16), (7, 32), (7, 64), (7, 128), (7, 300), (7, 512),
                     (7, 1024), (66, 2048), (17, 2044), (7, 2048), (7, 4096), (67, 2048),
                     (34, 4096))

def check_lazy_batch(state, method, cuda, steps):
    """B3's batch merge over ``steps`` lockstep merges: against its plain
    twin (every buffer but the stale list, bit for bit) and against the
    single-problem lazy merge launched on each lane alone as many times as
    its limit allows; one launch a lockstep merge, n_stale as it began (0).
    Returns the batch buffers."""
    n = state[0].shape[-1]
    bk, bp = lazy_batch(state, cuda, n), lazy_batch(state, cuda, n)
    merges = lw_update.lazy_merge_batch.launches
    for _ in range(steps):
        lw_update.lazy_merge_batch(method, bk)
        lw_update.lazy_merge_batch_plain(method, bp)
    torch.cuda.synchronize()
    assert lw_update.lazy_merge_batch.launches == merges + steps
    assert_batch_equal(bk, bp)
    assert not bk.n_stale.any()
    D, alive, sizes, limit, (rmin, rarg), (r, c, v), n_real = state
    for b in range(D.shape[0]):
        single = lw_update.lazy_buffers(D[b].clone(), alive[b].clone(), sizes[b].clone(),
                                        torch.zeros((n, 4), device=cuda), (r[b], c[b], v[b]),
                                        (rmin[b].clone(), rarg[b].clone()), 0)
        for _ in range(min(steps, int(limit[b]))):
            lw_update.lazy_merge(method, single)
        for name in ("D", "alive", "sizes", "merges", "cand", "dmin", "rmin", "rarg",
                     "rescanned"):
            assert torch.equal(getattr(single, name).reshape(-1),
                               getattr(bk, name)[b].reshape(-1)), (b, n_real[b], name)
    return bk


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("lanes,n", LAZY_BATCH_SHAPES)
def test_cuda_lazy_merge_batch_matches_plain_and_single(method, lanes, n, cuda, rng):
    """B3's batch merge (the update and the rescan in one launch) over
    lockstep merges past the limit of every lane of up to 39 slots (the
    empty, one-slot, two-slot and three-slot lanes everywhere), on every
    path of its plan: see :func:`check_lazy_batch`."""
    check_lazy_batch(batch_state(rng, n, method, cuda, lanes), method, cuda, min(n + 1, 40))


def star_state(rng, n, method, device, lanes=7):
    """:func:`batch_state` with its full lane (lane 3) replaced by a star:
    slots 0 and 1 the closest pair (0.1), every other slot nearest to slot
    0 (1.0; 1.5 to slot 1; 2 and up to the others), so that the first merge
    leaves every other live row's cache stale for every method."""
    from repro_torch.core.batch_engine import cached_cand_batch, masked_row_mins_batch

    D, alive, sizes, limit, _, _, n_real = batch_state(rng, n, method, device, lanes)
    far = torch.tensor(2 + rng.random((n, n)), dtype=torch.float32, device=device)
    star = torch.triu(far, 1) + torch.triu(far, 1).T
    star[0, 2:] = star[2:, 0] = 1.0
    star[1, 2:] = star[2:, 1] = 1.5
    star[0, 1] = star[1, 0] = 0.1
    D[3] = star
    rmin, rarg = masked_row_mins_batch(D, alive)
    return D, alive, sizes, limit, (rmin, rarg), cached_cand_batch(alive, rmin, rarg), n_real


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("lanes,n", ((7, 16), (7, 64), (7, 300), (7, 1024), (7, 2048),
                                     (7, 4096), (67, 2048), (34, 4096)))
def test_cuda_lazy_merge_batch_every_row_stale(method, lanes, n, cuda, rng):
    """A merge that leaves every live row but i and j stale (n - 2 rows to
    rescan in one lockstep merge, dealt out over a block's or a cluster's
    row groups): its lane rescans them all, and the batch equals its plain
    twin and the single lazy merge, then and over the merges that follow."""
    state = star_state(rng, n, method, cuda, lanes)
    bk = check_lazy_batch(state, method, cuda, 1)
    assert int(bk.rescanned[3]) == n - 2
    check_lazy_batch(state, method, cuda, min(n + 1, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("lanes,n", ((4096, 16), (1024, 32), (256, 64), (256, 128), (256, 300),
                                     (256, 1024), (66, 2048), (17, 2048), (7, 4096)))
def test_cuda_lazy_merge_batch_spills_nothing(method, lanes, n, cuda):
    """Every instantiation of B3's batch form that a plan takes (4, 8, 16
    and 32 threads a stale row; blocks of 32, 64, 128 and 256 threads; a
    block or a cluster of 2, 4 or 8 a lane) spills nothing: no local
    bytes; and at least one block fits an SM."""
    got = lw_update.lazy_batch_resources(method, n, lanes=lanes)
    assert got["local_bytes"] == 0, (str(lw_update.lazy_batch_plan(lanes, n)), got)
    assert got["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant,lanes,n", (
    *(("baseline", 7, n) for n in (16, 32, 64, 97, 128, 257, 300, 2048)), ("baseline", 133, 256),
    ("baseline", 33, 256), ("baseline", 17, 300),
    *(("lazy", 7, n) for n in (16, 128, 300, 1024, 4096)), ("lazy", 66, 2048),
    ("lazy", 17, 2044)))
def test_cuda_batch_graph_replays_eager_merges(variant, lanes, n, cuda, rng):
    """A captured graph of lockstep batch merges gives the eager launches'
    buffers, and each replay adds its merges to the entries' counters; for
    B2's batch form on each path of its plan (rows in registers with 1, 2,
    4 and 8 float4 a thread and a warp a row, bulk-copied rows whole and in
    chunks, a block a lane and clusters of 2, 4 and 8 blocks: the cluster
    launch is captured too), and for B3's (a block a lane with 4 and 32
    threads a stale row, 300 unaligned; clusters of 2, 4 (2044 unaligned)
    and 8)."""
    from repro_torch.core.engine import THRESHOLD_CHECK_TRIPS as k

    state = batch_state(rng, n, "ward", cuda, lanes)
    make, merge = ((fused_batch, lw_step.lw_merge_batch) if variant == "baseline"
                   else (lazy_batch, lw_update.lazy_merge_batch))
    eager, replayed = make(state, cuda, n), make(state, cuda, n)
    for _ in range(2 * k):
        merge("ward", eager)
    graph = lw_step.MergeGraph("ward", replayed, k, merge=merge)
    counts = [f.launches for f in merge.counters]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert [f.launches for f in merge.counters] == [c + 2 * k for c in counts]
    assert_batch_equal(replayed, eager)


def batch_problems(method, sizes, seed=20):
    rng = np.random.default_rng([seed, METHODS.index(method)])
    return [random_distance_matrix(rng, n, squared=method in ("centroid", "median", "ward"))
            .astype(np.float32) for n in sizes]


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_cluster_batch_matches_single_and_cpu(method, variant, cuda):
    """``cluster_batch`` on both backends on the card: every problem's
    merges equal its single-problem run on the card bit for bit, and the
    CPU batch's slots, under ``stop_at_k`` and a threshold too."""
    from repro_torch.core import cluster, cluster_batch

    probs = batch_problems(method, (5, 8, 13, 16, 3, 30, 2, 61))
    thr = float(np.median(probs[5]))
    for backend in ("serial", "kernel"):
        for knobs in ({}, {"stop_at_k": 3}, {"distance_threshold": thr}):
            got = cluster_batch(probs, method, backend=backend, variant=variant, **knobs)
            cpu = cluster_batch(probs, method, backend=backend, variant=variant,
                                device="cpu", **knobs)
            for p, g, c in zip(probs, got, cpu):
                want = cluster(p, method, algorithm="lw", backend=backend, variant=variant,
                               **knobs).merges
                assert np.array_equal(g.merges, want), (backend, knobs, len(p))
                assert_same_merges(g.merges, c.merges)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("baseline", "lazy"))
def test_cuda_staged_batch_reads_nothing_back(variant, cuda):
    """The staged batched kernel loop (bucket 512: 512 → 256), no
    threshold, under the sync debug mode "error": no stage boundary and no
    lockstep merge waits for the card.  Equal to the unstaged batch and to
    each lane's single-problem run, bit for bit."""
    from repro_torch.core import batch_engine, engine
    from repro_torch.kernels.ops import lance_williams_kernelized

    n, method = 512, "complete"
    probs = batch_problems(method, (512, 300, 2, 400), seed=21)
    Db = np.zeros((4, n, n), np.float32)
    for b, p in enumerate(probs):
        Db[b, :len(p), :len(p)] = p
    n_real = torch.tensor([len(p) for p in probs], device=cuda)

    def bucket():
        D = engine.symmetrize(torch.tensor(Db, device=cuda))
        return D, torch.arange(n, device=cuda) < n_real[:, None]

    want = batch_engine.run_kernel_batch(*bucket(), method=method, n_steps=n - 1,
                                         variant=variant, compaction=False)
    D, alive = bucket()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = batch_engine.run_kernel_batch(D, alive, method=method, n_steps=n - 1,
                                            variant=variant, compaction=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.merges, want.merges) and torch.equal(got.n_merges, want.n_merges)
    for b, p in enumerate(probs):
        single = lance_williams_kernelized(p, method, variant=variant)
        k = len(p) - 1
        assert int(got.n_merges[b]) == k
        assert torch.equal(got.merges[b, :k], single.merges[:k])


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_cuda_batch_merges_stable_under_load(method, cuda):
    """The batch entries' per-lane last-block protocol under load: a matrix
    product loop on a second stream while ``cluster_batch(backend=
    "kernel")`` runs again and again (B2's batch merge and B3's, each
    replayed from graphs): every run equals the first bit for bit and the
    CPU's slot for slot."""
    from repro_torch.core import cluster_batch

    a = torch.randn(4096, 4096, device=cuda)
    c = torch.empty_like(a)
    load = torch.cuda.Stream(device=cuda)
    probs = batch_problems(method, (300, 97, 250, 2, 180, 300, 33, 140), seed=22)
    for variant in ("baseline", "lazy"):
        want = cluster_batch(probs, method, backend="kernel", variant=variant, device="cpu")
        first = None
        for run in range(STRESS_GRAPH_RUNS):
            if run % 4 == 0:
                with torch.cuda.stream(load):
                    for _ in range(8):
                        torch.matmul(a, a, out=c)
            got = cluster_batch(probs, method, backend="kernel", variant=variant)
            if first is None:
                first = got
                for g, w in zip(got, want):
                    assert_same_merges(g.merges, w.merges)
            for b, (g, f) in enumerate(zip(got, first)):
                assert np.array_equal(g.merges, f.merges), (variant, run, b)
    load.synchronize()


# ---------------------------------------------------------------------------
# bucket programs and the service on the card
# ---------------------------------------------------------------------------


def program_buckets(seed, squared=False):
    """Two different buckets of bucket 512 (a two-stage kernel plan): ragged
    problems, then fewer of other sizes."""
    rng = np.random.default_rng(seed)
    return ([random_distance_matrix(rng, n, squared=squared).astype(np.float32)
             for n in (512, 300, 2, 400)],
            [random_distance_matrix(rng, n, squared=squared).astype(np.float32)
             for n in (260, 511)])


@pytest.mark.cuda
@pytest.mark.parametrize("variant,threshold", (("baseline", False), ("lazy", False),
                                               ("rowmin", True)))
def test_cuda_program_replayed_across_buckets_equals_fresh(variant, threshold, cuda):
    """One kernel-engine program (its graphs captured when it is built) runs
    bucket A, bucket B and A again: each run's merges equal a fresh
    ``cluster_batch`` of the same problems on the card bit for bit, and the
    runs capture no graph."""
    from repro_torch.core.batched import BucketProgram, bucket_signature, cluster_batch_merges

    sig = bucket_signature(512, 4, method="ward", engine="kernel", variant=variant,
                           with_threshold=threshold)
    assert sig.compaction
    thr = 4.0 if threshold else None
    captures0 = lw_step.MergeGraph.captures
    prog = BucketProgram(sig, cuda, eager=True)
    assert lw_step.MergeGraph.captures == captures0 + 2      # one graph a stage
    A, B = program_buckets(23, squared=True)
    for probs in (A, B, A):
        captures0 = lw_step.MergeGraph.captures
        merges, n_merges = prog.run(probs, thr)
        merges, n_merges = merges.cpu().numpy(), n_merges.cpu().numpy()
        assert lw_step.MergeGraph.captures == captures0     # a run captures nothing
        want, _ = cluster_batch_merges(probs, "ward", engine="kernel", variant=variant,
                                       distance_threshold=thr)
        for b, (p, w) in enumerate(zip(probs, want)):
            got = merges[b, : min(len(p) - 1, int(n_merges[b]))]
            assert np.array_equal(got, w), (variant, len(p))


@pytest.mark.cuda
def test_cuda_one_shot_program_builds_a_stage_when_reached(cuda):
    """A one-shot kernel program (``cluster_batch``'s) captures no graph
    when it is built, and a threshold run that stops in the first stage
    captures only that stage's; its merges equal a cached (eager)
    program's."""
    from repro_torch.core.batched import BucketProgram, bucket_signature

    sig = bucket_signature(512, 4, method="ward", engine="kernel", with_threshold=True)
    A, _ = program_buckets(26, squared=True)
    eager = BucketProgram(sig, cuda, eager=True)
    want, want_n = (t.cpu().numpy() for t in eager.run(A, 0.3))
    assert int(want_n.max()) < 256                          # stops in stage 0 (512 → 256)
    captures0 = lw_step.MergeGraph.captures
    prog = BucketProgram(sig, cuda)
    assert lw_step.MergeGraph.captures == captures0
    assert prog.nbytes < eager.nbytes
    got, got_n = (t.cpu().numpy() for t in prog.run(A, 0.3))
    assert lw_step.MergeGraph.captures == captures0 + 1
    assert np.array_equal(got_n, want_n)
    for b, p in enumerate(A):
        k = min(len(p) - 1, int(want_n[b]))
        assert np.array_equal(got[b, :k], want[b, :k])


@pytest.mark.cuda
def test_cuda_service_points_on_a_dense_bucket_equal_cluster_batch(cuda):
    """Points that ride a dense LW bucket get their matrix built on the
    card, on the worker, as ``cluster_batch`` builds it: the merges equal
    ``cluster_batch`` of the same points bit for bit, on both engines."""
    from repro_torch.core import cluster_batch
    from repro_torch.service import ClusteringService, ServiceConfig

    rng = np.random.default_rng(27)
    pts = [rng.normal(size=(int(n), 16)).astype(np.float32) for n in rng.integers(5, 200, 24)]
    for engine in ("serial", "kernel"):
        cfg = ServiceConfig(method="ward", engine=engine, algorithm="lw",
                            bucket_ns=(8, 16, 32, 64, 128, 256), max_batch=8,
                            max_delay_ms=2.0)
        with ClusteringService(cfg) as svc:
            got = [f.result(timeout=300) for f in svc.submit_many(pts, metric="sqeuclidean")]
        want = cluster_batch(pts, "ward", metric="sqeuclidean", backend=engine, algorithm="lw")
        for g, w in zip(got, want):
            assert g.distances.device.type == "cuda"
            assert np.array_equal(g.merges, w.merges), (engine, g.n)


@pytest.mark.cuda
def test_cuda_service_miss_captures_on_the_worker_while_another_thread_uploads(cuda):
    """An unwarmed kernel-engine service builds its programs (and captures
    their graphs) on its worker while another thread keeps copying to the
    card: every request is served, equal to ``cluster_batch``."""
    import threading

    from repro_torch.core import cluster_batch
    from repro_torch.service import ClusteringService, ServiceConfig

    stop = threading.Event()
    host = np.random.default_rng(0).normal(size=(1 << 20,)).astype(np.float32)

    def upload():
        while not stop.is_set():
            t = torch.tensor(host, device=cuda)
            (t * 2).sum().item()

    uploader = threading.Thread(target=upload, daemon=True)
    A, B = program_buckets(24)
    probs = A + B
    cfg = ServiceConfig(engine="kernel", bucket_ns=(512,), max_batch=4, max_delay_ms=1.0)
    uploader.start()
    try:
        with ClusteringService(cfg) as svc:
            got = [f.result(timeout=300) for f in svc.submit_many(probs)]
            assert svc.cache.stats.compiles >= 1
    finally:
        stop.set()
        uploader.join(timeout=60)
    want = cluster_batch(probs, "complete", backend="kernel")
    for g, w in zip(got, want):
        assert np.array_equal(g.merges, w.merges)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ("serial", "kernel"))
def test_cuda_service_steady_traffic_captures_nothing(engine, cuda):
    """A warmed service on the card: steady traffic builds no program and
    captures no graph, the kernel engine launches only the batch kernels
    (from its programs' graphs), and every response equals
    ``cluster_batch``'s bit for bit."""
    from repro_torch.core import cluster_batch
    from repro_torch.kernels.pairwise import TripGraph
    from repro_torch.service import ClusteringService, ServiceConfig, engine_jit_cache_size

    rng = np.random.default_rng(25)
    probs = [random_distance_matrix(rng, int(n)).astype(np.float32)
             for n in rng.integers(100, 257, 24)]
    cfg = ServiceConfig(engine=engine, bucket_ns=(128, 256), max_batch=8, max_delay_ms=2.0)
    with ClusteringService(cfg) as svc:
        svc.warmup()
        built, captures = engine_jit_cache_size(), lw_step.MergeGraph.captures
        trips = TripGraph.captures
        batch_entries = (minscan.masked_argmin_batch, lw_step.lw_merge_batch)
        singles = (minscan.masked_argmin, lw_step.lw_step, lw_step.lw_merge,
                   lw_update.lw_update, lw_update.lazy_merge, lw_update.lazy_merge_batch)
        for f in batch_entries + singles:
            f.launches = 0
        got = [f.result(timeout=300) for f in svc.submit_many(probs)]
        assert engine_jit_cache_size() == built
        assert (lw_step.MergeGraph.captures, TripGraph.captures) == (captures, trips)
    assert all(f.launches == 0 for f in singles)
    assert all((f.launches > 0) == (engine == "kernel") for f in batch_entries)
    want = cluster_batch(probs, "complete", backend=engine, is_distance=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.merges, w.merges)
