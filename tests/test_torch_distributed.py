"""The paper's distributed Lance-Williams loop in the port
(:mod:`repro_torch.core.distributed`), on p gloo ranks on the CPU.

Each group of ranks runs in processes of its own (:func:`run_ranks`: one
process a rank over a ``file://`` store, one torch thread each, a timeout
that fails a hung collective), computes many cases in one go and pickles
its results; every rank must return the same.  The tests then hold them
against the JAX package's serial ``lance_williams`` and distance builders
(run here, in the test process, on the same numpy inputs), against the
port's serial backend bit for bit, and against ``repro.core.naive``: the
reference's own multi-device tests of the knobs partly fail in this
sandbox (ROADMAP.md §C), so the port's serial backend is the yardstick
there.  p = 1 runs in the test process, its group torn down after each
test.
"""

import functools
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.core import cluster, cluster_batch  # noqa: E402
from repro_torch.core.distance import (  # noqa: E402
    pairwise_cosine,
    pairwise_euclidean,
    pairwise_rmsd,
    pairwise_sq_euclidean,
)
from repro_torch.core.distributed import (  # noqa: E402
    distributed_lance_williams,
    distributed_pairwise,
    flatten_mesh,
    make_cluster_mesh,
    pad_to_mesh,
    require_ring_mesh,
)
from repro_torch.core.engine import VARIANTS, plan_stages  # noqa: E402
from repro_torch.core.lance_williams import lance_williams  # noqa: E402
from repro_torch.core.linkage import METHODS  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from repro_torch.distributed import replicate, shard_rows  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"

#: Seconds a group of ranks may take, collectives included: a hung
#: collective fails the group instead of hanging the run.
GROUP_TIMEOUT_S = 120

#: The methods of the reference's test_distributed_lw.py.
REF_METHODS = ("single", "complete", "average", "weighted", "ward")
LW_N = (24, 37)                     # 37 takes the padding path at p = 3 and 8
STOP_KNOBS = (dict(stop_at_k=4), dict(stop_at_k=37), dict(stop_at_k=50),
              dict(distance_threshold=0.0), dict(distance_threshold=1.0),
              dict(distance_threshold=2.0), dict(distance_threshold=1e9))
COMPACT_N = 128                     # plan_stages(128, 127, align=p): 3 stages at p = 2 and 4
BATCH_SIZES = (5, 9, 17, 33, 12, 64, 7)     # 7 problems over buckets 8, 16, 32 and 64
BATCH_KNOBS = (("complete", {}), ("centroid", dict(variant="lazy")),
               ("ward", dict(stop_at_k=3, variant="rowmin")),
               ("average", dict(distance_threshold=1.5)))


# ---------------------------------------------------------------------------
# the inputs, made from seeds with numpy on every rank and in the test process
# ---------------------------------------------------------------------------


def lw_inputs() -> dict:
    """The matrices of the reference's test_distributed_lw.py."""
    rng = np.random.default_rng(1)
    out = {}
    for n in LW_N:
        X = rng.normal(size=(n, 5))
        out[n] = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    return out


def pairwise_inputs():
    """The points and conformations of test_distributed_lw.py's build test."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(30, 4)).astype(np.float32)
    C = rng.normal(size=(12, 7, 3)).astype(np.float32)
    return X, C


def compact_input() -> np.ndarray:
    X = np.random.default_rng(5).normal(size=(COMPACT_N, 6))
    return np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)).astype(np.float32)


def batch_problems() -> list:
    rng = np.random.default_rng(4)
    out = []
    for n in BATCH_SIZES:
        X = rng.normal(size=(n, 6))
        out.append(np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)).astype(np.float32))
    return out


def api_input():
    return gaussian_mixture(0, 96, 8, k=4)


# ---------------------------------------------------------------------------
# what each rank runs (module-level: the ranks import this module)
# ---------------------------------------------------------------------------


def _merges(res) -> np.ndarray:
    return res.merges[: res.n_merges].numpy()


def _pairwise_cases(ring) -> dict:
    X, C = pairwise_inputs()
    built = {kind: distributed_pairwise(X, kind, ring) for kind in ("sqeuclidean", "euclidean",
                                                                    "cosine")}
    built["rmsd"] = distributed_pairwise(C, "rmsd", ring)
    return dict(
        pairwise={kind: S.gather().numpy() for kind, S in built.items()},
        born={kind: (_merges(distributed_lance_williams(S, "complete", ring)),
                     _merges(distributed_lance_williams(S.gather(), "complete", ring)),
                     tuple(S.block.shape))
              for kind, S in built.items()},
    )


def ranks_p8() -> dict:
    """p = 8: the reference test's 5 methods x 3 variants at n = 24 and 37,
    the distance builds, and ``cluster()`` under ``backend="auto"``."""
    ring = make_cluster_mesh("cpu")
    lw = {(n, m, v): _merges(distributed_lance_williams(D, m, ring, v))
          for n, D in lw_inputs().items() for m in REF_METHODS for v in VARIANTS}
    X, _ = api_input()
    res = cluster(X, "complete", device="cpu")
    return dict(p=ring.size, lw=lw, api=(res.backend, res.merges, res.labels(4)),
                **_pairwise_cases(ring))


def ranks_p3() -> dict:
    """p = 3: all 7 methods x 3 variants, the stops, the distance builds and
    the distributed batch on a ragged problem list."""
    ring = make_cluster_mesh("cpu")
    mats = lw_inputs()
    lw = {(n, m, v): _merges(distributed_lance_williams(D, m, ring, v))
          for n, D in mats.items() for m in METHODS for v in VARIANTS}
    stops = {(m, v, i): _merges(distributed_lance_williams(mats[37], m, ring, v, **knobs))
             for m in ("complete", "centroid") for v in VARIANTS
             for i, knobs in enumerate(STOP_KNOBS)}
    probs = batch_problems()
    batch = {}
    for i, (method, knobs) in enumerate(BATCH_KNOBS):
        res = cluster_batch(probs, method, backend="distributed", device="cpu", **knobs)
        batch[i] = ([r.merges for r in res], res.stats, [r.backend for r in res])
    auto = cluster_batch(probs, "complete", device="cpu")
    batch["auto"] = ([r.merges for r in auto], auto.stats, [r.backend for r in auto])
    return dict(p=ring.size, lw=lw, stops=stops, batch=batch, **_pairwise_cases(ring))


def ranks_compaction() -> dict:
    """p = 2 and 4 at n = 128: staged against unstaged, each rank's block at
    every stage, and threshold stops landing in each stage."""
    ring = make_cluster_mesh("cpu")
    D = compact_input()
    runs = {}
    for m in ("complete", "centroid"):
        for v in VARIANTS:
            staged = distributed_lance_williams(D, m, ring, v)
            flat = distributed_lance_williams(D, m, ring, v, compaction=False)
            runs[(m, v)] = (_merges(staged), _merges(flat), staged.blocks, flat.blocks,
                            staged.collectives, flat.collectives, staged.reshard_bytes)
    heights = lance_williams(D, "complete", device="cpu").merges[:, 2].numpy()
    stops = {(t, v): _merges(distributed_lance_williams(D, "complete", ring, v,
                                                   distance_threshold=float(heights[t])))
             for t in (40, 80, 110) for v in ("baseline", "lazy")}
    return dict(p=ring.size, runs=runs, stops=stops, heights=heights)


# ---------------------------------------------------------------------------
# the groups of ranks
# ---------------------------------------------------------------------------

RANK_MAIN = """
import pickle, sys
from datetime import timedelta
sys.path[:0] = [{src!r}, {tests!r}]
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, rank=rank, world_size={p},
                        timeout=timedelta(seconds={timeout}))
import {module} as cases
out = getattr(cases, {fn!r})()
with open({out!r}.format(rank), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def run_ranks(p: int, fn: str, tmp: Path, timeout: float = GROUP_TIMEOUT_S,
              module: str = "test_torch_distributed") -> list:
    """Run ``fn`` of the test module ``module`` (this one by default) on
    ``p`` gloo ranks, one process each, and return each rank's result.  A
    rank that fails, or a group that outlives ``timeout`` (every process is
    then killed), fails the caller with every rank's output, tracebacks
    included."""
    code = RANK_MAIN.format(src=str(SRC), tests=str(TESTS), init=f"file://{tmp / 'store'}",
                            p=p, timeout=timeout, fn=fn, out=str(tmp / "rank{}.pkl"),
                            module=module)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]))
    logs = [tmp / f"rank{r}.log" for r in range(p)]
    procs = []
    for r in range(p):
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=log,
                                          stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [r for r, proc in enumerate(procs) if proc.returncode != 0]
    if failed:
        out = "\n".join(f"--- rank {r} (exit code {procs[r].returncode}) ---\n"
                        + logs[r].read_text(errors="replace")[-4000:] for r in range(p))
        pytest.fail(f"{fn} on {p} gloo ranks failed on ranks {failed} (limit {timeout} s):\n"
                    f"{out}", pytrace=False)
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(p)]


def assert_same(a, b, where="") -> None:
    """Deep equality of two ranks' results (arrays bit for bit)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{k}]")
    else:
        assert a == b, where


def group(p: int, fn: str, tmp_path_factory) -> dict:
    """``fn`` on ``p`` ranks; every rank's result must be the same
    (the merge record is replicated)."""
    results = run_ranks(p, fn, tmp_path_factory.mktemp(f"{fn}_p{p}"))
    for r, res in enumerate(results[1:], 1):
        assert_same(res, results[0], f"rank {r} vs rank 0")
    assert results[0]["p"] == p
    return results[0]


@pytest.fixture(scope="module")
def p8(tmp_path_factory):
    return group(8, "ranks_p8", tmp_path_factory)


@pytest.fixture(scope="module")
def p3(tmp_path_factory):
    return group(3, "ranks_p3", tmp_path_factory)


@pytest.fixture(scope="module", params=(2, 4))
def staged(request, tmp_path_factory):
    return group(request.param, "ranks_compaction", tmp_path_factory)


# ---------------------------------------------------------------------------
# the references, in the test process
# ---------------------------------------------------------------------------


@functools.cache
def jax_serial(n: int, method: str) -> np.ndarray:
    from repro.core.lance_williams import lance_williams as jlance_williams

    return np.asarray(jlance_williams(lw_inputs()[n], method=method).merges)


def port_serial(D, method: str, variant: str = "baseline", **knobs) -> np.ndarray:
    res = lance_williams(D, method, variant=variant, device="cpu", **knobs)
    return _merges(res)


def assert_bit_equal(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bad = np.flatnonzero((got != want).any(axis=1))
    assert not bad.size, f"merges differ first at step {bad[:1]}: {got[bad[:1]]} vs {want[bad[:1]]}"


def assert_slots_close(got, want) -> None:
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# p = 8 and p = 3
# ---------------------------------------------------------------------------

P8_CASES = [(n, m, v) for n in LW_N for m in REF_METHODS for v in VARIANTS]


@pytest.mark.parametrize("n,method,variant", P8_CASES, ids=["-".join(map(str, c))
                                                             for c in P8_CASES])
def test_p8_against_references(p8, n, method, variant):
    """As tests/test_distributed_lw.py holds the JAX package's engine: slots
    equal to its serial ``lance_williams``, heights within rtol 1e-4 / atol
    1e-5; and the port's serial backend bit for bit."""
    got = p8["lw"][(n, method, variant)]
    assert_slots_close(got, jax_serial(n, method))
    assert_bit_equal(got, port_serial(lw_inputs()[n], method, variant))


P3_CASES = [(n, m, v) for n in LW_N for m in METHODS for v in VARIANTS]


@pytest.mark.parametrize("n,method,variant", P3_CASES, ids=["-".join(map(str, c))
                                                             for c in P3_CASES])
def test_p3_all_methods_bit_for_bit(p3, n, method, variant):
    """All 7 methods, centroid and median included, against the port's
    serial backend (the JAX recurrences fuse multiply-adds: ROADMAP.md §C)."""
    assert_bit_equal(p3["lw"][(n, method, variant)], port_serial(lw_inputs()[n], method, variant))


STOP_CASES = [(m, v, i) for m in ("complete", "centroid") for v in VARIANTS
              for i in range(len(STOP_KNOBS))]


@pytest.mark.parametrize("method,variant,case", STOP_CASES,
                         ids=[f"{m}-{v}-{STOP_KNOBS[i]}" for m, v, i in STOP_CASES])
def test_p3_stops_equal_serial(p3, method, variant, case):
    """``stop_at_k`` and ``distance_threshold`` stop every rank at the serial
    backend's merge, with the same record."""
    got = p3["stops"][(method, variant, case)]
    assert_bit_equal(got, port_serial(lw_inputs()[37], method, variant, **STOP_KNOBS[case]))


@pytest.mark.parametrize("method", ("complete", "centroid"))
def test_p3_stops_against_naive(p3, method):
    """The baseline stops against the reference's float64 oracle: the
    oracle's prefix up to ``n - k`` merges, or up to its first height above
    the threshold."""
    from repro.core.naive import naive_lw

    want = naive_lw(lw_inputs()[37], method).astype(np.float32)
    for case, knobs in enumerate(STOP_KNOBS):
        got = p3["stops"][(method, "baseline", case)]
        if "stop_at_k" in knobs:
            upto = max(37 - knobs["stop_at_k"], 0)
        else:
            over = np.flatnonzero(~(want[:, 2] <= np.float32(knobs["distance_threshold"])))
            upto = int(over[0]) if over.size else len(want)
        assert got.shape == (upto, 4), knobs
        assert_slots_close(got, want[:upto])


def _builders():
    from repro.core import distance as jdistance

    X, C = pairwise_inputs()
    Xt, Ct = torch.as_tensor(X), torch.as_tensor(C)
    return {
        "sqeuclidean": (np.asarray(jdistance.pairwise_sq_euclidean(X)), pairwise_sq_euclidean(Xt)),
        "euclidean": (np.asarray(jdistance.pairwise_euclidean(X)), pairwise_euclidean(Xt)),
        "cosine": (np.asarray(jdistance.pairwise_cosine(X)), pairwise_cosine(Xt)),
        "rmsd": (np.asarray(jdistance.pairwise_rmsd(C)), pairwise_rmsd(Ct)),
    }


@pytest.mark.parametrize("p", (3, 8))
@pytest.mark.parametrize("kind", ("sqeuclidean", "euclidean", "cosine", "rmsd"))
def test_distributed_pairwise(p, kind, p3, p8):
    """The born-sharded build, gathered, against the JAX package's builders
    and the port's single-device ones, at the reference test's tolerances
    (rtol 1e-3 / atol 2e-3 for rmsd, 1e-4 otherwise); distributed LW on the
    born-sharded block equals the same call on the gathered matrix."""
    res = {3: p3, 8: p8}[p]
    got = res["pairwise"][kind]
    tol = dict(rtol=1e-3, atol=2e-3) if kind == "rmsd" else dict(rtol=1e-4, atol=1e-4)
    for want in _builders()[kind]:
        np.testing.assert_allclose(got, np.asarray(want), **tol)
    born, gathered, block = res["born"][kind]
    n = got.shape[0]
    assert block == (pad_to_mesh(n, p) // p, pad_to_mesh(n, p))
    assert_bit_equal(born, gathered)
    assert born.shape == (n - 1, 4)


def test_p8_cluster_api(p8):
    """The analogue of the reference's test_end_to_end_cluster_api_multidevice:
    ``backend="auto"`` under a group of 8 runs the distributed loop, its
    purity is above 0.9, and its merges are the serial backend's."""
    backend, merges, labels = p8["api"]
    X, truth = api_input()
    assert backend == "distributed"
    purity = sum(np.bincount(truth[labels == c]).max()
                 for c in range(4) if (labels == c).any()) / len(truth)
    assert purity > 0.9, purity
    assert_bit_equal(merges, cluster(X, "complete", backend="serial", device="cpu").merges)


@pytest.mark.parametrize("case", [*range(len(BATCH_KNOBS)), "auto"], ids=str)
def test_p3_batch_equals_serial_loop(p3, case):
    """Whole problems dealt to 3 ranks (7 problems: each bucket's count
    padded to a multiple of 3): every problem's merges equal
    ``cluster(problem, method, backend="serial")`` bit for bit."""
    merges, stats, backends = p3["batch"][case]
    method, knobs = ("complete", {}) if case == "auto" else BATCH_KNOBS[case]
    assert stats.engine == "distributed" and set(backends) == {"distributed"}
    assert stats.buckets == ((8, 2), (16, 2), (32, 1), (64, 2))
    assert stats.padded_problems == 1 + 1 + 2 + 1
    for prob, got in zip(batch_problems(), merges):
        assert_bit_equal(got, cluster(prob, method, backend="serial", device="cpu",
                                      **knobs).merges)


# ---------------------------------------------------------------------------
# p = 2 and p = 4: compaction and the rank's storage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ("complete", "centroid"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_staged_equals_unstaged_and_shrinks_the_block(staged, method, variant):
    """Staged runs equal ``compaction=False`` bit for bit, and each rank
    holds ``n_pad/p × n_pad`` cells, then ``size/p × size`` after each
    boundary: the paper's n²/p, shrinking with the run (the analogue of the
    reference's test_storage_is_sharded)."""
    p, D = staged["p"], compact_input()
    got, flat, blocks, flat_blocks, collectives, flat_collectives, reshard = \
        staged["runs"][(method, variant)]
    plan = plan_stages(pad_to_mesh(COMPACT_N, p), COMPACT_N - 1, align=p)
    assert len(plan) >= 2
    assert_bit_equal(got, flat)
    assert_bit_equal(got, port_serial(D, method, variant))
    assert blocks == tuple((size // p, size) for size, _ in plan)
    assert flat_blocks == ((COMPACT_N // p, COMPACT_N),)
    # two collectives a merge, a seed a stage, a reduce-scatter a boundary
    assert collectives == 2 * (COMPACT_N - 1) + 2 * len(plan) - 1
    assert flat_collectives == 2 * (COMPACT_N - 1) + 1
    assert reshard == plan[1][0] * COMPACT_N * 4      # (half, size) float32 contributions


@pytest.mark.parametrize("merge", (40, 80, 110))
def test_staged_threshold_stops_in_each_stage(staged, merge):
    """A threshold at the height of merge 40, 80 or 110 (in stages 1, 2 and
    3: 64, 32 and 31 merges) stops every rank where the serial backend
    stops."""
    D, heights = compact_input(), staged["heights"]
    for variant in ("baseline", "lazy"):
        got = staged["stops"][(merge, variant)]
        want = port_serial(D, "complete", variant, distance_threshold=float(heights[merge]))
        assert_bit_equal(got, want)
        assert len(got) > merge


# ---------------------------------------------------------------------------
# p = 1 in the test process
# ---------------------------------------------------------------------------


@pytest.fixture
def no_group():
    """A test that brings up a process group tears it down, so that no
    later test finds one."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_pad_to_mesh_matches_reference():
    from repro.core.distributed import pad_to_mesh as jpad_to_mesh

    for n in (0, 1, 7, 8, 37, 100):
        for p in (1, 3, 8):
            for block in (1, 4):
                assert pad_to_mesh(n, p, block=block) == jpad_to_mesh(n, p, block=block)
    for bad in (dict(n=4, p=0), dict(n=4, p=2, block=0)):
        with pytest.raises(ValueError):
            pad_to_mesh(**bad)


def test_one_rank_on_the_cpu(no_group):
    """Without a group, ``device="cpu"`` brings up a world-size-1 gloo group;
    a second call reuses it; the loop equals the serial backend."""
    ring = make_cluster_mesh("cpu")
    assert (ring.rank, ring.size, ring.device.type) == (0, 1, "cpu")
    assert dist.get_backend() == "gloo"
    assert make_cluster_mesh("cpu").group is ring.group
    D = lw_inputs()[37]
    for variant in VARIANTS:
        res = distributed_lance_williams(D, "centroid", ring, variant)
        assert res.blocks == ((37, 37),)
        assert_bit_equal(_merges(res), port_serial(D, "centroid", variant))


def test_no_gpu_raises_unless_cpu_is_named(no_group):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cluster_mesh()
    assert not dist.is_initialized()


def test_gloo_group_refuses_a_cuda_device(no_group):
    make_cluster_mesh("cpu")
    with pytest.raises(ValueError, match="gloo"):
        make_cluster_mesh("cuda")


def test_ring_mesh_rules(no_group):
    """A multi-dimensional mesh is rejected as the JAX package rejects a
    multi-axis one; flatten_mesh and a 1-D mesh give the ring."""
    from torch.distributed.device_mesh import DeviceMesh

    ring = make_cluster_mesh("cpu")
    grid = DeviceMesh("cpu", [[0]], mesh_dim_names=("dp", "tp"))
    with pytest.raises(ValueError, match="1-D mesh.*flatten_mesh"):
        require_ring_mesh(grid)
    with pytest.raises(ValueError, match="1-D mesh"):
        distributed_lance_williams(lw_inputs()[24], "complete", grid)
    for mesh in (flatten_mesh(grid), require_ring_mesh(DeviceMesh("cpu", [0],
                                                                  mesh_dim_names=("p",)))):
        assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    assert require_ring_mesh(ring) is ring
    with pytest.raises(ValueError, match="contradicts"):
        require_ring_mesh(ring, "cuda")


def test_shard_rows_and_replicate():
    ring = SimpleNamespace(rank=1, size=3, device=torch.device("cpu"))
    arr = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_rows(arr, ring).numpy(), arr[2:4])
    np.testing.assert_array_equal(replicate(arr, ring).numpy(), arr)
    with pytest.raises(ValueError, match="pad_to_mesh"):
        shard_rows(np.zeros((7, 2)), ring)


def test_cluster_distributed_on_one_rank(no_group):
    """``backend="distributed"`` on one rank: the serial backend's merges,
    reported as distributed; ``"auto"`` stays serial on a group of one."""
    X, _ = api_input()
    got = cluster(X, "average", backend="distributed", variant="lazy", device="cpu")
    want = cluster(X, "average", backend="serial", variant="lazy", device="cpu")
    assert (got.backend, got.algorithm) == ("distributed", "lw")
    assert_bit_equal(got.merges, want.merges)
    assert cluster(X, "average", device="cpu").backend == "serial"
    batch = cluster_batch(batch_problems(), "complete", backend="distributed", device="cpu")
    assert batch.stats.engine == "distributed"
    for prob, r in zip(batch_problems(), batch):
        assert_bit_equal(r.merges, cluster(prob, "complete", backend="serial",
                                           device="cpu").merges)


def test_distributed_chain_raises_as_reference(no_group):
    """``algorithm="nnchain"`` on the distributed backend is the sharded
    matrix-free chain: a matrix, a method that is not a points method, and
    ``matrix_free=False`` raise the reference's ValueError in both packages
    (the chain itself is held in test_torch_distributed_chain.py)."""
    from repro.core import cluster as jcluster

    D = lw_inputs()[24]
    X, _ = api_input()
    for data, method, knobs in ((D, "complete", {}), (X, "single", {}),
                                (X, "ward", dict(matrix_free=False))):
        with pytest.raises(ValueError, match="sharded"):
            jcluster(data, method, algorithm="nnchain", backend="distributed", **knobs)
        with pytest.raises(ValueError, match="sharded"):
            cluster(data, method, algorithm="nnchain", backend="distributed", device="cpu",
                    **knobs)


def test_distributed_knobs_validate(no_group):
    D = lw_inputs()[24]
    for knobs in (dict(method="nope"), dict(variant="nope")):
        with pytest.raises(ValueError):
            distributed_lance_williams(D, **{"method": "complete", **knobs}, mesh=None)
    ring = make_cluster_mesh("cpu")
    with pytest.raises(ValueError, match="distance kind"):
        distributed_pairwise(np.zeros((4, 3)), "manhattan", ring)
    with pytest.raises(ValueError, match="conformations"):
        distributed_pairwise(np.zeros((4, 3)), "rmsd", ring)
