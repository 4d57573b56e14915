"""The sharded matrix-free NN chain in the port
(:func:`repro_torch.core.distributed.distributed_nn_chain_from_points`),
its segmented fault-tolerant driver and elastic shrink, on p gloo ranks on
the CPU; with them :mod:`repro_torch.checkpoint.elastic` and
:func:`repro_torch.distributed.fault.run_resilient_loop`.

Groups of 2, 3, 4 and 8 ranks run in processes of their own
(``test_torch_distributed.run_ranks``), one group a p, started when a test
first needs it; every rank computes its cases in one go and pickles them.
The tests hold every rank's merges bit for bit against the port's serial
points chain, and the p = 1 runs (in the test process) against the JAX
package's sharded and serial chains, as ``test_torch_nnchain.py`` holds the
serial chain: slots and sizes equal, heights within rtol 1e-5 / atol 1e-6.
The fault and shrink cases are the reference's own
(``tests/test_distributed_nnchain.py``, ``tests/test_elastic.py``,
``tests/test_obs.py``): the same messages and counters.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from test_torch_distributed import assert_bit_equal, run_ranks  # noqa: E402

from repro_torch.checkpoint.elastic import (  # noqa: E402
    ParamSpec,
    reshard_rows,
    validate_mesh_for_tree,
)
from repro_torch.core import cluster  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedChainResult,
    distributed_nn_chain_from_points,
    make_cluster_mesh,
    pad_to_mesh,
    sub_ring,
)
from repro_torch.core.nnchain import nn_chain_from_points  # noqa: E402
from repro_torch.distributed.fault import (  # noqa: E402
    FailurePlan,
    SimulatedFailure,
    StepDeadline,
    run_resilient_loop,
)
from repro_torch.obs import Tracer, get_registry, reset_registry, spans_by_name  # noqa: E402

#: (n, method) of the reference's multi-device test (n = 41 and 37 pad at
#: every p here but 1; 64 pads at p = 3).
MULTI_CASES = ((41, "ward"), (64, "average"), (37, "weighted"))
#: (n, method) of the reference's p = 1 test.
P1_CASES = ((41, "ward"), (30, "average"), (23, "weighted"))
FAULT_N = 40


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the chain runs many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the inputs, made from seeds with numpy on every rank and in the test process
# ---------------------------------------------------------------------------


def multi_inputs() -> dict:
    rng = np.random.default_rng(7)
    return {case: rng.normal(size=(case[0], 6)).astype(np.float32) for case in MULTI_CASES}


def p1_inputs() -> dict:
    rng = np.random.default_rng(3)
    return {case: rng.normal(size=(case[0], 6)).astype(np.float32) for case in P1_CASES}


def fault_input() -> np.ndarray:
    return np.random.default_rng(5).normal(size=(FAULT_N, 5)).astype(np.float32)


def port_serial(X, method: str) -> np.ndarray:
    return nn_chain_from_points(X, method, device="cpu").merges.numpy()


# ---------------------------------------------------------------------------
# what each rank runs (module-level: the ranks import this module)
# ---------------------------------------------------------------------------


class AlwaysFail:
    """A shard that never comes back."""

    def check(self, step):
        raise SimulatedFailure(f"injected at step {step}")


class FailKTimes:
    """``k`` failures at segment ``at``, then none: exhausts the restart
    budget on the first ring, then lets the resharded run go on."""

    def __init__(self, k: int, at: int = 0):
        self.k, self.at = k, at

    def check(self, step):
        if step == self.at and self.k > 0:
            self.k -= 1
            raise SimulatedFailure(f"injected ({self.k} left)")


def _summary(res: DistributedChainResult) -> dict:
    return dict(merges=res.merges.numpy(), n_merges=res.n_merges, iters=res.iters,
                restarts=res.restarts, stragglers=res.stragglers, segments=res.segments,
                dropped=res.dropped)


def _error(run) -> str:
    try:
        run()
    except RuntimeError as e:
        return str(e)
    return "no error"


def _fault_cases(ring) -> dict:
    """The reference's fault cases at n = 40: a lost shard recovered, one
    that never comes back, and a straggling segment."""
    X = fault_input()
    out = {}
    events = []
    res = distributed_nn_chain_from_points(X, "ward", ring, segment_steps=10,
                                           failure_plan=FailurePlan(fail_at=(1,)),
                                           log=events.append)
    out["recover"] = dict(_summary(res), events=events)
    events = []
    out["exhaust"] = _error(lambda: distributed_nn_chain_from_points(
        X, "ward", ring, segment_steps=10, failure_plan=AlwaysFail(), max_restarts=2,
        log=events.append))
    events = []
    res = distributed_nn_chain_from_points(X, "ward", ring, segment_steps=10,
                                           deadline=StepDeadline(factor=0.0, warmup=1),
                                           log=events.append)
    out["straggle"] = dict(_summary(res), events=events)
    return out


def _elastic_cases(ring) -> dict:
    """The reference's shrink cases at n = 40 on 4 ranks: onto a fallback of
    2 (at segment 0, as the reference fails, and at segment 1, so that the
    dropped ranks hold a committed prefix), a bad fallback of 3 (40 % 3),
    and no fallback; and ``reshard_rows`` from 4 ranks to 2."""
    X = fault_input()
    fallback, bad = sub_ring([0, 1], "cpu"), sub_ring([0, 1, 2], "cpu")
    shrinks = get_registry().counter("distributed_chain_shrinks_total", "")
    out = dict(fallback_ring=(fallback.rank, fallback.size), bad_ring=(bad.rank, bad.size))
    block = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)[ring.rank * 2:][:2]
    moved = reshard_rows(block, ring, fallback)
    out["reshard"] = None if moved is None else moved.numpy()
    for at in (0, 1):
        events, before = [], shrinks.total()
        res = distributed_nn_chain_from_points(X, "ward", ring, segment_steps=10,
                                               max_restarts=1,
                                               failure_plan=FailKTimes(2, at),
                                               fallback_mesh=fallback, log=events.append)
        out[f"shrink_at_{at}"] = dict(_summary(res), events=events,
                                      shrinks=shrinks.total() - before)
    before = ring.collectives
    out["bad"] = _error(lambda: distributed_nn_chain_from_points(
        X, "ward", ring, segment_steps=10, max_restarts=1, failure_plan=FailKTimes(2),
        fallback_mesh=bad))
    out["bad_collectives"] = ring.collectives - before
    out["no_fallback"] = _error(lambda: distributed_nn_chain_from_points(
        X, "ward", ring, segment_steps=10, max_restarts=1, failure_plan=FailKTimes(2)))
    return out


def ranks_chain() -> dict:
    """The reference's three cases on this group; the fault cases on 2
    ranks and the elastic shrink on 4."""
    ring = make_cluster_mesh("cpu")
    out = dict(p=ring.size, rank=ring.rank, chains={})
    for case, X in multi_inputs().items():
        before = ring.collectives
        res = distributed_nn_chain_from_points(X, case[1], ring)
        out["chains"][case] = dict(_summary(res), collectives=ring.collectives - before)
    if ring.size == 2:
        out["faults"] = _fault_cases(ring)
    if ring.size == 4:
        out["elastic"] = _elastic_cases(ring)
    return out


# ---------------------------------------------------------------------------
# the groups of ranks: one a p, started when first needed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(p)``: every rank's result of :func:`ranks_chain` on p gloo
    ranks, in rank order."""
    groups = {}

    def get(p: int) -> list:
        if p not in groups:
            groups[p] = run_ranks(p, "ranks_chain", tmp_path_factory.mktemp(f"chain_p{p}"),
                                  module="test_torch_distributed_chain")
        return groups[p]

    return get


@pytest.mark.parametrize("case", MULTI_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("p", (2, 3, 4, 8))
def test_every_rank_equals_serial_chain(ranks, p, case):
    """Every rank holds the same merges, bit for bit the port's serial
    points chain (padding included: n_pad = 42, 40, 44, 48 for n = 41),
    after exactly three collectives a trip."""
    results = ranks(p)
    want = port_serial(multi_inputs()[case], case[1])
    for r, res in enumerate(results):
        assert (res["p"], res["rank"]) == (p, r)
        got = res["chains"][case]
        assert_bit_equal(got["merges"], want)
        assert got["n_merges"] == case[0] - 1 and not got["dropped"]
        assert got["collectives"] == 3 * got["iters"]
        assert got["iters"] == results[0]["chains"][case]["iters"]
        assert (got["restarts"], got["stragglers"], got["segments"]) == (0, 0, 1)


def test_fault_injection_recovers_and_exhausts(ranks):
    """The reference's fault cases on 2 ranks: a lost shard is retried from
    the committed state (exact merges, one restart, 4 segments); a shard
    that never comes back raises with "max_restarts" and "committed"; a
    straggling segment is flagged and the run is exact."""
    want = port_serial(fault_input(), "ward")
    for res in ranks(2):
        f = res["faults"]
        rec = f["recover"]
        assert_bit_equal(rec["merges"], want)
        assert any("retrying segment" in e for e in rec["events"]), rec["events"]
        assert (rec["restarts"], rec["stragglers"], rec["segments"]) == (1, 0, 4)
        assert "max_restarts" in f["exhaust"] and "committed" in f["exhaust"], f["exhaust"]
        strag = f["straggle"]
        assert_bit_equal(strag["merges"], want)
        assert any("straggled" in e for e in strag["events"]), strag["events"]
        assert strag["stragglers"] >= 1 and strag["restarts"] == 0


@pytest.mark.parametrize("at", (0, 1))
def test_fallback_shrink_continues_exactly(ranks, at):
    """The reference's shrink on 4 ranks onto a fallback of 2: ranks 0 and 1
    finish with the serial chain's merges after "resharding ... p=2", the
    shrink counter up by one; ranks 2 and 3 make no further collective and
    return the merges committed before the shrink (none when the budget
    runs out at segment 0; segment 0's 10 at segment 1), marked dropped."""
    want = port_serial(fault_input(), "ward")
    for r, res in enumerate(ranks(4)):
        e = res["elastic"]
        got = e[f"shrink_at_{at}"]
        assert got["shrinks"] == 1
        assert any("resharding" in ev and "p=2" in ev for ev in got["events"]), got["events"]
        if r < 2:
            assert e["fallback_ring"] == (r, 2)
            assert_bit_equal(got["merges"], want)
            assert (got["n_merges"], got["dropped"]) == (FAULT_N - 1, False)
        else:
            assert e["fallback_ring"] == (-1, 2)
            committed = 10 * at
            assert (got["n_merges"], got["dropped"]) == (committed, True)
            assert_bit_equal(got["merges"][:committed], want[:committed])
            assert any("outside" in ev for ev in got["events"]), got["events"]


def test_bad_fallback_fails_before_any_state_moves(ranks):
    """A fallback of 3 ranks cannot hold 40 rows: every rank raises naming
    the rows axis, p=3 and the padded size, before any collective; without
    a fallback the exhaustion message names ``fallback_mesh``."""
    for r, res in enumerate(ranks(4)):
        e = res["elastic"]
        assert e["bad_ring"] == (r if r < 3 else -1, 3)
        msg = e["bad"]
        assert "rows" in msg and "p=3" in msg and "40" in msg, msg
        assert e["bad_collectives"] == 0
        assert "max_restarts" in e["no_fallback"] and "fallback_mesh" in e["no_fallback"]


def test_reshard_rows_moves_the_rows(ranks):
    """``reshard_rows`` from 4 ranks to the first 2: each keeps 4 of the 8
    rows in order, and the ranks outside get ``None``."""
    whole = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, res in enumerate(ranks(4)):
        got = res["elastic"]["reshard"]
        if r < 2:
            np.testing.assert_array_equal(got, whole[r * 4:(r + 1) * 4])
        else:
            assert got is None


# ---------------------------------------------------------------------------
# p = 1 in the test process
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank():
    """A world-size-1 gloo group, torn down after the test."""
    ring = make_cluster_mesh("cpu")
    yield ring
    dist.destroy_process_group()


def assert_chain_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", P1_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_one_rank_matches_both_reference_chains(one_rank, case):
    """p = 1: the JAX package's sharded chain and its serial points chain
    (slots and sizes equal, heights close, the serial chain's trip count);
    the port's serial chain bit for bit, trips included."""
    from repro.core.distributed import distributed_nn_chain_from_points as jdistributed
    from repro.core.nnchain import nn_chain_from_points as jnn_chain

    n, method = case
    X = p1_inputs()[case]
    got = distributed_nn_chain_from_points(X, method, one_rank)
    assert isinstance(got, DistributedChainResult) and got.n_merges == n - 1
    jd, js = jdistributed(X, method), jnn_chain(X, method, use_pallas=False)
    assert int(jd.n_merges) == int(js.n_merges) == n - 1
    assert_chain_close(got.merges.numpy(), np.asarray(jd.merges))
    assert_chain_close(got.merges.numpy(), np.asarray(js.merges))
    assert got.iters == int(js.iters)
    serial = nn_chain_from_points(X, method, device="cpu")
    assert_bit_equal(got.merges.numpy(), serial.merges.numpy())
    assert got.iters == serial.iters


def test_one_rank_telemetry(one_rank):
    """The reference's p = 1 telemetry case (tests/test_obs.py): a restart at
    segment 1 of 3, four ``chain_segment`` spans (one failed), and the
    registry's counts."""
    reset_registry()
    X = np.random.default_rng(2).normal(size=(25, 4)).astype(np.float32)
    tracer = Tracer()
    res = distributed_nn_chain_from_points(X, "ward", one_rank, segment_steps=10,
                                           failure_plan=FailurePlan(fail_at=(1,)),
                                           log=lambda m: None, tracer=tracer)
    assert_bit_equal(res.merges.numpy(), port_serial(X, "ward"))
    assert (res.restarts, res.stragglers, res.segments) == (1, 0, 3)
    reg = get_registry()
    assert reg.get("distributed_chain_segments_total").total() == 3
    assert reg.get("distributed_chain_restarts_total").total() == 1
    assert reg.get("fault_injected_failures_total").total() == 1
    segs = spans_by_name(tracer.events(), "chain_segment")
    assert len(segs) == 4
    assert sum(1 for s in segs if s.args.get("error")) == 1
    assert [s.args.get("error") for s in segs] == [None, "shard-lost", None, None]


def test_one_rank_straggler_telemetry(one_rank):
    reset_registry()
    X = np.random.default_rng(3).normal(size=(17, 4)).astype(np.float32)
    res = distributed_nn_chain_from_points(X, "average", one_rank, segment_steps=4,
                                           deadline=StepDeadline(factor=0.0, warmup=1),
                                           log=lambda m: None)
    assert res.stragglers >= 1 and res.restarts == 0
    assert get_registry().get("fault_deadline_exceeded_total").total() == res.stragglers
    assert res.segments == 4


def test_one_rank_warns_without_log(one_rank):
    """Fault events go to a ``RuntimeWarning`` when no ``log`` is given."""
    X = fault_input()
    with pytest.warns(RuntimeWarning, match="retrying segment"):
        res = distributed_nn_chain_from_points(X, "ward", one_rank, segment_steps=10,
                                               failure_plan=FailurePlan(fail_at=(2,)))
    assert_bit_equal(res.merges.numpy(), port_serial(X, "ward"))


def test_nan_input_raises_like_reference(one_rank):
    """A NaN stops the chain: both packages raise a RuntimeError naming
    the iteration cap, NaNs and the merges committed."""
    from repro.core.distributed import distributed_nn_chain_from_points as jdistributed

    X = np.random.default_rng(1).normal(size=(30, 4)).astype(np.float32)
    X[5, 0] = np.nan
    for run in (lambda: jdistributed(X, "ward"),
                lambda: distributed_nn_chain_from_points(X, "ward", one_rank)):
        with pytest.raises(RuntimeError, match="iteration cap.*NaNs.*committed"):
            run()


def test_small_and_invalid_inputs(one_rank):
    res = distributed_nn_chain_from_points(np.zeros((1, 3)), "ward", one_rank)
    assert (tuple(res.merges.shape), res.n_merges) == ((0, 4), 0)
    res = distributed_nn_chain_from_points(np.array([[0.0], [2.0]]), "ward", one_rank)
    np.testing.assert_array_equal(res.merges.numpy(), [[0, 1, 4, 2]])
    with pytest.raises(ValueError, match="sharded matrix-free chain supports"):
        distributed_nn_chain_from_points(np.zeros((4, 2)), "complete", one_rank)
    with pytest.raises(ValueError, match="expected"):
        distributed_nn_chain_from_points(np.zeros(4), "ward", one_rank)
    assert pad_to_mesh(41, 8) == 48


def test_cluster_route_on_one_rank(one_rank):
    """``cluster(..., algorithm="nnchain", backend="distributed")`` on the
    default ring: the serial matrix-free chain's merges, reported as the
    JAX package reports it, no matrix kept."""
    from repro.core import cluster as jcluster

    X = p1_inputs()[(41, "ward")]
    for method in ("ward", "average", "weighted"):
        metric = None if method == "ward" else "sqeuclidean"
        got = cluster(X, method, metric=metric, algorithm="nnchain", backend="distributed",
                      device="cpu")
        want = cluster(X, method, metric=metric, algorithm="nnchain", matrix_free=True,
                       device="cpu")
        assert (got.backend, got.algorithm, got.distances) == ("distributed", "nnchain", None)
        np.testing.assert_array_equal(got.merges, want.merges)
    ref = jcluster(X, "ward", algorithm="nnchain", backend="distributed")
    assert (got.backend, got.algorithm) == (ref.backend, ref.algorithm)


# ---------------------------------------------------------------------------
# validate_mesh_for_tree and run_resilient_loop against the JAX package
# ---------------------------------------------------------------------------


def _spec_cases():
    """Trees of the JAX package's ``ParamSpec`` or the port's: the
    reference test's tree, and a named tuple and a list with rows and
    another axis."""
    from collections import namedtuple

    Pair = namedtuple("Pair", "left right")

    def reference(spec):
        return {"ok": spec((12, 4), ("rows", None)), "bad": spec((10, 4), ("rows", None)),
                "rep": spec((10,), (None,))}

    def nested(spec):
        return [Pair(spec((12, 6), ("rows", "cols")), spec((9, 8), ("cols", "rows"))),
                None, spec((30,), ("rows",))]

    return reference, nested


@pytest.mark.parametrize("p", (1, 2, 3, 4))
def test_validate_mesh_for_tree_matches_reference(p):
    """The problem lists of the JAX package's ``validate_mesh_for_tree`` on
    the same trees and a mesh of one axis "p" of p devices (a duck: its
    axis names and shape), string for string, against the port's on a ring
    of p; the chain state's specs at n = 40 and 41 too."""
    from repro.checkpoint.elastic import validate_mesh_for_tree as jvalidate
    from repro.core.distributed import _chain_state_specs as jchain_specs
    from repro.models.common import ParamSpec as JParamSpec

    mesh = SimpleNamespace(axis_names=("p",), devices=np.empty((p,)))
    ring = SimpleNamespace(size=p)
    rules = {"rows": ("p",)}
    for build in _spec_cases():
        want = jvalidate(build(JParamSpec), rules, mesh)
        assert validate_mesh_for_tree(build(ParamSpec), rules, ring) == want
    for n in (40, 41):
        n_pad = pad_to_mesh(n, 4)
        want = jvalidate(jchain_specs(n_pad, 5, n), rules, mesh)
        assert validate_mesh_for_tree(tdist._chain_state_specs(n_pad, 5, n),
                                      tdist._CHAIN_ROW_RULES, ring) == want
    with pytest.raises(ValueError):
        ParamSpec((2, 3), ("rows",))


def _loop(run, plan, total=23, save_every=5, max_restarts=3):
    """``run_resilient_loop`` with a fake step, save and restore: what it
    returns (or raises), the steps run, the saves and the log."""
    saves, steps, logs = [], [], []

    def restore():
        return saves[-1] if saves else 0

    try:
        final = run(start_step=0, total_steps=total,
                    step_fn=lambda s: steps.append(s) or {"loss": s * 0.5},
                    save_fn=saves.append, restore_fn=restore, save_every=save_every,
                    max_restarts=max_restarts, failure_plan=plan, log=logs.append)
    except RuntimeError as e:
        final = f"RuntimeError: {e}"
    return final, steps, saves, logs


@pytest.mark.parametrize("fail_at,max_restarts", [((), 3), ((7,), 3), ((3, 12, 19), 3),
                                                  ((3, 12, 19), 2), ((0, 22), 1)])
def test_run_resilient_loop_matches_reference(fail_at, max_restarts):
    from repro.distributed.fault import FailurePlan as JFailurePlan
    from repro.distributed.fault import run_resilient_loop as jrun

    got = _loop(run_resilient_loop, FailurePlan(fail_at=fail_at), max_restarts=max_restarts)
    want = _loop(jrun, JFailurePlan(fail_at=fail_at), max_restarts=max_restarts)
    assert got == want
