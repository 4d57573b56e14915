"""The port's analytic roofline (``repro_torch.roofline``) and what reads
it: the terms and the dominant one on H100 constants, the reference's
ring model of wire bytes, each kernel entry's count at PERF.md §6's
shapes (the bounds ``chip_smoke.py`` printed before the counts moved into
the package, on an NVIDIA H100 80GB HBM3 at 700.00 W, with the L2 rate it
measured there), a ``Ring``'s wire bytes on a 2-rank gloo group, and the
service's cost profiles against counts worked out by hand.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import run_ranks  # noqa: E402

from repro.roofline.hlo_cost import _wire_bytes as ref_wire_bytes  # noqa: E402
from repro_torch.core.batched import BucketProgram, bucket_signature  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    KERNEL_MIN_STAGE,
    MIN_STAGE_N,
    plan_stages,
    stage_plan,
)
from repro_torch.roofline import Cost, Roofline, analyze, collective_bytes, cost, hw  # noqa: E402
from repro_torch.service.cache import CompileCache, CostProfile, profile_program  # noqa: E402

L2_RATE = 8579940524467.857      # the L2 read rate chip_smoke measured with those bounds
MERGE_REPS = 20                  # merges of a timed batch: the merge entry's L' is averaged


def test_roofline_terms_and_dominant():
    r = Roofline(flops_per_device=67e12, bytes_per_device=3.35e12,
                 coll_bytes_per_device=900e9, chips=4)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 2.0) < 1e-9
    assert r.dominant == "collective" and r.bound_s == r.collective_s
    d = r.to_dict()
    assert d["dominant"] == "collective"
    assert set(d) == {"flops_per_device", "bytes_per_device", "coll_bytes_per_device", "chips",
                      "compute_s", "memory_s", "collective_s", "dominant", "coll_breakdown",
                      "raw_cost_analysis"}
    # a kernel's roofline: its operations on the tensor cores, its bytes from L2
    k = Roofline(989.4e12, 3.35e12, 0.0, 1, peak_flops=hw.PEAK_FLOPS_BF16, byte_rate=2 * hw.HBM_BW)
    assert abs(k.compute_s - 1.0) < 1e-9 and abs(k.memory_s - 0.5) < 1e-9
    assert k.dominant == "compute"


def test_analyze_builds_the_roofline_of_a_cost():
    c = Cost(flops=2.0, bytes=3.0, coll_bytes=5.0) + 2 * Cost(flops=1.0, bytes=1.0)
    assert c == Cost(4.0, 5.0, 5.0) and c * 0.5 == Cost(2.0, 2.5, 2.5)
    r = analyze(c, chips=2, byte_rate=1.0, coll_breakdown={"all-gather": 5.0})
    assert (r.flops_per_device, r.bytes_per_device, r.coll_bytes_per_device) == (4.0, 5.0, 5.0)
    assert r.chips == 2 and r.memory_s == 5.0 and r.compute_s == 4.0 / hw.PEAK_FLOPS_F32
    assert r.collective_s == 5.0 / hw.NVLINK_BW and r.coll_breakdown == {"all-gather": 5.0}
    assert r.raw_cost_analysis == {}


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_wire_byte_ring_model(op, g):
    assert cost.wire_bytes(op, 1000, g) == ref_wire_bytes(op, 1000, g)
    if g == 4:
        assert cost.wire_bytes(op, 1000, g) == {"all-gather": 750, "all-reduce": 1500,
                                                 "reduce-scatter": 3000, "all-to-all": 750,
                                                 "collective-permute": 1000}[op]


def test_hw_has_no_tpu_number():
    assert (hw.HBM_BW, hw.PEAK_FLOPS_F32, hw.HBM_BYTES) == (3.35e12, 67e12, 80 * 10**9)
    assert (hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_BF16, hw.NVLINK_BW) == (494.7e12, 989.4e12, 450e9)
    for dtype in (torch.float64, torch.float32, torch.bfloat16, torch.int64, torch.bool):
        assert hw.DTYPE_BYTES[str(dtype).removeprefix("torch.")] == dtype.itemsize


def _bounds(work: Cost, in_l2: bool) -> tuple:
    return (analyze(work, byte_rate=L2_RATE if in_l2 else hw.HBM_BW).bound_s * 1e3,
            analyze(work).bound_s * 1e3)


# (entry, its count, in L2, the bound_ms and hbm_bound_ms chip_smoke printed)
PHASE_2_ROWS = [
    ("masked_argmin n=1968", cost.masked_argmin(1968, 1168), True,
     0.0006362370443516063, 0.001629515223880597),
    ("masked_argmin/seed n=1968", cost.masked_argmin(1968, 1968), True,
     0.0018058488815644756, 0.004625097313432835),
    ("masked_argmin n=16384", cost.masked_argmin(16384, 9748), False,
     0.11346579462686568, 0.11346579462686568),
    ("masked_argmin/seed n=16384", cost.masked_argmin(16384, 16384), False,
     0.3205248417910448, 0.3205248417910448),
    ("lw_step n=1968", cost.lw_step(1968, 1191), True,
     0.0006663109124937171, 0.0017065397014925374),
    ("lw_merge n=1968", cost.lw_step(1968, 1191 - (MERGE_REPS - 1) / 2), True,
     0.0006557944060281206, 0.0016796050746268657),
    ("lw_step n=16384", cost.lw_step(16384, 9813), False,
     0.11508564417910448, 0.11508564417910448),
    ("lw_merge n=16384", cost.lw_step(16384, 9813 - (MERGE_REPS - 1) / 2), False,
     0.11486310597014926, 0.11486310597014926),
    ("lw_update n=1968", cost.lw_update("complete", 1968, 1170), True,
     2.2382439534673887e-06, 5.7325373134328354e-06),
    ("lw_update n=16384", cost.lw_update("complete", 16384, 9921), True,
     1.8798731709157578e-05, 4.8146865671641795e-05),
    ("lazy_merge n=1968", cost.lazy_merge(1968, 1206, 11.55, 1.0), True,
     1.818383234185372e-05, 4.6572e-05),
    ("lazy_merge n=8192", cost.lazy_merge(8192, 4924, 13.7, 1.0), False,
     0.00021475641791044776, 0.00021475641791044776),
    ("row_sq_euclidean (1968, 64)", cost.row_sq_euclidean(1968, 64), True,
     5.9666614068021313e-05, 0.00015281671641791046),
    ("row_sq_euclidean (8192, 128)", cost.row_sq_euclidean(8192, 128), True,
     0.0004927288234625848, 0.0012619653731343284),
    ("row_sq_euclidean (32768, 128)", cost.row_sq_euclidean(32768, 128), True,
     0.001970736271630358, 0.005047402985074627),
    ("chain_vote (1968, 64)", cost.chain_vote(1968, 64), True,
     5.9897384898466295e-05, 0.00015340776119402986),
    ("chain_vote (8192, 128)", cost.chain_vote(8192, 128), True,
     0.0004936850072469134, 0.001264414328358209),
    ("chain_vote (32768, 128)", cost.chain_vote(32768, 128), True,
     0.0019745568109343914, 0.005057188059701493),
    ("chain_trip (32768, 128)", cost.chain_trip(32768, 128), True,
     0.0019713926864369565, 0.0050490841791044775),
    ("chain_trip (6155, 128)", cost.chain_trip(6155, 128), True,
     0.0003704917727500395, 0.0009488947388059702),
    ("chain_trip (1968, 64)", cost.chain_trip(1968, 64), True,
     5.9784796705431014e-05, 0.00015311940298507463),
    ("pairwise (124917, 6155, 128)", cost.pairwise_sq_euclidean(124917, 6155, 128), False,
     2.9377495307462684, 2.9377495307462684),
    ("pairwise (65536, 4096, 128)", cost.pairwise_sq_euclidean(65536, 4096, 128), False,
     1.025663831880597, 1.025663831880597),
    ("masked_argmin_batch seed (256, 1024)", cost.masked_argmin_batch(1024, [1024] * 256), False,
     0.32059911641791045, 0.32059911641791045),
    ("masked_argmin_batch seed (256, 512)", cost.masked_argmin_batch(512, [512] * 256), False,
     0.08017002985074627, 0.08017002985074627),
    ("masked_argmin_batch seed (256, 256)", cost.masked_argmin_batch(256, [256] * 256), False,
     0.020052976716417908, 0.020052976716417908),
]


@pytest.mark.parametrize("row", PHASE_2_ROWS, ids=[r[0] for r in PHASE_2_ROWS])
def test_entry_counts_give_the_printed_bounds(row):
    """Every count gives the bound chip_smoke printed from its private
    formulas, to the last bit."""
    _, work, in_l2, bound_ms, hbm_bound_ms = row
    assert _bounds(work, in_l2) == (bound_ms, hbm_bound_ms)


def test_perf_table_bounds():
    """PERF.md §6's HBM bounds, to the digits it prints."""
    def hbm_ms(work):
        return analyze(work).bound_s * 1e3

    assert round(hbm_ms(cost.pairwise_sq_euclidean(124917, 6155, 128)), 3) == 2.938
    assert round(hbm_ms(cost.pairwise_sq_euclidean(65536, 4096, 128)), 3) == 1.026
    assert round(hbm_ms(cost.chain_trip(32768, 128)), 6) == 0.005049
    assert round(hbm_ms(cost.masked_argmin(16384, 16384)), 4) == 0.3205
    assert analyze(cost.pairwise_sq_euclidean(124917, 6155, 128)).dominant == "compute"
    assert analyze(cost.chain_trip(32768, 128)).dominant == "memory"


def test_batch_entries_sum_their_lanes():
    rng = np.random.default_rng(0)
    live = rng.integers(2, 64, size=17).astype(np.float64)
    stale, changed = rng.random(17) * 3, np.ones(17)
    for batch, single in (
            (cost.masked_argmin_batch(64, live), [cost.masked_argmin(64, x) for x in live]),
            (cost.lw_merge_batch(64, live), [cost.lw_step(64, x) for x in live]),
            (cost.lazy_merge_batch(64, live, stale, changed),
             [cost.lazy_merge(64, *x) for x in zip(live, stale, changed)])):
        want = sum(single, Cost())
        assert batch.flops == pytest.approx(want.flops, rel=1e-12)
        assert batch.bytes == pytest.approx(want.bytes, rel=1e-12)
    # a tensor of lanes on any device: the same count
    t = cost.masked_argmin_batch(64, torch.as_tensor(live))
    assert t == cost.masked_argmin_batch(64, live)


def test_lw_merge_loop_over_a_stage_plan():
    """A seed a stage on its live slots, a step a merge at the stage's size
    and the width it leaves: against a loop over every merge."""
    n, n_steps = 1024, 1023
    stages = plan_stages(n, n_steps, min_stage=KERNEL_MIN_STAGE)
    assert stages == ((1024, 512), (512, 256), (256, 255))
    want, done = Cost(), 0
    for size, steps in stages:
        want = want + cost.masked_argmin(size, n - done)
        for k in range(done, done + steps):
            want = want + cost.lw_step(size, n - k - 1)
        done += steps
    got = cost.lw_merge_loop(n, n_steps, stages)
    assert got == want
    unstaged = cost.lw_merge_loop(n, n_steps)
    assert unstaged.bytes > got.bytes and unstaged.flops > got.flops


def test_nn_chain_program():
    assert cost.nn_chain(100, 408, 16) == 408 * cost.chain_trip(100, 16)
    dense = cost.nn_chain(100, 408, method="complete")
    assert dense == 408 * Cost(100, 500) + 99 * cost.lw_update("complete", 100, 100)


def test_service_profile_by_hand():
    """Bucket 8, one lane, complete, serial: 7 merges unstaged.  The seed
    reads 8² cells; merge k leaves L = 7 - k live slots and reads
    4L² + 8L + 17·8 bytes for 2L² + 12·8 operations."""
    sig = bucket_signature(8, 1, method="complete", engine="serial")
    assert (sig.bucket_n, sig.bucket_B, sig.n_steps, sig.compaction) == (8, 1, 7, False)
    prof = profile_program(sig)
    # seed: 64 compares, 4·64 + 8 + 12 bytes; merges: ΣL² = 140, ΣL = 28 over L = 7 … 1
    assert prof.flops == 64 + (2 * 140 + 12 * 8 * 7) == 1016
    assert prof.bytes == (4 * 64 + 8 + 12) + (4 * 140 + 8 * 28 + 17 * 8 * 7) == 2012
    assert prof.coll_bytes == 0.0 and prof.intensity == 1016 / 2012
    # the same bucket with four lanes: four times the work
    assert profile_program(bucket_signature(8, 4, method="complete", engine="serial")) == \
        CostProfile(4 * 1016.0, 4 * 2012.0, 0.0)


def test_service_profile_stages_and_chains():
    """The profile follows the stages the built program runs: the kernel
    program's own plan, and the serial engine's (down to MIN_STAGE_N)."""
    sig = bucket_signature(1024, 2, method="complete", engine="kernel")
    assert sig.compaction
    stages = BucketProgram(sig, "cpu")._loop.stages
    assert len(stages) == 3 and stages[-1][0] == KERNEL_MIN_STAGE
    want = 2 * cost.lw_merge_loop(1024, sig.n_steps, stages)
    assert profile_program(sig) == CostProfile(want.flops, want.bytes, 0.0)
    serial = bucket_signature(1024, 2, method="complete", engine="serial")
    stages = stage_plan("serial", 1024, serial.n_steps, serial.compaction)
    assert len(stages) == 6 and stages[-1][0] == MIN_STAGE_N
    want = 2 * cost.lw_merge_loop(1024, serial.n_steps, stages)
    assert profile_program(serial) == CostProfile(want.flops, want.bytes, 0.0)
    chain = bucket_signature(64, 4, method="ward", algorithm="nnchain", points_dim=16)
    assert chain.algorithm == "nnchain"
    want = 4 * (4 * 64 + 8) * cost.chain_trip(64, 16)
    assert profile_program(chain) == CostProfile(want.flops, want.bytes, 0.0)


def test_cache_keeps_profiles_of_cached_programs_only():
    cache = CompileCache(capacity=1, device="cpu")
    a = bucket_signature(8, 1, method="complete", engine="serial")
    b = bucket_signature(16, 1, method="complete", engine="serial")
    cache.get(a)
    assert cache.cost_profiles == {a: profile_program(a)}
    cache.get(b)
    assert cache.cost_profiles == {b: profile_program(b)} and cache.stats.evictions == 1


def ranks_wire_bytes() -> dict:
    """On each rank of the group: one collective of each kind on a ring."""
    import torch.distributed as dist

    from repro_torch.core.distributed import make_cluster_mesh

    ring = make_cluster_mesh("cpu")
    x = torch.arange(4, dtype=torch.float32)
    ring.all_gather(x[:3])            # out 6 floats
    ring.all_reduce(x.clone())        # out 4 floats
    ring.reduce_scatter(x.clone())    # out 4 / p floats
    ring.all_to_all(x.clone())        # out 4 floats
    ring.all_reduce(torch.zeros(2, dtype=torch.float64))
    return dict(p=dist.get_world_size(), collectives=ring.collectives, wire=dict(ring.wire_bytes),
                by_op=collective_bytes(ring))


def test_ring_counts_wire_bytes(tmp_path):
    results = run_ranks(2, "ranks_wire_bytes", tmp_path, module="test_torch_roofline")
    for r in results:
        assert r["p"] == 2 and r["collectives"] == 5
        want = {"all-gather": ref_wire_bytes("all-gather", 24, 2),
                "all-reduce": ref_wire_bytes("all-reduce", 16, 2)
                + ref_wire_bytes("all-reduce", 16, 2),
                "reduce-scatter": ref_wire_bytes("reduce-scatter", 8, 2),
                "all-to-all": ref_wire_bytes("all-to-all", 16, 2)}
        assert want == {"all-gather": 12.0, "all-reduce": 32.0, "reduce-scatter": 8.0,
                        "all-to-all": 8.0}
        assert r["wire"] == want and r["by_op"] == want
