"""The three-term roofline of a piece of work on one H100.

The counterpart of :mod:`repro.roofline.analysis`, with the same
:class:`Roofline` fields, properties and ``to_dict`` keys, all in seconds:

    compute    = flops_per_device / peak_flops   (float32 unless told)
    memory     = bytes_per_device / byte_rate    (HBM unless told)
    collective = coll_bytes_per_device / NVLINK_BW

Where the JAX package reads a compiled program's HLO, the port builds a
roofline from an analytic :class:`~repro_torch.roofline.cost.Cost`
(:func:`analyze`).  A kernel whose operands stay in the L2 between
launches is held to the L2 read rate that its caller measures on the card
(``byte_rate``); a kernel on the tensor cores to their peak
(``peak_flops``).  :func:`model_flops` is the reference's 6·N·D count of
an LM cell's work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.roofline import hw
from repro_torch.roofline.cost import Cost

#: The collectives a :class:`~repro_torch.core.distributed.Ring` counts,
#: under the reference's HLO op names.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


@dataclass
class Roofline:
    """The reference's roofline record.  ``raw_cost_analysis`` stays
    empty: it holds a compiler's own cost analysis, and the port's counts
    are analytic; it is kept so that ``to_dict`` has the reference's keys."""

    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    chips: int
    coll_breakdown: dict = field(default_factory=dict)
    raw_cost_analysis: dict = field(default_factory=dict)
    peak_flops: float = hw.PEAK_FLOPS_F32
    byte_rate: float = hw.HBM_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.byte_rate

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / hw.NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "coll_breakdown": self.coll_breakdown,
            "raw_cost_analysis": self.raw_cost_analysis,
        }


def analyze(cost: Cost, chips: int = 1, *, peak_flops: float = hw.PEAK_FLOPS_F32,
            byte_rate: float = hw.HBM_BW, coll_breakdown: dict | None = None) -> Roofline:
    """The roofline of ``cost``, a device's share of work spread over
    ``chips`` devices."""
    return Roofline(flops_per_device=cost.flops, bytes_per_device=cost.bytes,
                    coll_bytes_per_device=cost.coll_bytes, chips=chips,
                    coll_breakdown=dict(coll_breakdown or {}), peak_flops=peak_flops,
                    byte_rate=byte_rate)


def collective_bytes(ring) -> dict[str, float]:
    """The wire bytes a :class:`~repro_torch.core.distributed.Ring`'s
    collectives put on the wire from this rank, by op."""
    return {op: ring.wire_bytes.get(op, 0.0) for op in COLLECTIVES}


def model_flops(cfg, shape, steps: int = 1) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) training FLOPs for the cell;
    forward-only kinds use 2·N·D.  ``cfg`` is a
    :class:`~repro_torch.configs.base.ModelConfig`, ``shape`` a
    :class:`~repro_torch.configs.shapes.Shape`."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens * steps
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens * steps
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens * steps
