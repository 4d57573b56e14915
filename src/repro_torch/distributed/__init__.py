"""repro_torch.distributed — fault simulation and bounded retry (the
sharding rules and collectives come with ROADMAP.md A7)."""

from repro_torch.distributed.fault import (
    FailurePlan,
    RetryPolicy,
    SimulatedFailure,
    StepDeadline,
    retry_call,
)

__all__ = ["FailurePlan", "RetryPolicy", "SimulatedFailure", "StepDeadline", "retry_call"]
