"""repro_torch.distributed — the sharding rules of the clustering engines'
data, and the fault simulation and bounded retry of the service (the
restartable step loop comes with ROADMAP.md A7.2)."""

from repro_torch.distributed.fault import (
    FailurePlan,
    RetryPolicy,
    SimulatedFailure,
    StepDeadline,
    retry_call,
)
from repro_torch.distributed.sharding import replicate, shard_rows

__all__ = ["FailurePlan", "RetryPolicy", "SimulatedFailure", "StepDeadline", "replicate",
           "retry_call", "shard_rows"]
