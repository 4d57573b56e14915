"""repro_torch.distributed — the sharding rules of the clustering engines'
data, and the fault simulation, bounded retry and restartable step loop."""

from repro_torch.distributed.fault import (
    FailurePlan,
    RetryPolicy,
    SimulatedFailure,
    StepDeadline,
    retry_call,
    run_resilient_loop,
)
from repro_torch.distributed.sharding import replicate, shard_rows

__all__ = ["FailurePlan", "RetryPolicy", "SimulatedFailure", "StepDeadline", "replicate",
           "retry_call", "run_resilient_loop", "shard_rows"]
