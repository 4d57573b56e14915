"""Fault-tolerance pieces the clustering service needs: failure
injection, step deadlines (straggler detection) and bounded retry.

Counterpart of :mod:`repro.distributed.fault`, framework-free and copied
here because the port imports nothing of the JAX package.  The failure
signal of a real deployment comes from the runtime (a failed launch, a
lost device); here it is *simulated*, so the recovery machinery (deadline
flagging, bounded retry) is real code under test.  The restartable step
loop (``run_resilient_loop``) comes with the distributed engines
(ROADMAP.md A7).

Every fault event also lands on the process-global metrics registry
(``fault_injected_failures_total`` / ``fault_deadline_exceeded_total`` /
``fault_retries_total``, see :mod:`repro_torch.obs`), so a load run's
dump shows the fault history without anyone having captured the log.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

from repro_torch.obs import get_registry


def _count_fault(name: str, help_text: str) -> None:
    get_registry().counter(name, help_text).inc()


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / preemption at a given step."""


@dataclass
class FailurePlan:
    """Deterministic failure injection: fail the first time each listed
    step is reached (not on the retry — mimicking a replaced node)."""

    fail_at: tuple[int, ...] = ()
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            _count_fault(
                "fault_injected_failures_total",
                "SimulatedFailure raises from FailurePlan.check",
            )
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class StepDeadline:
    """Straggler watchdog: flags steps exceeding ``factor ×`` the median.

    On a multi-device job a straggling host stalls the collective; the standard
    mitigations are (a) alert + checkpoint-restart without the bad host
    (elastic), (b) skip noncritical work (e.g. eval) until caught up.
    This monitor produces the signal; the trainer logs and can trigger an
    early checkpoint."""

    factor: float = 3.0
    warmup: int = 5
    history: list = field(default_factory=list)

    def observe(self, seconds: float) -> bool:
        self.history.append(seconds)
        if len(self.history) <= self.warmup:
            return False
        med = sorted(self.history[:-1])[len(self.history[:-1]) // 2]
        exceeded = seconds > self.factor * max(med, 1e-6)
        if exceeded:
            _count_fault(
                "fault_deadline_exceeded_total",
                "Steps/segments flagged past the straggler deadline",
            )
        return exceeded


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff — the ONE retry shape in the repo.

    ``attempts`` counts *total* tries (1 = no retry).  ``delays()``
    yields the sleep before each retry: ``base × multiplier^k`` capped
    at ``max_delay_s``.  Deterministic (no jitter) so tests and the
    segmented distributed driver replay identically; callers that need
    jitter add it on top.

    Used by the service dispatcher for transient engine failures
    (DESIGN.md §14) and available to the distributed chain's segment
    retry — both count their retries on the metrics registry.
    """

    attempts: int = 3
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1 (backoff never shrinks), got "
                f"{self.multiplier}"
            )

    def delays(self) -> Iterator[float]:
        """The sleep before retry k (``attempts - 1`` values)."""
        d = self.base_delay_s
        for _ in range(self.attempts - 1):
            yield min(d, self.max_delay_s)
            d *= self.multiplier


def retry_call(
    fn: Callable[[], object],
    policy: RetryPolicy,
    *,
    retry_if: Callable[[BaseException], bool] = lambda e: True,
    on_retry: Callable[[int, BaseException], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn`` under ``policy``; re-raise the last error when the
    budget is spent or ``retry_if`` declines.

    Every performed retry lands on the process-global
    ``fault_retries_total`` counter; ``on_retry(attempt, exc)`` lets the
    caller add its own telemetry (the service counts
    ``service_retries_total`` there).
    """
    delays = policy.delays()
    attempt = 1
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — predicate decides
            delay = next(delays, None)
            if delay is None or not retry_if(exc):
                raise
            _count_fault(
                "fault_retries_total",
                "Bounded-backoff retries performed by retry_call",
            )
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(delay)
            attempt += 1
