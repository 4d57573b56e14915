"""Admission control for the clustering service (DESIGN.md §14).

The pre-§14 batcher fed the dispatcher from an *unbounded*
``queue.Queue``: under overload the backlog — and therefore every
request's queueing delay — grew without bound, and the only signal was
p99 going vertical.  This module replaces it with a bounded multi-lane
queue that makes the overload decision **at submit time**, where it is
cheap and typed, instead of discovering it minutes later in a latency
percentile:

* **priority lanes** — ``n_lanes`` FIFO deques, lane 0 highest.  The
  dispatcher always drains the highest non-empty lane, and load
  shedding evicts from the *lowest* non-empty lane first, so paid
  traffic rides out an overload that free-tier traffic absorbs.
* **bounded + policy** — at ``max_queue`` queued jobs the configured
  :class:`OverloadPolicy` decides: ``block`` the submitter (classic
  backpressure), ``reject`` the newcomer, or ``shed-oldest`` (evict the
  oldest job of the lowest lane ≥ the newcomer's lane and admit the
  newcomer — freshest-first, the lane rule above deciding who pays).
* **per-tenant quotas** — a tenant may hold at most ``tenant_quota``
  queued jobs; job ``quota + 1`` is rejected *regardless of policy* (a
  quota breach must not block the submitter or shed a neighbour — that
  would let one tenant convert its overload into everyone's).

Everything happens under ONE condition lock, which also fixes the old
``submit()``/``close()`` race: ``offer`` checks ``closed`` and links
the job in the same critical section that ``close_and_drain`` uses to
set ``closed`` and sweep the lanes, so a job is either swept (typed
``ServiceClosed``) or visible to the dispatcher — never stranded.  The
same condition gives the dispatcher an **event-driven wakeup**
(:meth:`take`): an idle service sleeps in ``Condition.wait`` (no 20 ms
poll burning CPU) and wakes on the next offer or on close.

Futures are never resolved while holding the lock — every verdict is
returned to the caller as a :class:`Decision` and acted on outside.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # pragma: no cover — type-only import, no cycle at runtime
    from repro_torch.service.batcher import _Job

#: Admission policies at the ``max_queue`` bound.
OVERLOAD_POLICIES: tuple[str, ...] = ("block", "reject", "shed-oldest")


@dataclass
class Decision:
    """One admission verdict, resolved by the caller OUTSIDE the lock.

    ``admitted`` — the offered job was linked into a lane.
    ``rejected_reason`` — set when the offered job itself was declined
    (``"queue-full"`` / ``"quota"`` / ``"shed"`` / ``"closed"`` /
    ``"deadline"`` — the latter when a *block* policy wait outlived the
    job's own deadline).
    ``victims`` — jobs evicted to admit the offered one (shed-oldest).
    """

    admitted: bool
    rejected_reason: str | None = None
    victims: list = field(default_factory=list)


class AdmissionQueue:
    """Bounded, lane-ordered, quota-aware handoff between submitters and
    the dispatcher thread.  All state lives under one ``Condition``."""

    def __init__(
        self,
        *,
        max_queue: int,
        n_lanes: int,
        policy: str,
        tenant_quota: int | None = None,
        clock: Callable[[], float] | None = None,
    ) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload_policy must be one of {OVERLOAD_POLICIES}, got "
                f"{policy!r}"
            )
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1 or None, got {tenant_quota}"
            )
        import time

        self.max_queue = max_queue
        self.n_lanes = n_lanes
        self.policy = policy
        self.tenant_quota = tenant_quota
        self._clock = clock or time.perf_counter
        self._lanes: tuple[deque, ...] = tuple(deque() for _ in range(n_lanes))
        self._per_tenant: dict[str, int] = {}
        self._count = 0
        self._closed = False
        self._cond = threading.Condition()

    # -- introspection (lock-taking; cheap) ---------------------------------

    def __len__(self) -> int:
        with self._cond:
            return self._count

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def depths(self) -> list[int]:
        """Queued jobs per lane (index = lane)."""
        with self._cond:
            return [len(lane) for lane in self._lanes]

    def tenant_depth(self, tenant: str) -> int:
        with self._cond:
            return self._per_tenant.get(tenant, 0)

    # -- submit side --------------------------------------------------------

    def offer(self, job: "_Job") -> Decision:
        """Admit ``job`` under the policy; never resolves futures.

        With the ``block`` policy a full queue parks the *submitter*
        here until space frees, the queue closes, or the job's own
        deadline passes (waiting past it would admit a corpse the
        dispatcher immediately sheds).
        """
        lane = job.lane
        if not 0 <= lane < self.n_lanes:
            raise ValueError(
                f"lane must be in [0, {self.n_lanes}), got {lane}"
            )
        with self._cond:
            if self._closed:
                return Decision(False, rejected_reason="closed")
            if (
                self.tenant_quota is not None
                and job.tenant is not None
                and self._per_tenant.get(job.tenant, 0) >= self.tenant_quota
            ):
                return Decision(False, rejected_reason="quota")
            if self._count >= self.max_queue:
                if self.policy == "reject":
                    return Decision(False, rejected_reason="queue-full")
                if self.policy == "shed-oldest":
                    victim = self._pop_shed_victim(lane)
                    if victim is None:
                        # everything queued outranks the newcomer — it
                        # is its own shed victim
                        return Decision(False, rejected_reason="shed")
                    self._link(job)
                    self._cond.notify_all()
                    return Decision(True, victims=[victim])
                # block: classic backpressure on the submitting thread
                while self._count >= self.max_queue and not self._closed:
                    timeout = None
                    if job.deadline is not None:
                        timeout = job.deadline - self._clock()
                        if timeout <= 0:
                            return Decision(False, rejected_reason="deadline")
                    self._cond.wait(timeout)
                if self._closed:
                    return Decision(False, rejected_reason="closed")
            self._link(job)
            self._cond.notify_all()
            return Decision(True)

    def _link(self, job: "_Job") -> None:
        self._lanes[job.lane].append(job)
        self._count += 1
        if job.tenant is not None:
            self._per_tenant[job.tenant] = (
                self._per_tenant.get(job.tenant, 0) + 1
            )

    def _unlink_accounting(self, job: "_Job") -> None:
        self._count -= 1
        if job.tenant is not None:
            left = self._per_tenant.get(job.tenant, 0) - 1
            if left > 0:
                self._per_tenant[job.tenant] = left
            else:
                self._per_tenant.pop(job.tenant, None)

    def _pop_shed_victim(self, incoming_lane: int):
        """Oldest job of the lowest-priority non-empty lane, provided
        that lane is no higher-priority than the newcomer's."""
        for lane_idx in range(self.n_lanes - 1, incoming_lane - 1, -1):
            lane = self._lanes[lane_idx]
            if lane:
                victim = lane.popleft()
                self._unlink_accounting(victim)
                self._cond.notify_all()
                return victim
        return None

    # -- dispatcher side ----------------------------------------------------

    def take(self, timeout: float | None = None):
        """Highest-lane oldest job; blocks (event-driven, no poll) until
        one arrives, the queue closes, or ``timeout`` elapses.

        Returns ``None`` on close-with-empty-queue or timeout — the two
        are distinguished by :attr:`closed`.
        """
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._count > 0 or self._closed, timeout
            ):
                return None                     # timed out (batching window)
            if self._count == 0:
                return None                     # closed and drained
            for lane in self._lanes:
                if lane:
                    job = lane.popleft()
                    self._unlink_accounting(job)
                    self._cond.notify_all()     # block-policy submitters
                    return job
            raise AssertionError("count > 0 with all lanes empty")

    # -- lifecycle ----------------------------------------------------------

    def close_and_drain(self) -> list:
        """Atomically mark closed and sweep every queued job out.

        The same critical section that flips ``closed`` empties the
        lanes, so an ``offer`` racing with close either lands *before*
        (its job is in the returned sweep) or *after* (it sees
        ``closed`` and reports it) — there is no in-between where a job
        sits linked in a queue no dispatcher will ever read again.
        """
        with self._cond:
            self._closed = True
            swept: list = []
            for lane in self._lanes:
                swept.extend(lane)
                lane.clear()
            self._count = 0
            self._per_tenant.clear()
            self._cond.notify_all()
            return swept
