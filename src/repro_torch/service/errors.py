"""Typed service errors (DESIGN.md §14).

Every way the serving layer can decline or lose a request gets its own
exception class, because the client-side handling genuinely differs:

* :class:`ServiceOverloaded` — admission control said no (queue full,
  quota exceeded, or this job was the shed victim).  Retriable after
  backoff; the request never touched an engine.
* :class:`DeadlineExceeded` — the request's ``deadline_ms`` expired
  while it waited.  Expired jobs are shed *before* a bucket is padded,
  so a dead request never consumes engine time.  Retrying is usually
  wrong (the caller already gave up); resubmit with a larger deadline.
* :class:`WorkerWedged` — the bucket executing this request blew the
  hard watchdog deadline; the worker was replaced (warmed
  ``CompileCache`` intact — the retry costs no recompile).  Safe to
  resubmit immediately.
* :class:`ServiceClosed` — the service shut down with this request
  still queued.  Not retriable against the same instance.

All derive from :class:`ServiceError` (itself ``RuntimeError`` so
pre-§14 callers that caught ``RuntimeError`` keep working), and the
batcher *resolves futures* with them rather than raising — one starved
tenant or overload burst cannot take down a submission loop.

:func:`is_transient` is the retry predicate the dispatcher's bounded
retry (``ServiceConfig.max_retries``) consults: engine-side failures
(device OOM, a poisoned runtime call) are worth one more attempt;
validation errors and the typed declines above are not.
"""

from __future__ import annotations


class ServiceError(RuntimeError):
    """Base class for every typed serving-layer error."""


class ServiceClosed(ServiceError):
    """The service is closed; the request was not (or will not be) served."""


class ServiceOverloaded(ServiceError):
    """Admission control declined the request (backpressure).

    ``reason`` is one of ``"queue-full"`` / ``"quota"`` / ``"shed"``;
    ``lane`` is the priority lane the request was assigned to and
    ``tenant`` the quota bucket it was counted against (both echoed so
    a client can adapt — lower its rate, raise its priority, or spread
    across tenants).
    """

    def __init__(self, msg: str, *, reason: str = "queue-full",
                 lane: int = 0, tenant: str | None = None) -> None:
        super().__init__(msg)
        self.reason = reason
        self.lane = lane
        self.tenant = tenant


class DeadlineExceeded(ServiceError):
    """The request's deadline expired before it reached an engine."""


class WorkerWedged(ServiceError):
    """Bucket execution exceeded the hard watchdog deadline.

    The supervised worker running the bucket was abandoned and replaced;
    only this bucket's futures fail.  The compile cache survives the
    restart, so resubmitting costs a cache hit, not a recompile.
    """


#: Exception types the dispatcher never retries: caller errors (the
#: input is wrong no matter how often we run it) and our own typed
#: declines (retrying a shed or a wedge inside the service would
#: amplify the overload the shed existed to relieve).
NON_TRANSIENT = (ValueError, TypeError, KeyError, ServiceError)


def is_transient(exc: BaseException) -> bool:
    """Whether a bucket-execution failure is worth a backoff-retry."""
    return not isinstance(exc, NON_TRANSIENT)
