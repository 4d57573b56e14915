"""Supervised bucket-execution worker + watchdog (DESIGN.md §14).

Pre-§14 the dispatcher thread executed buckets inline, so ONE wedged
engine call (a driver hang, a pathological compile, a stuck allocator)
stalled every tenant forever — nothing downstream of the dispatcher
could run, and ``close()`` could only time out.  This module moves
execution onto a **supervised worker thread** the dispatcher can give
up on:

* the dispatcher hands the worker one thunk and waits with a **hard
  deadline**; past it the worker is declared wedged, a typed
  :class:`~repro_torch.service.errors.WorkerWedged` comes back (failing only
  that bucket's futures), and the service replaces the worker;
* a **soft deadline** (:class:`repro_torch.distributed.fault.StepDeadline` —
  the same ``factor × running-median`` straggler watchdog the
  distributed chain uses) flags slow-but-alive buckets into a counter
  without killing anything;
* Python cannot kill a thread, so a wedged worker is *abandoned*: it is
  daemonic, its generation is retired, and a result it eventually
  produces is discarded at the rendezvous (the job-level ``done`` flag
  in the batcher makes late resolution a no-op anyway).  What survives
  the restart is exactly what must: the :class:`CompileCache` is owned
  by the service, not the worker, so the first request on the same
  ``BucketSignature`` after recovery is a cache **hit** — the
  zero-recompile contract holds across worker generations
  (``tests/test_torch_service_robustness.py`` asserts it).
"""

from __future__ import annotations

import threading
from typing import Callable

from repro_torch.distributed.fault import StepDeadline
from repro_torch.service.errors import WorkerWedged


class _WorkItem:
    """One thunk + its rendezvous state."""

    __slots__ = ("thunk", "done", "result", "error", "abandoned")

    def __init__(self, thunk: Callable[[], object]) -> None:
        self.thunk = thunk
        self.done = False
        self.abandoned = False
        self.result: object = None
        self.error: BaseException | None = None


class BucketWorker:
    """One supervised executor thread, used serially by the dispatcher.

    The dispatcher is the only caller of :meth:`run`, so the worker
    holds at most one item; the lock exists for the cross-thread
    rendezvous, not for queueing.
    """

    def __init__(self, name: str = "lw-service-worker",
                 generation: int = 0) -> None:
        self.name = name
        self.generation = generation
        self._cond = threading.Condition()
        self._item: _WorkItem | None = None
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-g{generation}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._item is not None or self._stop)
                if self._stop and self._item is None:
                    return
                item = self._item
            try:
                result = item.thunk()
                error = None
            except BaseException as exc:  # noqa: BLE001 — ferried to the caller
                result, error = None, exc
            with self._cond:
                item.done = True
                item.result, item.error = result, error
                self._item = None
                self._cond.notify_all()
                if item.abandoned:
                    # the supervisor gave up on us mid-thunk: this thread
                    # is retired, its (late) result already discarded
                    return
                if self._stop:
                    return

    def run(self, thunk: Callable[[], object], *,
            hard_deadline_s: float | None) -> object:
        """Execute ``thunk`` on the worker; raise what it raises.

        Blocks the calling (dispatcher) thread at most
        ``hard_deadline_s``; past that the worker is marked wedged and
        :class:`WorkerWedged` raises — the thunk may still be running
        on the abandoned thread, but nothing will ever wait on it again.
        """
        item = _WorkItem(thunk)
        with self._cond:
            if self._stop:
                raise WorkerWedged(
                    f"worker {self.name} (generation {self.generation}) is "
                    "retired"
                )
            if self._item is not None:      # pragma: no cover — serial caller
                raise AssertionError("BucketWorker.run is not reentrant")
            self._item = item
            self._cond.notify_all()
            if not self._cond.wait_for(lambda: item.done, hard_deadline_s):
                item.abandoned = True
                self._stop = True
                raise WorkerWedged(
                    f"bucket execution exceeded the hard deadline "
                    f"({hard_deadline_s:.3f}s) on worker generation "
                    f"{self.generation} — bucket futures failed, worker "
                    "replaced (compile cache intact: recovery costs no "
                    "recompile)"
                )
        if item.error is not None:
            raise item.error
        return item.result

    def stop(self) -> None:
        """Retire an idle worker (close path; wedged ones self-retire)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    def join(self, timeout: float | None = None) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    @property
    def wedged(self) -> bool:
        with self._cond:
            return self._stop and self._item is not None


class Watchdog:
    """Soft/hard deadline pair around a :class:`BucketWorker`.

    Owns the worker lifecycle: :meth:`run` executes one thunk under the
    hard deadline and, on a wedge, replaces the worker (bumping the
    generation) before re-raising, so the *next* bucket finds a live
    executor.  The soft deadline is the distributed runtime's
    :class:`StepDeadline`: ``factor ×`` the running median flags a
    straggling bucket into ``on_straggler`` (the service counts it)
    without failing anything.
    """

    def __init__(
        self,
        *,
        hard_deadline_s: float | None,
        soft_factor: float = 3.0,
        soft_warmup: int = 8,
        name: str = "lw-service-worker",
        on_straggler: Callable[[float], None] | None = None,
        on_restart: Callable[[int], None] | None = None,
    ) -> None:
        self.hard_deadline_s = hard_deadline_s
        self.soft = StepDeadline(factor=soft_factor, warmup=soft_warmup)
        self._name = name
        self._on_straggler = on_straggler
        self._on_restart = on_restart
        self.restarts = 0
        self.stragglers = 0
        self._worker = BucketWorker(name, generation=0)

    @property
    def generation(self) -> int:
        return self._worker.generation

    def run(self, thunk: Callable[[], object]) -> object:
        import time

        t0 = time.perf_counter()
        try:
            result = self._worker.run(
                thunk, hard_deadline_s=self.hard_deadline_s
            )
        except WorkerWedged:
            self.restarts += 1
            self._worker = BucketWorker(
                self._name, generation=self._worker.generation + 1
            )
            if self._on_restart is not None:
                self._on_restart(self._worker.generation)
            raise
        dt = time.perf_counter() - t0
        if self.soft.observe(dt):
            self.stragglers += 1
            if self._on_straggler is not None:
                self._on_straggler(dt)
        return result

    def stop(self) -> None:
        self._worker.stop()
