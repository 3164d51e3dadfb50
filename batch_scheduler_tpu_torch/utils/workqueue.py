"""Rate-limited work queue: the controller's retry engine.

Equivalent of k8s.io/client-go/util/workqueue with the item-exponential
failure rate limiter the reference wires in
(reference pkg/scheduler/batch/batchscheduler.go:441,
pkg/scheduler/controller/controller.go:75): per-key exponential backoff
between ``base`` and ``cap`` seconds, deduplication of queued keys, and
in-flight tracking so a key being processed re-queues instead of running
twice concurrently.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, Optional, Set

__all__ = ["RateLimitingQueue"]


class RateLimitingQueue:
    def __init__(
        self,
        base_delay: float = 1.0,
        max_delay: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._base = base_delay
        self._cap = max_delay
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: list = []  # FIFO of ready keys; guarded-by: _cond
        self._queued: Set[str] = set()  # guarded-by: _cond
        self._processing: Set[str] = set()  # guarded-by: _cond
        self._dirty: Set[str] = set()  # re-added while processing; guarded-by: _cond
        self._failures: Dict[str, int] = {}  # guarded-by: _cond
        self._delayed: list = []  # heap of (ready_at, seq, key); guarded-by: _cond
        self._seq = 0  # guarded-by: _cond
        self._shutdown = False  # guarded-by: _cond

    # -- add/get/done ------------------------------------------------------

    def add(self, key: str) -> None:
        with self._cond:
            if self._shutdown:
                return
            if key in self._processing:
                self._dirty.add(key)
                return
            if key in self._queued:
                return
            self._queued.add(key)
            self._queue.append(key)
            self._cond.notify()

    def add_after(self, key: str, delay: float) -> None:
        with self._cond:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (self._clock() + delay, self._seq, key))
            self._cond.notify()

    def add_rate_limited(self, key: str) -> None:
        with self._cond:
            failures = self._failures.get(key, 0)
            self._failures[key] = failures + 1
        delay = min(self._base * (2**failures), self._cap)
        self.add_after(key, delay)

    def forget(self, key: str) -> None:
        with self._cond:
            self._failures.pop(key, None)

    def get(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block for the next ready key; None on timeout or shutdown."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                self._promote_due_locked()
                if self._queue:
                    key = self._queue.pop(0)
                    self._queued.discard(key)
                    self._processing.add(key)
                    return key
                if self._shutdown:
                    return None
                now = self._clock()
                if deadline is not None and now >= deadline:
                    return None
                waits = []
                if self._delayed:
                    due = self._delayed[0][0] - now
                    if due <= 0:
                        continue  # item became due; loop re-promotes it
                    waits.append(due)
                if deadline is not None:
                    waits.append(deadline - now)
                self._cond.wait(min(waits) if waits else None)

    def is_shut_down(self) -> bool:
        with self._cond:
            return self._shutdown

    def done(self, key: str) -> None:
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty:
                self._dirty.discard(key)
                if key not in self._queued:
                    self._queued.add(key)
                    self._queue.append(key)
                    self._cond.notify()

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue) + len(self._delayed)

    # -- internals ---------------------------------------------------------

    def _promote_due_locked(self) -> None:  # lock-held: _cond
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, key = heapq.heappop(self._delayed)
            if key in self._processing:
                self._dirty.add(key)
            elif key not in self._queued:
                self._queued.add(key)
                self._queue.append(key)

