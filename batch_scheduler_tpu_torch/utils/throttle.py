"""Client-side API rate limiting: a token-bucket flow limiter. The port's
copy of ``batch_scheduler_tpu/utils/throttle.py``.

The reference caps its PodGroup clientset at QPS=10 / Burst=20 on the rest
config (reference pkg/scheduler/batch/batchscheduler.go:391-392 — client-go
``flowcontrol.NewTokenBucketRateLimiter`` underneath); without it the
controller's periodic resync across every group is a stampede against a
real API server. ``TokenBucket`` is that limiter: ``burst`` tokens capacity,
refilled at ``qps`` per second, ``acquire()`` blocks until a token is
available. ``qps <= 0`` disables limiting (client-go's -1 semantics).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["TokenBucket"]


class TokenBucket:
    def __init__(
        self,
        qps: float,
        burst: int,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.qps = float(qps)
        self.burst = int(burst)
        if self.qps > 0 and self.burst < 1:
            # tokens cap at burst: they could never reach 1 and acquire()
            # would block forever (client-go likewise requires burst >= 1)
            raise ValueError(f"burst must be >= 1 when qps > 0, got {burst}")
        self._tokens = float(burst)
        self._clock = clock
        self._sleep = sleep
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._last) * self.qps
        )
        self._last = now

    # refill arithmetic accumulates float residue (a token can come back as
    # 0.9999999999999996); without the tolerance acquire() would spin on
    # sub-representable sleeps
    _EPS = 1e-9

    def try_acquire(self) -> bool:
        """Take a token if one is available; never blocks."""
        if self.qps <= 0:
            return True
        with self._lock:
            self._refill_locked()
            if self._tokens >= 1.0 - self._EPS:
                self._tokens -= 1.0
                return True
            return False

    def acquire(self) -> None:
        """Block until a token is available, then take it."""
        if self.qps <= 0:
            return
        while True:
            with self._lock:
                self._refill_locked()
                if self._tokens >= 1.0 - self._EPS:
                    self._tokens -= 1.0
                    return
                wait = max((1.0 - self._tokens) / self.qps, self._EPS)
            self._sleep(wait)
