"""Retry + circuit-breaker primitives for unreliable transports.

The port's copy of ``batch_scheduler_tpu/utils/retry.py``. The oracle
sidecar sits across a network boundary (Go control plane <-> the sidecar
that owns the accelerator, the north-star deployment split); a production
scheduler must treat that link as a thing that fails. This module holds the two reusable
policies the service client composes:

- :class:`RetryPolicy` — bounded attempts with exponential backoff and
  DECORRELATED jitter (first delay drawn uniformly from [0, cap]; each
  later delay from [base, 3*prev], capped at max_delay): under a
  fleet-wide sidecar crash every client starts its retry chain at the
  same instant, and full jitter alone re-correlates the herd around the
  shared exponential envelope — decorrelating each draw on the client's
  OWN previous delay spreads the reconnect stampede the standby would
  otherwise absorb as one thundering wave (the HA failover concern,
  docs/resilience.md "High availability").
- :class:`CircuitBreaker` — closed -> open after N consecutive failures,
  open -> half-open after a cooldown, half-open -> closed on a successful
  probe (or back to open on a failed one). While open, callers fail fast
  instead of burning a connect timeout per request — the property that
  makes the scorer's conservative CPU fallback cheap enough to serve every
  scheduling cycle during an outage.

Neither class knows about sockets or the oracle protocol; what counts as a
failure is the caller's classification (see service.client: semantic
in-band answers such as a stale-batch error must never advance the
breaker).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "CircuitBreaker"]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + decorrelated jitter.

    ``max_attempts`` counts the first try: 4 means one initial attempt and
    up to three retries. ``backoff(i)`` returns the sleep before retry
    ``i`` (0-based): with no ``prev`` (the chain's first draw, or a
    stateless caller) uniform in [0, min(max_delay, base * multiplier^i)]
    — full jitter; with ``prev`` (the previous delay in this retry chain)
    the decorrelated draw uniform in [base, 3 * prev], capped at
    ``max_delay``. Two clients whose chains start identically diverge on
    their first draws and then *stay* diverged — each delay feeds the
    next draw's range — where per-index full jitter would keep re-sampling
    the same envelope in lockstep.
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0

    def backoff(
        self,
        retry_index: int,
        rng: Optional[random.Random] = None,
        prev: Optional[float] = None,
    ) -> float:
        r = rng or random
        if prev is not None:
            lo = self.base_delay
            hi = max(3.0 * prev, lo)
            return min(self.max_delay, r.uniform(lo, hi))
        cap = min(self.max_delay, self.base_delay * self.multiplier ** max(retry_index, 0))
        return r.uniform(0.0, cap)

    def call(
        self,
        fn: Callable,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        no_retry: Tuple[Type[BaseException], ...] = (),
        sleep: Callable[[float], None] = time.sleep,
        on_retry: Optional[Callable] = None,
    ):
        """Run ``fn()`` under this policy. ``no_retry`` wins over
        ``retry_on``; ``on_retry(retry_index, exc, delay)`` observes each
        retry. The last failure is re-raised unwrapped. Each retry's
        delay decorrelates on the previous one (``backoff(prev=...)``) —
        the chain state lives here, per call, so the frozen policy stays
        shareable across threads."""
        prev = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except no_retry:
                raise
            except retry_on as e:
                if attempt == self.max_attempts - 1:
                    raise
                delay = self.backoff(attempt, prev=prev)
                prev = delay
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                sleep(delay)


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a half-open probe slot.

    States: ``closed`` (requests flow; failures counted), ``open``
    (requests refused until ``reset_timeout`` elapses), ``half-open`` (one
    probe admitted; its outcome decides closed vs a fresh open cooldown).

    The breaker only bookkeeps — callers drive it::

        decision = breaker.admit()      # "attempt" | "probe" | "refuse"
        ... on success: breaker.record_success()
        ... on transport failure: breaker.record_failure()

    ``on_transition(new_state)`` (assignable) observes every state change —
    the service client mirrors it into the ``bst_oracle_breaker_state``
    gauge.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str], None]] = None,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout = float(reset_timeout)
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new_state: str) -> None:
        # under self._lock
        if new_state == self._state:
            return
        self._state = new_state
        if self.on_transition is not None:
            self.on_transition(new_state)

    def would_attempt(self) -> bool:
        """True when the next ``admit()`` would NOT refuse — i.e. the
        breaker is closed, half-open, or its open cooldown has elapsed.
        Cheap liveness signal for callers deciding whether a degraded
        cache is worth re-probing."""
        with self._lock:
            return not (
                self._state == self.OPEN
                and self._clock() - self._opened_at < self.reset_timeout
            )

    def admit(self) -> str:
        """Gate one request: ``"attempt"`` (closed — go ahead),
        ``"probe"`` (half-open — send a cheap liveness probe first),
        ``"refuse"`` (open — fail fast, do not touch the transport)."""
        with self._lock:
            if self._state == self.CLOSED:
                return "attempt"
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout:
                    self._transition(self.HALF_OPEN)
                    return "probe"
                return "refuse"
            return "probe"  # half-open: a prior probe never reported back

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                # re-arm the cooldown on every failure while open: a
                # failed probe buys a full fresh reset_timeout
                self._opened_at = self._clock()
                self._transition(self.OPEN)
