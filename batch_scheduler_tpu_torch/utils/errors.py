"""Sentinel scheduling errors (reference pkg/util/types.go:28-35), and the
oracle sidecar transport's error classes (``service.client``)."""


class SchedulingError(Exception):
    """Base class for scheduling-control errors."""


class NotMatchedError(SchedulingError):
    """Pod does not participate in batch scheduling (no group label)."""


class WaitingError(SchedulingError):
    """Gang not yet complete; pod must wait at the Permit gate."""


class ResourceNotEnoughError(SchedulingError):
    """Cluster (or node) resources cannot satisfy the request."""


class PodGroupNotFoundError(SchedulingError):
    """Pod references a PodGroup that is not in the status cache."""


class OccupiedError(SchedulingError):
    """PodGroup is fenced to a different owner workload
    (reference pkg/scheduler/core/core.go:504-510)."""


class DeniedError(SchedulingError):
    """PodGroup is in the deny backoff cache (reference core.go:105-110)."""


class StaleBatchError(RuntimeError):
    """A lazy (G,N)-row fetch raced a newer oracle batch: the answer for the
    old batch no longer exists. Callers answer conservatively and let the
    next cycle refresh — the ONLY error class the scorer's row reads may
    swallow (anything else, e.g. a dead sidecar transport, must surface)."""


class OracleTransportError(RuntimeError):
    """The oracle sidecar transport failed (dropped socket, EOF mid-frame,
    desynced/garbage stream, connect failure) and the resilient client's
    retries were exhausted. Distinct from in-band server answers
    (StaleBatchError, RuntimeError) and from deadline overruns
    (OracleDeadlineError): only THIS class advances the circuit breaker."""


class CircuitOpenError(OracleTransportError):
    """The oracle circuit breaker is open: the request was refused without
    touching the transport. Raised until the cooldown elapses and a
    half-open ping probe succeeds (utils.retry.CircuitBreaker)."""


class DeltaResyncRequired(RuntimeError):
    """The sidecar answered DELTA_RESYNC: its device-resident mirror could
    not apply the churned-row delta (no state on this connection, a
    generation gap from a dropped/duplicated frame, or a shape mismatch).
    An in-band answer over a live transport — never retried, never
    advances the breaker; the client reconnects the lane (the stream may
    carry stale replies after a gap) and resends a full keyframe
    (docs/pipelining.md "Device-resident state")."""


class OracleDeadlineError(RuntimeError):
    """The sidecar answered an in-band deadline-exceeded frame: the request
    was received but its ``deadline_ms`` budget elapsed before the batch
    finished (e.g. an unwarmed jit compile). The transport is ALIVE — this
    never trips the breaker and is never retried (a retry would blow the
    same budget again)."""


class OracleBusyError(RuntimeError):
    """The sidecar answered a BUSY frame: its coalescer admission queue is
    saturated (bounded depth, docs/multitenancy.md) — the request was NOT
    executed. Server-side state is normally untouched (the delta path
    checks admission before applying its mirror, so the client's cursor
    stays valid for a plain retry; the rare check/submit race converges
    through the ordinary DELTA_RESYNC -> keyframe recovery). An
    in-band answer over a live transport: never advances the breaker. The
    resilient client sleeps out ``retry_after_ms`` and RETRIES (unlike a
    deadline error, which is never retried) — overload resolves; a blown
    budget does not."""

    def __init__(self, message: str, retry_after_ms: int = 100):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)


class OracleDrainingError(RuntimeError):
    """The sidecar answered a DRAINING frame: it received SIGTERM (or
    ``/debug/drain``) and is finishing its in-flight window before exit
    (docs/resilience.md "High availability") — the request was NOT
    executed and nothing server-side changed. An in-band answer over a
    live transport: NEVER advances the breaker. A pooled client treats it
    as the proactive-failover signal — promote the standby and re-issue
    there (delta cursors re-keyframe via the ordinary DELTA_RESYNC
    machinery); a single-address client surfaces it after the retry
    budget, like exhausted transport retries but with a truthful cause.
    ``failover_hint`` carries the server's standby address list when the
    operator supplied one."""

    def __init__(self, message: str, retry_after_ms: int = 100,
                 failover_hint: str = ""):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)
        self.failover_hint = failover_hint
