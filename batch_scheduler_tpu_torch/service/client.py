"""Oracle sidecar clients.

``OracleClient`` is the raw protocol client (one TCP connection, serialized
round-trips, no recovery). ``ResilientOracleClient`` is the production
transport: same surface, plus automatic reconnect, bounded retries with
exponential backoff + decorrelated jitter (utils.retry.RetryPolicy),
per-request deadline propagation, a circuit breaker that fails fast during
an outage and re-closes through a half-open ping probe, and — with a
multi-address pool — warm-standby failover: promotion on a DRAINING answer
(proactive, never a breaker failure) or on breaker-open (crash), with
delta mirrors re-keyframing on the new primary through the ordinary
DELTA_RESYNC machinery (docs/resilience.md "High availability").
``RemoteScorer`` plugs either into ScheduleOperation with the same
interface as the in-process OracleScorer — the control plane is agnostic to
whether the oracle lives in-process on the local card or behind the sidecar
(the deployment split of the north star: Go plugin <-> sidecar).

The port of ``batch_scheduler_tpu/service/client.py``: the same frames, so
these clients talk to either package's server. ``RemoteScorer`` needs no
device in its own process (the card sits behind the sidecar): it builds no
resident state and opens no stream. With tracing on (utils.trace) a
request sent under a live span carries its context in the TRACE frame;
the sidecar's TRACE_INFO reply brings back its spans, folded into this
process's span ring under the ``oracle-server`` track with the client's
trace id, and its device telemetry (``last_telemetry``). A remote batch's
round trip is the span ``oracle.wire_round_trip`` under ``oracle.batch``.
"""

from __future__ import annotations

import socket
import threading
import time
import weakref
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..core.oracle_scorer import OracleScorer, conservative_cpu_batch
from ..ops.snapshot import ClusterSnapshot
from ..utils.errors import (
    CircuitOpenError,
    DeltaResyncRequired,
    OracleBusyError,
    OracleDeadlineError,
    OracleDrainingError,
    OracleTransportError,
    StaleBatchError,
)
from ..utils.metrics import DEFAULT_REGISTRY, LONG_OP_BUCKETS, Registry
from ..utils.retry import CircuitBreaker, RetryPolicy
from ..utils import audit as audit_mod
from ..utils import trace as trace_mod
from . import protocol as proto

__all__ = [
    "OracleClient",
    "ResilientOracleClient",
    "RemoteScorer",
    "parse_oracle_addresses",
    "active_failover_report",
]


def parse_oracle_addresses(
    spec: str, default_host: str = "127.0.0.1"
) -> List[Tuple[str, int]]:
    """``host:port[,host:port...]`` -> ``[(host, port), ...]`` — the
    ``--oracle-addr`` list form. Each entry may omit the host
    (``:9090`` / ``9090``), which defaults like the single-address CLI
    parse always has. Raises ValueError on an empty or unparsable spec."""
    addresses = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        addresses.append((host or default_host, int(port)))
    if not addresses:
        raise ValueError(f"no oracle addresses in {spec!r}")
    return addresses


def in_band_error(message: str) -> Exception:
    """Classify an in-band ERROR frame's message: stale-batch answers
    (protocol.is_stale_batch_message — including the post-reconnect
    "before any batch" form) map to StaleBatchError, the one class the
    scorer's row reads answer conservatively; everything else is a plain
    server error. Neither is a transport failure."""
    if proto.is_stale_batch_message(message):
        return StaleBatchError(message)
    return RuntimeError(f"oracle server error: {message}")


class OracleClient:
    # default generous enough to sit through a sidecar's first batch (its
    # kernels build at first use) plus the batch itself
    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 120.0,
        connect_timeout: Optional[float] = None,
    ):
        self._timeout = timeout
        # one in-flight round-trip per connection: every frame write/read
        # holds _lock so annotation frames and their response can never
        # interleave with another thread's request on the same stream
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout or timeout
        )  # guarded-by: _lock
        self._sock.settimeout(timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            # analysis: allow(guarded-by) close() is the cancellation path: it must sever the socket while a stuck round-trip still HOLDS _lock
            self._sock.close()
        except OSError:
            pass

    def _round_trip(
        self,
        msg_type: int,
        payload: bytes,
        deadline_ms: Optional[int] = None,
        trace_ctx: Optional[Tuple[str, str]] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Tuple[int, bytes]:
        with self._lock:
            if deadline_ms is not None:
                # bound the wait to ~2x the announced budget: the server
                # answers a DEADLINE_ERROR within the deadline itself, so
                # anything past 2x is a transport stall, not a slow batch
                self._sock.settimeout(
                    min(self._timeout, deadline_ms / 1000.0 * 2.0 + 0.25)
                )
            try:
                if deadline_ms is not None:
                    proto.write_frame(
                        self._sock,
                        proto.MsgType.DEADLINE,
                        proto.pack_deadline(deadline_ms),
                    )
                if trace_ctx is not None:
                    proto.write_frame(
                        self._sock,
                        proto.MsgType.TRACE,
                        proto.pack_trace(*trace_ctx),
                    )
                if audit_id is not None:
                    # audit correlation (utils.audit): the sidecar stamps
                    # its own record of this batch with the client's ID
                    proto.write_frame(
                        self._sock,
                        proto.MsgType.AUDIT_ID,
                        proto.pack_audit_id(audit_id),
                    )
                if policy_fp is not None:
                    # policy skew detection (docs/policy.md "Wire"): the
                    # client's policy fingerprint rides ahead so a
                    # policy-unaware sidecar counts the mismatch
                    proto.write_frame(
                        self._sock,
                        proto.MsgType.POLICY_INFO,
                        proto.pack_policy_info(policy_fp),
                    )
                if tenant:
                    # tenant identity (docs/multitenancy.md): the
                    # sidecar's capacity/scan attribution and the
                    # coalescer's DRF fairness key off this label; None
                    # keeps the wire bytes identical to a pre-tenant
                    # client
                    proto.write_frame(
                        self._sock,
                        proto.MsgType.TENANT,
                        proto.pack_tenant(tenant),
                    )
                proto.write_frame(self._sock, msg_type, payload)
                try:
                    resp_type, resp = proto.read_frame(self._sock)
                    # A traced request's real response is preceded by the
                    # server's TRACE_INFO frame: fold its device telemetry
                    # into the registry, then keep reading for the actual
                    # answer.
                    while resp_type == proto.MsgType.TRACE_INFO:
                        self._absorb_trace_info(resp)
                        resp_type, resp = proto.read_frame(self._sock)
                except ValueError as e:
                    # bad magic / oversized length: the STREAM is broken,
                    # not the request — classify as transport here so a
                    # client-side packing ValueError (a programming error,
                    # raised before any bytes move) stays distinguishable
                    raise OracleTransportError(f"desynced stream: {e}") from e
            finally:
                if deadline_ms is not None:
                    self._sock.settimeout(self._timeout)
        if resp_type == proto.MsgType.DEADLINE_ERROR:
            raise OracleDeadlineError(resp.decode(errors="replace"))
        if resp_type == proto.MsgType.BUSY:
            retry_ms, message = proto.unpack_busy(resp)
            raise OracleBusyError(
                message or "oracle coalescer saturated", retry_ms
            )
        if resp_type == proto.MsgType.DRAINING:
            retry_ms, hint = proto.unpack_draining(resp)
            raise OracleDrainingError(
                "oracle draining"
                + (f" (failover hint: {hint})" if hint else ""),
                retry_ms,
                failover_hint=hint,
            )
        if resp_type == proto.MsgType.ERROR:
            raise in_band_error(resp.decode(errors="replace"))
        return resp_type, resp

    # last TRACE_INFO telemetry absorbed off the wire (oracle device
    # telemetry: compile-cache hit, bucket shape, wave stats, device
    # wall-clock) — kept for callers/tests; metrics fold as it lands
    last_telemetry: Optional[dict] = None

    def _absorb_trace_info(self, payload: bytes) -> None:
        info = proto.unpack_trace_info(payload)
        spans = info.get("spans")
        if isinstance(spans, list):
            trace_mod.record_remote_spans(spans, pid="oracle-server")
        telemetry = info.get("telemetry")
        if isinstance(telemetry, dict):
            self.last_telemetry = telemetry
            device_s = telemetry.get("device_seconds")
            if isinstance(device_s, (int, float)):
                DEFAULT_REGISTRY.histogram(
                    "bst_oracle_device_seconds",
                    "Sidecar-reported device wall-clock per traced batch",
                    buckets=LONG_OP_BUCKETS,
                ).observe(float(device_s))
            if telemetry.get("compiled"):
                DEFAULT_REGISTRY.counter(
                    "bst_oracle_remote_compiles_total",
                    "Traced sidecar batches that built a new executable",
                ).inc()

    def ping(self, deadline_ms: Optional[int] = None) -> bool:
        # a deadline here mostly buys the tightened client-side socket
        # timeout (the server answers pings inline, ignoring the budget):
        # the breaker's half-open probe must stay bounded against a
        # hung-but-accepting sidecar
        resp_type, _ = self._round_trip(
            proto.MsgType.PING, b"", deadline_ms=deadline_ms
        )
        return resp_type == proto.MsgType.PONG

    def schedule(
        self,
        req: proto.ScheduleRequest,
        deadline_ms: Optional[int] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> proto.ScheduleResponse:
        # propagate the live span context over the wire (the TRACE
        # annotation frame); None when tracing is off or no span is open,
        # which keeps the wire bytes identical to a pre-trace client
        trace_ctx = trace_mod.current_context() if trace_mod.enabled() else None
        # last_telemetry is per-request: cleared up front so an untraced
        # (sampled-out) batch can never be attributed the PREVIOUS traced
        # batch's device evidence
        self.last_telemetry = None
        resp_type, resp = self._round_trip(
            proto.MsgType.SCHEDULE_REQ,
            proto.pack_schedule_request(req),
            deadline_ms=deadline_ms,
            trace_ctx=trace_ctx,
            audit_id=audit_id,
            policy_fp=policy_fp,
            tenant=tenant,
        )
        if resp_type != proto.MsgType.SCHEDULE_RESP:
            raise OracleTransportError(
                f"unexpected response type {resp_type} (desynced stream)"
            )
        try:
            return proto.unpack_schedule_response(resp)
        except ValueError as e:  # truncated/garbled payload: stream damage
            raise OracleTransportError(f"undecodable response: {e}") from e

    def delta_schedule(
        self,
        kind: int,
        base_generation: int,
        new_generation: int,
        body,
        deadline_ms: Optional[int] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> proto.ScheduleResponse:
        """One device-resident-state batch (docs/pipelining.md
        "Device-resident state"): ``body`` is a full ScheduleRequest when
        ``kind`` is DELTA_KEYFRAME (installs/refreshes the server's
        per-connection mirror at ``new_generation``) or a
        DeltaScheduleRequest of churned rows on top of
        ``base_generation``. A DELTA_RESYNC answer raises
        DeltaResyncRequired — in-band, never retried: the caller resends
        a keyframe."""
        trace_ctx = trace_mod.current_context() if trace_mod.enabled() else None
        self.last_telemetry = None
        if kind == proto.DELTA_KEYFRAME:
            payload = proto.pack_delta_keyframe(new_generation, body)
        else:
            payload = proto.pack_delta_rows(
                base_generation, new_generation, body
            )
        resp_type, resp = self._round_trip(
            proto.MsgType.DELTA_SCHEDULE_REQ,
            payload,
            deadline_ms=deadline_ms,
            trace_ctx=trace_ctx,
            audit_id=audit_id,
            policy_fp=policy_fp,
            tenant=tenant,
        )
        if resp_type == proto.MsgType.DELTA_RESYNC:
            raise DeltaResyncRequired(proto.unpack_delta_resync(resp))
        if resp_type != proto.MsgType.SCHEDULE_RESP:
            raise OracleTransportError(
                f"unexpected response type {resp_type} (desynced stream)"
            )
        try:
            return proto.unpack_schedule_response(resp)
        except ValueError as e:  # truncated/garbled payload: stream damage
            raise OracleTransportError(f"undecodable response: {e}") from e

    def row(
        self,
        kind: str,
        group_index: int,
        batch_seq: int = 0,
        deadline_ms: Optional[int] = None,
    ) -> np.ndarray:
        resp_type, resp = self._round_trip(
            proto.MsgType.ROW_REQ,
            proto.pack_row_request(kind, group_index, batch_seq),
            deadline_ms=deadline_ms,
        )
        if resp_type != proto.MsgType.ROW_RESP:
            raise OracleTransportError(
                f"unexpected response type {resp_type} (desynced stream)"
            )
        try:
            return np.frombuffer(resp, dtype="<i4")
        except ValueError as e:  # payload not a whole int32 row: desync
            raise OracleTransportError(f"undecodable row: {e}") from e


# what counts as a TRANSPORT failure (retried, advances the breaker):
# socket errors incl. timeouts (OSError covers ConnectionError), EOF, and
# OracleTransportError (which OracleClient raises for frame-level desync:
# bad magic, oversized length, undecodable response). Deliberately NOT
# ValueError: a request-packing ValueError is a client-side programming
# error raised before any bytes move — retrying it against a healthy
# sidecar (and degrading to the CPU fallback) would mask the bug as an
# outage. In-band answers (StaleBatchError, OracleDeadlineError, plain
# RuntimeError) rode a WORKING transport and are excluded by catch order.
_TRANSPORT_ERRORS = (OSError, EOFError, OracleTransportError)

_BREAKER_STATE_VALUES = {"closed": 0, "open": 1, "half-open": 2}

# live multi-address clients, for the /debug/health ``failover`` signal
# (utils.health reads active_failover_report() through a lazy import, the
# same pattern as ops.capacity.active_sampler)
_POOLED_CLIENTS: "weakref.WeakSet" = weakref.WeakSet()


def active_failover_report() -> dict:
    """Pool state of every live multi-address ResilientOracleClient:
    active address, standby freshness (seconds since a standby last
    answered — None until one has), per-backend breaker states, and the
    recent promotion history with reasons. Best-effort and lock-light;
    health snapshots must never block a scheduling cycle."""
    now = time.time()
    mono = time.monotonic()
    clients = []
    for c in list(_POOLED_CLIENTS):
        try:
            with c._pool_lock:
                active = c._active
                promotions = list(c._promotions)
            addrs = [f"{h}:{p}" for h, p in c._addresses]
            last_ok = list(c._backend_last_ok)
            standby_ages = [
                mono - t
                for i, t in enumerate(last_ok)
                if i != active and t > 0.0
            ]
            clients.append({
                "client": c._label,
                "active": active,
                "active_addr": addrs[active],
                "addresses": addrs,
                "standby_freshness_s": (
                    round(min(standby_ages), 3) if standby_ages else None
                ),
                "promotions": [
                    {"ago_s": round(now - ts, 3), "reason": r, "to": to}
                    for ts, r, to in promotions
                ],
                "breakers": {
                    addrs[i]: b.state for i, b in enumerate(c._breakers)
                },
            })
        except Exception:  # noqa: BLE001 — a dying client must not
            continue  # poison the health snapshot
    return {"clients": clients}


class _ClientSlot:
    """One in-flight lane of a windowed ResilientOracleClient: the same
    retry/breaker/deadline policy, its own connection and lock, so a batch
    on one lane never contends with row reads on the batch the other lane
    executed. RemoteScorer pins each
    batch's row fetcher to the slot that ran it (the server keeps batch
    state per connection)."""

    __slots__ = ("_parent", "_idx")

    def __init__(self, parent: "ResilientOracleClient", idx: int):
        self._parent = parent
        self._idx = idx

    def ping(self, deadline_ms: Optional[int] = None) -> bool:
        return self._parent.ping(deadline_ms, _slot=self._idx)

    def schedule(
        self,
        req: proto.ScheduleRequest,
        deadline_ms: Optional[int] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> proto.ScheduleResponse:
        return self._parent.schedule(
            req, deadline_ms, audit_id=audit_id, policy_fp=policy_fp,
            tenant=tenant, _slot=self._idx,
        )

    def delta_schedule(
        self,
        kind: int,
        base_generation: int,
        new_generation: int,
        body,
        deadline_ms: Optional[int] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> proto.ScheduleResponse:
        return self._parent.delta_schedule(
            kind, base_generation, new_generation, body, deadline_ms,
            audit_id=audit_id, policy_fp=policy_fp, tenant=tenant,
            _slot=self._idx,
        )

    def row(
        self,
        kind: str,
        group_index: int,
        batch_seq: int = 0,
        deadline_ms: Optional[int] = None,
    ) -> np.ndarray:
        return self._parent.row(
            kind, group_index, batch_seq, deadline_ms, _slot=self._idx
        )

    def would_attempt(self) -> bool:
        return self._parent.would_attempt()

    @property
    def last_telemetry(self) -> Optional[dict]:
        return self._parent.slot_telemetry(self._idx)

    def close(self) -> None:
        self._parent.close_slot(self._idx)


class ResilientOracleClient:
    """OracleClient with reconnect, retry, deadline, and circuit breaker.

    Same call surface as OracleClient (ping/schedule/row/close), so
    RemoteScorer takes either. The connection is lazy: constructed on
    first use and re-established after any transport failure. Per
    request: the breaker gates admission (open => CircuitOpenError
    without touching the socket; half-open => one ping() probe decides),
    then up to ``retry_policy.max_attempts`` attempts run with
    full-jitter backoff, reconnecting between attempts. Semantic answers
    — StaleBatchError, in-band server errors, OracleDeadlineError — are
    never retried and never advance the breaker.

    ``window`` > 1 provisions that many independent connection SLOTS
    (lazily dialed, shared breaker/retry policy, per-slot locks) exposed
    via ``slot(i)``: a batch runs on one slot while the served batch's row
    reads proceed on another, with each batch pinned to the slot (and so the
    server-side connection) that executed it. The default window of 1 is
    exactly the old single-connection behavior.

    ``host`` may be a comma-separated ADDRESS POOL (``"h1:p1,h2:p2"``,
    the ``--oracle-addr`` list form; ``port`` is then ignored): the first
    address is the primary, the rest warm standbys. Each backend gets its
    OWN breaker (an outage of the primary must not poison the standby's
    admission state); every slot always dials the pool's single ACTIVE
    backend and lazily re-dials after a promotion. Promotion happens on a
    DRAINING answer (proactive — the primary said it will not serve
    again; never a breaker failure) or when the active backend's breaker
    opens (crash). Server-side per-connection state (delta mirrors, batch
    rows) dies with the old connections by design: the standby answers
    DELTA_RESYNC / in-band stale, and the existing keyframe + stale-batch
    discipline re-converges (docs/resilience.md "High availability").

    Observability (registry, default the process registry):
    bst_oracle_retries_total, bst_oracle_transport_failures_total,
    bst_oracle_reconnects_total, bst_oracle_deadline_errors_total,
    bst_oracle_failover_total (counters), bst_oracle_breaker_state
    (gauge; 0=closed 1=open 2=half-open; pooled backends are labelled
    ``label@host:port``) and bst_oracle_active_backend (gauge; pool
    index), labelled by ``client`` (``name`` or the address spec).
    """

    def __init__(
        self,
        host: str,
        port: Optional[int] = None,
        timeout: float = 120.0,
        connect_timeout: float = 5.0,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        deadline_ms: Optional[int] = None,
        name: Optional[str] = None,
        registry: Optional[Registry] = None,
        window: int = 1,
    ):
        if port is None or "," in host or ":" in host:
            # address-spec form ("h1:p1,h2:p2", ":9090", "9090"): the
            # CLI's --oracle-addr string, port arg ignored
            self._addresses = parse_oracle_addresses(host)
        else:
            self._addresses = [(host, int(port))]
        self._active = 0
        self._pool_lock = threading.Lock()
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        self.retry_policy = retry_policy or RetryPolicy()
        self.deadline_ms = self._check_deadline(deadline_ms)
        self.window = max(1, int(window))
        self._slot_clients: list = [None] * self.window
        self._slot_connected: list = [False] * self.window
        self._slot_addr = [0] * self.window
        self._slot_locks = [threading.RLock() for _ in range(self.window)]
        reg = registry or DEFAULT_REGISTRY
        addr_labels = [f"{h}:{p}" for h, p in self._addresses]
        pooled = len(self._addresses) > 1
        self._label = name or ",".join(addr_labels)
        # single-address clients keep the historical one-gauge-per-client
        # label; pooled backends each get label@host:port so the breaker
        # gauge stays truthful per backend
        self._backend_labels = (
            [f"{self._label}@{a}" for a in addr_labels]
            if pooled
            else [self._label]
        )
        self._retries = reg.counter(
            "bst_oracle_retries_total",
            "Oracle requests retried after a transport failure",
        )
        self._failures = reg.counter(
            "bst_oracle_transport_failures_total",
            "Oracle transport failures (per attempt, pre-retry)",
        )
        self._reconnects = reg.counter(
            "bst_oracle_reconnects_total",
            "Oracle connections re-established after a transport failure",
        )
        self._deadline_errors = reg.counter(
            "bst_oracle_deadline_errors_total",
            "Oracle requests answered with an in-band deadline error",
        )
        self._busy_answers = reg.counter(
            "bst_oracle_busy_total",
            "Oracle requests answered BUSY (coalescer admission queue "
            "saturated) — retried after the server's retry-after hint, "
            "never a breaker failure",
        )
        self._breaker_gauge = reg.gauge(
            "bst_oracle_breaker_state",
            "Oracle circuit breaker state (0=closed 1=open 2=half-open)",
        )
        self._failovers = reg.counter(
            "bst_oracle_failover_total",
            "Pooled-client standby promotions by reason (drain = "
            "proactive on a DRAINING answer; crash = the active "
            "backend's breaker opened)",
        )
        self._active_gauge = reg.gauge(
            "bst_oracle_active_backend",
            "Index into the client's oracle address pool it is currently "
            "serving from (0 = first configured address)",
        )
        first = breaker or CircuitBreaker()
        self._breakers = [first]
        for _ in self._addresses[1:]:
            # standbys clone the caller's breaker CONFIG (threshold,
            # cooldown, clock) but never its state: each backend earns
            # its open/closed verdict from its own transport evidence
            self._breakers.append(
                CircuitBreaker(
                    failure_threshold=first.failure_threshold,
                    reset_timeout=first.reset_timeout,
                    clock=first._clock,
                )
            )
        for i, b in enumerate(self._breakers):
            b.on_transition = (
                lambda st, _i=i: self._record_breaker_state(st, _i)
            )
            self._record_breaker_state(b.state, i)
        self._backend_last_ok = [0.0] * len(self._addresses)
        self._promotions: deque = deque(maxlen=64)  # (wall_ts, reason, to)
        self._active_gauge.set(0, client=self._label)
        if pooled:
            _POOLED_CLIENTS.add(self)

    @property
    def breaker(self) -> CircuitBreaker:
        """The ACTIVE backend's breaker (the only one for a
        single-address client — the historical attribute, unchanged)."""
        return self._breakers[self._active]

    @property
    def active_address(self) -> Tuple[str, int]:
        """(host, port) of the pool backend currently being served from."""
        return self._addresses[self._active]

    @staticmethod
    def _check_deadline(deadline_ms: Optional[int]) -> Optional[int]:
        """Validate a deadline at CONFIG time. Left to pack_deadline, an
        invalid value would raise ValueError inside the request path,
        where it is indistinguishable from a desynced-stream transport
        failure — retried, reconnected, breaker-tripped, and (with the
        local-cpu fallback) silently degrading against a healthy sidecar."""
        if deadline_ms is not None and not 0 < deadline_ms <= 0xFFFFFFFF:
            raise ValueError(
                f"deadline_ms must be in 1..{0xFFFFFFFF}, got {deadline_ms}"
            )
        return deadline_ms

    def _record_breaker_state(self, state: str, idx: int = 0) -> None:
        self._breaker_gauge.set(
            _BREAKER_STATE_VALUES.get(state, -1),
            client=self._backend_labels[idx],
        )

    def would_attempt(self) -> bool:
        """True when the next call would actually touch the transport
        (breaker closed/half-open/cooldown elapsed) — the scorer's cue
        that a degraded batch is worth re-probing."""
        return self.breaker.would_attempt()

    def slot(self, idx: int) -> _ClientSlot:
        """A view pinned to connection slot ``idx`` (< window) — see the
        class docstring's in-flight-window contract."""
        if not 0 <= idx < self.window:
            raise IndexError(f"slot {idx} out of window {self.window}")
        return _ClientSlot(self, idx)

    def slot_telemetry(self, slot: int) -> Optional[dict]:
        c = self._slot_clients[slot]
        return c.last_telemetry if c is not None else None

    @property
    def last_telemetry(self) -> Optional[dict]:
        """The underlying connection's last absorbed TRACE_INFO telemetry
        (None before any traced batch or while disconnected)."""
        return self.slot_telemetry(0)

    def close(self) -> None:
        for idx in range(self.window):
            self.close_slot(idx)

    def close_slot(self, idx: int) -> None:
        with self._slot_locks[idx]:
            self._drop(idx)

    def _ensure(self, slot: int = 0) -> OracleClient:
        active = self._active
        if (
            self._slot_clients[slot] is not None
            and self._slot_addr[slot] != active
        ):
            # a promotion happened since this slot dialed: the old
            # connection points at a draining/dead backend — re-dial
            # lazily (each slot under its own lock, so promotion never
            # needs to touch another slot's connection)
            self._drop(slot)
        if self._slot_clients[slot] is None:
            host, port = self._addresses[active]
            self._slot_clients[slot] = OracleClient(
                host,
                port,
                timeout=self._timeout,
                connect_timeout=self._connect_timeout,
            )
            self._slot_addr[slot] = active
            if self._slot_connected[slot]:
                self._reconnects.inc(client=self._label)
            self._slot_connected[slot] = True
        return self._slot_clients[slot]

    def _drop(self, slot: int = 0) -> None:
        if self._slot_clients[slot] is not None:
            self._slot_clients[slot].close()
            self._slot_clients[slot] = None

    def _note_ok(self) -> None:
        """Active backend answered over a working transport: close/keep
        its breaker closed and stamp its freshness (the /debug/health
        ``failover`` signal's standby-staleness input)."""
        self.breaker.record_success()
        self._backend_last_ok[self._active] = time.monotonic()

    def _promote(self, reason: str, require_healthy: bool = False) -> bool:
        """Advance the pool to the next standby, preferring one whose
        breaker would admit. Connections re-dial lazily per slot
        (``_ensure`` compares ``_slot_addr`` to the active index), so
        promotion never blocks on another slot's in-flight request;
        server-side delta mirrors die with the old connections and the
        standby forces a keyframe via the ordinary DELTA_RESYNC answer.
        ``require_healthy`` (the admission-refused path) declines to
        promote when every standby's breaker is also open — flapping
        round-robin through a fleet-wide outage would only falsify the
        failover counter. Returns False on a single-address pool."""
        if len(self._addresses) < 2:
            return False
        with self._pool_lock:
            old = self._active
            order = [
                (old + k) % len(self._addresses)
                for k in range(1, len(self._addresses))
            ]
            nxt = next(
                (i for i in order if self._breakers[i].would_attempt()),
                None,
            )
            if nxt is None:
                if require_healthy:
                    return False
                nxt = order[0]
            self._active = nxt
            self._promotions.append((time.time(), reason, nxt))
        self._failovers.inc(reason=reason, client=self._label)
        self._active_gauge.set(nxt, client=self._label)
        return True

    def _admit(self, slot: int = 0) -> None:
        decision = self.breaker.admit()
        if decision == "refuse" and self._promote(
            "crash", require_healthy=True
        ):
            # the active backend is in cooldown but a standby would
            # admit: serve from the standby instead of failing fast
            decision = self.breaker.admit()
        if decision == "refuse":
            raise CircuitOpenError(
                f"oracle circuit open ({self._label}); "
                f"retrying after {self.breaker.reset_timeout}s cooldown"
            )
        if decision == "probe":
            # the probe must stay BOUNDED against a hung-but-accepting
            # sidecar: without a deadline it would wait the full base
            # socket timeout (default 120s) inside a scheduling cycle on
            # every cooldown expiry — the exact stall the breaker exists
            # to prevent. Use the configured deadline, else the connect
            # timeout as the probe budget.
            probe_ms = (
                self.deadline_ms
                if self.deadline_ms is not None
                else max(int(self._connect_timeout * 1000), 100)
            )
            try:
                ok = self._ensure(slot).ping(deadline_ms=probe_ms)
            except Exception:  # noqa: BLE001 — any probe failure re-opens
                ok = False
            if not ok:
                self._drop(slot)
                self.breaker.record_failure()
                raise CircuitOpenError(
                    f"oracle half-open probe failed ({self._label})"
                )
            self._note_ok()

    def _call(self, op: str, fn, slot: int = 0):
        with self._slot_locks[slot]:
            self._admit(slot)
            last: Optional[BaseException] = None
            slept_busy_hint = False
            prev_delay: Optional[float] = None
            for attempt in range(self.retry_policy.max_attempts):
                if attempt and not slept_busy_hint:
                    self._retries.inc(op=op, client=self._label)
                    # decorrelated jitter: each delay seeds the next
                    # draw's range, so clients that crashed in sync
                    # drift apart instead of stampeding the standby
                    prev_delay = self.retry_policy.backoff(
                        attempt - 1, prev=prev_delay
                    )
                    time.sleep(prev_delay)
                slept_busy_hint = False
                try:
                    result = fn(self._ensure(slot))
                except (StaleBatchError, OracleDeadlineError) as e:
                    # semantic answers over a live transport: never
                    # retried (stale stays stale; a deadline retry blows
                    # the same budget), never advance the breaker
                    if isinstance(e, OracleDeadlineError):
                        self._deadline_errors.inc(client=self._label)
                    self._note_ok()
                    raise
                except OracleDrainingError as e:
                    # graceful-shutdown answer over a live transport —
                    # never a breaker failure. With a standby configured
                    # this is the PROACTIVE failover signal: promote and
                    # re-issue immediately (no backoff — the primary just
                    # told us it will never serve this request).
                    # Single-address clients wait out the hint like BUSY
                    # and surface the DrainingError when attempts run out.
                    self._note_ok()
                    last = e
                    if self._promote("drain"):
                        slept_busy_hint = True  # promotion IS the wait
                        continue
                    if attempt + 1 >= self.retry_policy.max_attempts:
                        raise
                    time.sleep(min(max(e.retry_after_ms, 1) / 1000.0, 5.0))
                    slept_busy_hint = True
                except OracleBusyError as e:
                    # the sidecar is alive and telling us exactly when to
                    # come back: wait out its hint (capped) and burn one
                    # retry attempt — overload resolves, so unlike a
                    # deadline this IS retried; unlike a transport
                    # failure it never advances the breaker or drops the
                    # connection. Exhausted attempts surface the
                    # BusyError itself (the scorer's fallback decides),
                    # not a transport wrapper.
                    self._note_ok()
                    self._busy_answers.inc(op=op, client=self._label)
                    if attempt + 1 >= self.retry_policy.max_attempts:
                        raise
                    time.sleep(min(max(e.retry_after_ms, 1) / 1000.0, 5.0))
                    # the hint IS the wait: skip the generic transport
                    # backoff (and its retries counter — this was an
                    # answered request, not a transport failure) so the
                    # retry lands when the server said a slot frees up
                    slept_busy_hint = True
                    last = e
                except _TRANSPORT_ERRORS as e:
                    self._failures.inc(op=op, client=self._label)
                    self._drop(slot)
                    self.breaker.record_failure()
                    last = e
                    if not self.breaker.would_attempt():
                        # breaker opened mid-loop. With a standby this is
                        # the CRASH promotion trigger: point the
                        # remaining attempts at it (backoff still
                        # applies — the dial is real work). Without one,
                        # stop burning attempts.
                        if not self._promote("crash"):
                            break
                except RuntimeError:
                    # in-band server error (bad request, row out of
                    # range): the transport answered — surface as-is
                    self._note_ok()
                    raise
                else:
                    self._note_ok()
                    return result
            raise OracleTransportError(
                f"oracle {op} via {self._label} failed after "
                f"{self.retry_policy.max_attempts} attempts: {last}"
            ) from last

    def ping(self, deadline_ms: Optional[int] = None, _slot: int = 0) -> bool:
        d = (
            self.deadline_ms
            if deadline_ms is None
            else self._check_deadline(deadline_ms)
        )
        return self._call("ping", lambda c: c.ping(deadline_ms=d), slot=_slot)

    def schedule(
        self,
        req: proto.ScheduleRequest,
        deadline_ms: Optional[int] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
        _slot: int = 0,
    ) -> proto.ScheduleResponse:
        d = (
            self.deadline_ms
            if deadline_ms is None
            else self._check_deadline(deadline_ms)
        )
        return self._call(
            "schedule",
            lambda c: c.schedule(
                req, deadline_ms=d, audit_id=audit_id, policy_fp=policy_fp,
                tenant=tenant,
            ),
            slot=_slot,
        )

    def delta_schedule(
        self,
        kind: int,
        base_generation: int,
        new_generation: int,
        body,
        deadline_ms: Optional[int] = None,
        audit_id: Optional[str] = None,
        policy_fp: Optional[str] = None,
        tenant: Optional[str] = None,
        _slot: int = 0,
    ) -> proto.ScheduleResponse:
        d = (
            self.deadline_ms
            if deadline_ms is None
            else self._check_deadline(deadline_ms)
        )
        return self._call(
            "delta_schedule",
            lambda c: c.delta_schedule(
                kind, base_generation, new_generation, body, deadline_ms=d,
                audit_id=audit_id, policy_fp=policy_fp, tenant=tenant,
            ),
            slot=_slot,
        )

    def row(
        self,
        kind: str,
        group_index: int,
        batch_seq: int = 0,
        deadline_ms: Optional[int] = None,
        _slot: int = 0,
    ) -> np.ndarray:
        d = (
            self.deadline_ms
            if deadline_ms is None
            else self._check_deadline(deadline_ms)
        )
        return self._call(
            "row",
            lambda c: c.row(kind, group_index, batch_seq, deadline_ms=d),
            slot=_slot,
        )


class _DeltaCursor:
    """Per-connection-lane wire-delta state (docs/pipelining.md
    "Device-resident state"): which generation the server's mirror on THIS
    lane holds, and the union of churned rows packed since — batches
    alternate lanes, so each lane's delta spans every pack since that lane
    last synced. Touched only under the scorer's refresh lock (_note_pack
    and _execute both run inside it)."""

    __slots__ = ("server_gen", "synced", "pending_nodes", "pending_groups",
                 "need_keyframe")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """Forget the server's state (reconnect, resync, fallback, any
        error whose server-side effect is unknown): the next batch on this
        lane is a keyframe."""
        self.server_gen = 0
        self.synced = False
        self.need_keyframe = True
        self.pending_nodes: set = set()
        self.pending_groups: set = set()

    def note(self, delta) -> None:
        """Fold one pack's SnapshotDelta in. A keyframe-kind record (full
        repack / node-list / group-set change) invalidates positional row
        indices — this lane must resync from a keyframe. Event-fold packs
        (``delta.source == "events"``, ops.snapshot.pack_fold) carry kind
        "delta" with the same unpadded-space row indices as scan deltas —
        positional stability is a precondition of the fold itself — so
        they accumulate here unchanged, and the DELTA_ROWS frame's
        wholesale order/fit columns keep the server's mirror exact even
        when the host resorted the queue between syncs."""
        if delta is None or delta.kind != "delta":
            self.need_keyframe = True
            self.pending_nodes.clear()
            self.pending_groups.clear()
            return
        if self.synced and not self.need_keyframe:
            self.pending_nodes.update(delta.node_rows.tolist())
            self.pending_groups.update(delta.group_rows.tolist())

    def mark_synced(self, generation: int) -> None:
        self.server_gen = generation
        self.synced = True
        self.need_keyframe = False
        self.pending_nodes.clear()
        self.pending_groups.clear()


class RemoteScorer(OracleScorer):
    """OracleScorer whose batch executes on the sidecar service.

    A windowed ResilientOracleClient (``window`` >= 2) gives the scorer two
    lanes: batches alternate between the client's connection slots, and
    each batch's row fetcher is pinned to the slot that executed it (the
    server keeps batch state per connection) and to that batch's sequence
    number, so a row read can never be served from another batch.

    ``fallback`` decides what a batch does when the sidecar transport is
    down (retries exhausted or breaker open) or over deadline:

    - ``"deny"`` (default): the error surfaces into the scheduling cycle
      (the cycle requeues the pod with backoff — visible failure).
    - ``"local-cpu"``: serve a CONSERVATIVE host-side batch instead
      (core.oracle_scorer.conservative_cpu_batch): real per-node member
      capacities and exact independent-feasibility, but no placements and
      no plans — so nothing is admitted speculatively, and PreFilter
      denies only provably-infeasible gangs (docs/resilience.md). The
      scorer marks itself ``degraded`` and counts every such batch in
      ``bst_oracle_fallback_batches_total``; with a ResilientOracleClient
      it re-probes automatically once the breaker cooldown elapses. This
      is the reference's documented degraded mode, taken only when the
      sidecar cannot answer: a batch the sidecar answers is never
      replaced."""

    FALLBACK_MODES = ("deny", "local-cpu")

    # 16-hex policy-config fingerprint announced on every schedule request
    # when the embedding operation runs a policy engine (the sidecar
    # executes base batches; skew is counted server-side, never silent).
    # Stamped by ScheduleOperation; None keeps the wire pre-policy.
    policy_fingerprint = None

    def __init__(
        self,
        client: OracleClient,
        fallback: str = "deny",
        tenant: Optional[str] = None,
    ):
        # no local device: the card lives behind the sidecar, which keeps
        # the resident mirror fed by the wire deltas below
        super().__init__(device=None)
        if fallback not in self.FALLBACK_MODES:
            raise ValueError(
                f"unknown fallback {fallback!r} (use one of {self.FALLBACK_MODES})"
            )
        if getattr(client, "window", 1) > 1:
            # a windowed ResilientOracleClient provides the second lane:
            # slot views alternate, each batch pinned to the slot (server
            # connection) that executed it
            self._clients = [client.slot(0), client.slot(1)]
        else:
            self._clients = [client]
        self._next = 0
        self.fallback = fallback
        # background refresh and dispatch-ahead need the second lane: on
        # one connection the off-cycle batch's round trip would hold the
        # connection the cycle's row reads need
        self.supports_background_refresh = len(self._clients) > 1
        self.supports_dispatch_ahead = len(self._clients) > 1
        # wire tenant identity (docs/multitenancy.md): an explicit label
        # (multi-client sims, fleet deployments with a configured tenant)
        # wins; otherwise each batch announces its snapshot's dominant
        # namespace (OracleScorer.dominant_tenant) — cardinality-capped,
        # so the sidecar's label set stays bounded. None/"" keeps the
        # wire bytes identical to a pre-tenant client.
        self.tenant = tenant
        self._fallback_batches = DEFAULT_REGISTRY.counter(
            "bst_oracle_fallback_batches_total",
            "Oracle batches served by the conservative local-CPU fallback",
        )
        self._degraded_gauge = DEFAULT_REGISTRY.gauge(
            "bst_oracle_degraded",
            "1 while the remote scorer serves the conservative CPU fallback",
        )
        # Wire deltas (docs/pipelining.md "Device-resident state"): ship
        # only churned rows + generation; the sidecar keeps the
        # device-resident mirror per connection. Gated to resilient
        # transports (``would_attempt`` — resync recovery closes the lane
        # and must be able to re-dial; a plain OracleClient keeps full
        # snapshots). Disproven once against an old peer (in-band "unknown
        # message type"), the scorer falls back to full snapshots
        # permanently — bit-identical either way.
        self._cursors = [_DeltaCursor() for _ in self._clients]
        self._wire_delta_ok = all(
            hasattr(c, "delta_schedule") and hasattr(c, "would_attempt")
            for c in self._clients
        )
        # TENANT annotation gate: disproven ONCE against an old peer
        # (in-band "unknown message type 16"), the process stops
        # announcing tenants permanently — same mixed-fleet discipline
        # as the wire-delta fallback, plans unaffected either way.
        # Resilient lanes only (the wire-delta gating): recovering from
        # an old peer's error answer requires dropping the lane (the real
        # response is still in the stream behind it) and re-dialing — a
        # plain OracleClient never reconnects, so on one the recovery
        # would permanently kill the transport. A plain-client
        # deployment just keeps its pre-tenant attribution.
        self._wire_tenant_ok = all(
            hasattr(c, "would_attempt") for c in self._clients
        )
        self._wire_delta_counter = DEFAULT_REGISTRY.counter(
            "bst_oracle_wire_delta_batches_total",
            "Remote batches by wire encoding: churned-row delta, full "
            "keyframe (mirror install/resync), or plain full snapshot "
            "(delta path off or peer without it)",
        )
        self._wire_resyncs = DEFAULT_REGISTRY.counter(
            "bst_oracle_wire_delta_resyncs_total",
            "DELTA_RESYNC answers received (sidecar mirror refused a "
            "delta: generation gap / reconnect) — each forces a keyframe",
        )

    def close(self) -> None:
        for c in self._clients:
            c.close()

    def _probe_due(self) -> bool:
        """While degraded, a batch is worth re-attempting only when the
        next transport call would actually go out (breaker cooldown
        elapsed). A plain OracleClient has no breaker: always re-attempt."""
        client = self._clients[self._next]
        would = getattr(client, "would_attempt", None)
        return True if would is None else would()

    def _set_degraded(self, flag: bool) -> None:
        if flag:
            self._fallback_batches.inc()
        self.degraded = flag
        self._degraded_gauge.set(1 if flag else 0)

    def _note_pack(self, snap) -> None:  # lock-held: _refresh_lock
        """Feed each lane's wire-delta cursor with this pack's churned-row
        record (the local device-state sync the base class does here is
        the sidecar's job on this path)."""
        delta = getattr(snap, "delta", None)
        for cursor in self._cursors:
            cursor.note(delta)

    def _build_delta(self, snap, cursor) -> proto.DeltaScheduleRequest:
        """The churned rows this lane's mirror is missing, read from the
        snapshot's padded arrays (indices are unpadded-space, a prefix of
        padded space — same row values; the server scatters them into its
        padded mirror at the same indices)."""
        node_idx = np.asarray(sorted(cursor.pending_nodes), dtype=np.int32)
        group_idx = np.asarray(sorted(cursor.pending_groups), dtype=np.int32)
        return proto.DeltaScheduleRequest(
            node_idx=node_idx,
            node_rows=np.asarray(snap.requested)[node_idx],
            group_idx=group_idx,
            group_rows=np.asarray(snap.group_req)[group_idx],
            remaining=snap.remaining,
            fit_mask=snap.fit_mask,
            group_valid=snap.group_valid,
            order=snap.order,
            min_member=snap.min_member,
            scheduled=snap.scheduled,
            matched=snap.matched,
            ineligible=snap.ineligible,
            creation_rank=snap.creation_rank,
            n=int(snap.alloc.shape[0]),
            g=int(snap.group_req.shape[0]),
            r=int(snap.alloc.shape[1]),
        )

    def _drop_lane(self, client, cursor) -> None:
        """Close a lane whose stream may carry stale replies (a resync
        after a generation gap) so the next call re-dials clean, and
        forget the server state that died with it."""
        try:
            client.close()
        except Exception:  # noqa: BLE001 — already tearing the lane down
            pass
        cursor.reset()

    def _wire_schedule(self, client, cursor, snap, req, audit_id, policy_fp,
                       tenant=None):
        """One remote batch, delta-encoded when this lane's mirror can
        take it: churned rows + generation (DELTA_ROWS), a full keyframe
        when the mirror needs (re)installing, or a plain full snapshot
        when the delta path is off / the peer predates it. Every encoding
        yields the same executed batch server-side — bit-identity is the
        bench-delta gate's claim, not an optimisation hope."""
        delta = getattr(snap, "delta", None)
        if not self._wire_delta_ok or delta is None:
            self._wire_delta_counter.inc(kind="full")
            return client.schedule(
                req, audit_id=audit_id, policy_fp=policy_fp, tenant=tenant
            )
        gen = delta.generation
        if cursor.synced and not cursor.need_keyframe:
            n, g = int(snap.alloc.shape[0]), int(snap.group_req.shape[0])
            # a delta wider than half the state costs more than a
            # keyframe (rows + indices vs rows): send the keyframe
            if (
                len(cursor.pending_nodes) <= max(n // 2, 1)
                and len(cursor.pending_groups) <= max(g // 2, 1)
            ):
                try:
                    resp = client.delta_schedule(
                        proto.DELTA_ROWS, cursor.server_gen, gen,
                        self._build_delta(snap, cursor),
                        audit_id=audit_id, policy_fp=policy_fp,
                        tenant=tenant,
                    )
                    cursor.mark_synced(gen)
                    self._wire_delta_counter.inc(kind="delta")
                    return resp
                except DeltaResyncRequired:
                    # the mirror refused (generation gap — dropped or
                    # duplicated frame, or a reconnect emptied it). The
                    # stream beyond a gap may carry stale replies: drop
                    # the lane, then resync from a keyframe below.
                    self._wire_resyncs.inc()
                    self._drop_lane(client, cursor)
                except RuntimeError as e:
                    if "unknown message type" not in str(e) or (
                        "message type 16" in str(e)
                    ):
                        # type 16 is the TENANT annotation, written
                        # BEFORE the delta frame: _execute owns that
                        # fallback (stop announcing tenants), not this
                        # knob
                        raise
                    # old peer: no MsgType 14 — full snapshots, forever
                    self._wire_delta_ok = False
                    self._wire_delta_counter.inc(kind="full")
                    return client.schedule(
                        req, audit_id=audit_id, policy_fp=policy_fp,
                        tenant=tenant,
                    )
        try:
            resp = client.delta_schedule(
                proto.DELTA_KEYFRAME, 0, gen, req,
                audit_id=audit_id, policy_fp=policy_fp, tenant=tenant,
            )
            cursor.mark_synced(gen)
            self._wire_delta_counter.inc(kind="keyframe")
            return resp
        except DeltaResyncRequired:
            # a keyframe is unconditionally applicable; an answer here
            # means the stream itself is desynced — re-dial and fall
            # back to the plain full snapshot for this batch
            self._wire_resyncs.inc()
            self._drop_lane(client, cursor)
            self._wire_delta_counter.inc(kind="full")
            return client.schedule(
                req, audit_id=audit_id, policy_fp=policy_fp, tenant=tenant
            )
        except RuntimeError as e:
            if "unknown message type" not in str(e) or (
                "message type 16" in str(e)
            ):
                raise  # type 16 = TENANT annotation: _execute's fallback
            self._wire_delta_ok = False
            self._wire_delta_counter.inc(kind="full")
            return client.schedule(
                req, audit_id=audit_id, policy_fp=policy_fp, tenant=tenant
            )

    def _dispatch_ahead(self, snap: ClusterSnapshot):
        """The speculative batch runs on the sidecar like any other (the
        round trip happens here, on the dispatch-ahead thread)."""
        result = self._execute(snap)
        return lambda: result

    def _execute(self, snap: ClusterSnapshot):
        # fit_mask may be the [1,N] broadcast fast path; the wire carries
        # it as ONE row (protocol mask_rows header — at 5k nodes the
        # expanded [G,N] form was 96% of the request bytes).
        req = proto.ScheduleRequest(
            alloc=snap.alloc,
            requested=snap.requested,
            group_req=snap.group_req,
            remaining=snap.remaining,
            fit_mask=snap.fit_mask,
            group_valid=snap.group_valid,
            order=snap.order,
            min_member=snap.min_member,
            scheduled=snap.scheduled,
            matched=snap.matched,
            ineligible=snap.ineligible,
            creation_rank=snap.creation_rank,
        )
        # _execute calls are serialized by the scorer's _refresh_lock;
        # alternating here means the next batch runs on the connection the
        # CURRENT batch's rows are not being read from
        slot = self._next
        client = self._clients[slot]
        cursor = self._cursors[slot]
        self._next = (self._next + 1) % len(self._clients)
        # audit correlation: when this scorer records audit evidence, the
        # batch's ID is minted HERE (before the round-trip) and sent as the
        # AUDIT_ID annotation so the sidecar's own record of this batch
        # carries the same ID; refresh consumes the marker for the
        # client-side record (same ride-along contract as _degraded)
        audit_id = None
        if self.audit_log is not None:
            audit_id = audit_mod.new_audit_id()
        # policy skew annotation (docs/policy.md "Wire"): the sidecar runs
        # base (policy-unaware) batches, so a client with an active policy
        # engine announces its config fingerprint and the server counts
        # the mismatch — never a silent divergence. None when no policy is
        # live, which keeps the wire bytes identical to a pre-policy client.
        policy_fp = getattr(self, "policy_fingerprint", None)
        # tenant identity at the client edge (docs/multitenancy.md): an
        # explicit configured label wins; else the snapshot's dominant
        # namespace, through the cardinality-capped registry — the same
        # label the local scan counter uses (OracleScorer._execute)
        tenant = None
        if self._wire_tenant_ok:
            tenant = self.tenant or self.dominant_tenant(snap) or None
        try:
            with trace_mod.span("oracle.wire_round_trip", cat="oracle"):
                try:
                    resp = self._wire_schedule(
                        client, cursor, snap, req, audit_id, policy_fp,
                        tenant=tenant,
                    )
                except RuntimeError as e:
                    if not (tenant and "unknown message type 16" in str(e)):
                        raise
                    # old peer: no TENANT frame. The stream still holds the
                    # un-consumed real response behind the in-band error,
                    # so drop the lane and resend plain — and never
                    # announce again (DEADLINE ship-together rule, degraded
                    # gracefully).
                    self._wire_tenant_ok = False
                    self._drop_lane(client, cursor)
                    resp = self._wire_schedule(
                        client, cursor, snap, req, audit_id, policy_fp
                    )
        except _TRANSPORT_ERRORS + (
            OracleDeadlineError, OracleBusyError, OracleDrainingError,
        ) as e:
            # whether the server applied anything is unknown (a deadline
            # may abandon a half-applied delta): forget this lane's
            # mirror state so the next batch on it keyframes. A BUSY
            # answer is the exception — admission was refused before any
            # mirror mutation, so the cursor stays valid. A DRAINING
            # answer surfacing here means a single-address client rode
            # out the whole retry budget against a draining sidecar: the
            # connection dies with the server, so the cursor resets too.
            if not isinstance(e, OracleBusyError):
                cursor.reset()
            # raw OSError/EOFError included, not just the resilient
            # client's wrapped OracleTransportError: a plain OracleClient
            # is a supported transport here, and its bare socket errors
            # must reach the same fallback
            if self.fallback != "local-cpu":
                raise
            # conservative degradation: safe progress over exact answers.
            # CircuitOpenError lands here too, so during an outage this
            # path costs one host-side numpy pass, no connect timeout.
            # The degraded FLAG flips only when this batch is PUBLISHED
            # (refresh consumes the marker).
            host, fetcher = conservative_cpu_batch(snap)
            host["_degraded"] = True
            return host, fetcher
        host = {
            "_degraded": False,
            "gang_feasible": resp.gang_feasible,
            "placed": resp.placed,
            "assignment_nodes": resp.assignment_nodes,
            "assignment_counts": resp.assignment_counts,
            "best": resp.best,
            "best_exists": resp.best_exists,
            "progress": resp.progress,
        }
        # traced batches carry the sidecar's device telemetry back in the
        # TRACE_INFO frame; surface it like the in-process path does
        telemetry = getattr(client, "last_telemetry", None)
        if telemetry:
            host["telemetry"] = telemetry
        if audit_id is not None:
            host["_audit_id"] = audit_id
        batch_seq = resp.batch_seq

        def row_fetcher(kind: str, g: int) -> np.ndarray:
            # the captured batch_seq pins this fetcher to ITS batch ON ITS
            # connection: if a newer batch has run there, the server answers
            # an in-band stale-batch error instead of another batch's row
            return client.row(kind, g, batch_seq)

        return host, row_fetcher
