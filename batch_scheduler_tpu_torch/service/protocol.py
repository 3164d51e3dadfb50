"""Wire protocol for the oracle sidecar: framed packed arrays.

The port's own copy of ``batch_scheduler_tpu/service/protocol.py``, byte
for byte the same frames (``tests/test_torch_protocol.py`` holds every
packer against the reference's), so either package's client talks to
either package's server. The data plane carries packed pod/node resource
vectors from the control plane to the sidecar that owns the accelerator
(BASELINE.json north_star; SURVEY.md §7 notes "packed arrays, not
protobuf-per-pod" is required for the <1s budget). The protocol is
deliberately dumb and fast:

    frame  := magic "BSO2" | u32 msg_type | u64 payload_len | payload
    arrays := raw little-endian buffers in fixed order, counts up front

No per-pod messages, no schema negotiation, no string tables in the hot
path — names stay host-side in the caller's index maps. A C++ client
(native/) speaks the same bytes.

Message types:
  SCHEDULE_REQ  : one full oracle batch (counts + 7 arrays)
  SCHEDULE_RESP : O(G) vectors + compact top-K assignment
  ROW_REQ       : fetch one (G,N) row ("capacity" or "scores") from the
                  connection's last batch
  ROW_RESP      : the row, int32[N]
  PING/PONG     : liveness
  ERROR         : UTF-8 message
  DEADLINE      : u32 budget in ms, annotating the NEXT request on this
                  connection (no reply); the server answers that request
                  with DEADLINE_ERROR if its budget elapses first. A
                  separate annotation frame instead of a request-header
                  field so every existing layout (and the native C++
                  client, which never sends deadlines) stays bit-for-bit
                  unchanged. Ship client and server together: a pre-BSO2.1
                  server answers DEADLINE with an ERROR frame and desyncs.
  DEADLINE_ERROR: UTF-8 message — the annotated request's budget elapsed
                  server-side (the batch keeps running; its result is
                  dropped). Deliberately distinct from ERROR so clients
                  can tell "sidecar alive but slow" from a real failure.
  TRACE         : 16-hex trace ID + 8-hex parent span ID, annotating the
                  NEXT request on this connection (no reply; same
                  annotation-frame pattern as DEADLINE, so every
                  existing request/response layout — and the native C++
                  client, which never traces — stays bit-for-bit
                  unchanged). The server times the annotated request's
                  phases and answers a TRACE_INFO frame BEFORE the
                  normal response.
  AUDIT_ID      : 16-hex audit record ID, annotating the NEXT request on
                  this connection (no reply; the same annotation-frame
                  pattern as DEADLINE/TRACE, so every existing
                  request/response layout — and the native C++ client,
                  which never audits — stays bit-for-bit unchanged). The
                  server's own batch audit record (utils.audit) is
                  stamped with the client's ID, so the sidecar-side and
                  client-side records of one batch correlate into a
                  single evidence chain with the stitched trace spans
                  and flight-recorder decisions (docs/observability.md).
                  Sent only by auditing clients; a pre-audit server
                  answers it with an ERROR frame and desyncs — ship
                  client and server together, as with DEADLINE/TRACE.
  TRACE_INFO    : JSON {trace_id, spans: [...], telemetry: {...}} — the
                  server-side spans (stamped with the client's trace ID,
                  so both sides stitch into one Chrome-trace timeline)
                  plus per-batch oracle device telemetry: compile-cache
                  hit/miss, bucket shape, wave count/demotions, device
                  wall-clock (docs/observability.md). Sent ONLY to a
                  peer that sent TRACE, so pre-trace clients never see
                  it; as with DEADLINE, ship client and server together
                  (a pre-trace server answers TRACE with an ERROR frame
                  and desyncs).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = [
    "MAGIC",
    "MsgType",
    "ScheduleRequest",
    "ScheduleResponse",
    "DeltaScheduleRequest",
    "DELTA_KEYFRAME",
    "DELTA_ROWS",
    "pack_delta_keyframe",
    "pack_delta_rows",
    "unpack_delta_schedule_request",
    "pack_delta_resync",
    "unpack_delta_resync",
    "write_frame",
    "read_frame",
    "pack_schedule_request",
    "unpack_schedule_request",
    "pack_schedule_response",
    "unpack_schedule_response",
    "pack_row_request",
    "unpack_row_request",
    "pack_deadline",
    "unpack_deadline",
    "pack_trace",
    "unpack_trace",
    "pack_trace_info",
    "unpack_trace_info",
    "pack_audit_id",
    "unpack_audit_id",
    "pack_tenant",
    "unpack_tenant",
    "pack_busy",
    "unpack_busy",
    "pack_draining",
    "unpack_draining",
    "TENANT_LABEL_MAX_BYTES",
    "is_stale_batch_message",
]

# bumped BSO1 -> BSO2 when the request header grew mask_rows: the layout
# change would otherwise misparse silently between mismatched peers
MAGIC = b"BSO2"
_HEADER = struct.Struct("<4sIQ")

# A realistic max batch (8k-node/2k-group buckets) is tens of MB; anything
# near this bound is a desynced or hostile peer, not a bigger cluster.
MAX_FRAME_BYTES = 256 * 1024 * 1024


class MsgType:
    SCHEDULE_REQ = 1
    SCHEDULE_RESP = 2
    ROW_REQ = 3
    ROW_RESP = 4
    PING = 5
    PONG = 6
    ERROR = 7
    DEADLINE = 8
    DEADLINE_ERROR = 9
    TRACE = 10
    TRACE_INFO = 11
    AUDIT_ID = 12
    POLICY_INFO = 13
    # Device-resident state deltas (docs/pipelining.md "Device-resident
    # state"): a DELTA_SCHEDULE_REQ is a SCHEDULE_REQ whose big [N,R]/[G,R]
    # buffers are already resident in the server's per-connection device
    # mirror — the payload carries only churned rows + generations (or a
    # full keyframe installing/refreshing the mirror). Answered with a
    # normal SCHEDULE_RESP, or DELTA_RESYNC when the mirror cannot apply
    # it (no state, generation gap, shape mismatch) — the client then
    # resends a keyframe. Old servers answer MsgType 14 with an in-band
    # ERROR ("unknown message type"); the client detects that and falls
    # back to full SCHEDULE_REQ snapshots permanently — bit-identical
    # plans either way, so mixed fleets stay correct (the
    # AUDIT_ID/POLICY_INFO compatibility pattern: new frames are opt-in
    # and never change existing layouts).
    DELTA_SCHEDULE_REQ = 14
    DELTA_RESYNC = 15
    # Tenant identity annotation (docs/multitenancy.md): a cardinality-
    # capped tenant label (utils.tenancy — the client's dominant
    # namespace) annotating the NEXT request on this connection, the
    # AUDIT_ID/POLICY_INFO pattern: no reply, old peers never see it
    # (clients send it only when they have a tenant identity), every
    # existing request/response layout — and the native C++ client,
    # which never announces tenants — stays bit-for-bit unchanged. The
    # sidecar sees packed arrays, never names, so without this frame its
    # capacity summary and scan counters attribute everything to
    # "other"/"-"; with it, sidecar-side capacity/metrics attribute
    # truthfully and the coalescer's DRF admission order has a tenant
    # to be fair BETWEEN.
    TENANT = 16
    # Admission-control refusal (docs/multitenancy.md): the coalescer's
    # bounded merge queue is saturated — the request was NOT executed and
    # nothing server-side changed (a delta's mirror generation is
    # untouched). Carries a retry-after hint in ms; the resilient client
    # waits it out and retries (never a breaker failure — the sidecar is
    # alive and telling the client exactly when to come back, never a
    # silent hang). Sent only by a coalescing server, which only clients
    # shipping this PR's frames talk to — the DEADLINE ship-together rule.
    BUSY = 17
    # Graceful-drain refusal (docs/resilience.md "High availability"): the
    # server received SIGTERM (or /debug/drain) and is finishing its
    # in-flight window before exit — the request was NOT executed and
    # nothing server-side changed. Carries a retry-after hint in ms plus a
    # failover hint string (the standby address list when the operator
    # supplied one). A pooled client promotes its standby PROACTIVELY on
    # this answer — the transport worked, so it never advances the circuit
    # breaker (the BUSY discipline). Old servers answer MsgType 18 with an
    # in-band ERROR and old clients never see it (a draining old server
    # just closes) — the BUSY/AUDIT_ID compatibility pattern: existing
    # layouts stay bit-for-bit unchanged.
    DRAINING = 18


ROW_KINDS = ("capacity", "scores")


@dataclass
class ScheduleRequest:
    alloc: np.ndarray  # i32 [N,R]
    requested: np.ndarray  # i32 [N,R]
    group_req: np.ndarray  # i32 [G,R]
    remaining: np.ndarray  # i32 [G]
    fit_mask: np.ndarray  # bool [1,N] broadcast row or [G,N] per-group
    group_valid: np.ndarray  # bool [G]
    order: np.ndarray  # i32 [G]
    # max-progress selection inputs (reference findMaxPG semantics)
    min_member: np.ndarray  # i32 [G]
    scheduled: np.ndarray  # i32 [G]
    matched: np.ndarray  # i32 [G]
    ineligible: np.ndarray  # bool [G]
    creation_rank: np.ndarray  # i32 [G]


@dataclass
class ScheduleResponse:
    gang_feasible: np.ndarray  # bool [G]
    placed: np.ndarray  # bool [G]
    progress: np.ndarray  # i32 [G]
    best: int
    best_exists: bool
    assignment_nodes: np.ndarray  # i32 [G,K]
    assignment_counts: np.ndarray  # i32 [G,K]
    # per-connection batch token; row requests must present it so a stale
    # reader can never be served rows from a newer batch
    batch_seq: int = 0


def write_frame(sock, msg_type: int, payload: bytes) -> None:
    sock.sendall(_HEADER.pack(MAGIC, msg_type, len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def read_frame(sock) -> Tuple[int, bytes]:
    header = _recv_exact(sock, _HEADER.size)
    magic, msg_type, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic: {magic!r}")
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"oversized frame: {length}")
    return msg_type, _recv_exact(sock, length)


# -- schedule request ------------------------------------------------------

# N, G, R, MASK_ROWS — mask_rows is 1 (broadcast row, the no-selector fast
# path) or G (per-group [G,N] selector masks). Shipping the broadcast row
# as ONE row instead of expanding it to [G,N] at the encoder cuts the
# north-star request frame from ~8.8 MB to ~0.4 MB (the mask was 96% of
# the bytes for a workload with no selectors at all).
_REQ_COUNTS = struct.Struct("<IIII")


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype="<i4")


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.uint8)


def pack_schedule_request(req: ScheduleRequest) -> bytes:
    n, r = req.alloc.shape
    g = req.group_req.shape[0]
    mask = np.asarray(req.fit_mask)
    if mask.shape[0] not in (1, g):
        raise ValueError(
            f"fit_mask rows must be 1 or G={g}, got {mask.shape[0]}"
        )
    parts = [
        _REQ_COUNTS.pack(n, g, r, mask.shape[0]),
        _i32(req.alloc).tobytes(),
        _i32(req.requested).tobytes(),
        _i32(req.group_req).tobytes(),
        _i32(req.remaining).tobytes(),
        _u8(mask).tobytes(),
        _u8(req.group_valid).tobytes(),
        _i32(req.order).tobytes(),
        _i32(req.min_member).tobytes(),
        _i32(req.scheduled).tobytes(),
        _i32(req.matched).tobytes(),
        _u8(req.ineligible).tobytes(),
        _i32(req.creation_rank).tobytes(),
    ]
    return b"".join(parts)


def unpack_schedule_request(payload: bytes) -> ScheduleRequest:
    n, g, r, mask_rows = _REQ_COUNTS.unpack_from(payload, 0)
    if mask_rows not in (1, g):
        raise ValueError(f"fit_mask rows must be 1 or G={g}, got {mask_rows}")
    off = _REQ_COUNTS.size

    def take(count, dtype, shape):
        nonlocal off
        size = count * np.dtype(dtype).itemsize
        arr = np.frombuffer(payload, dtype=dtype, count=count, offset=off)
        off += size
        return arr.reshape(shape)

    alloc = take(n * r, "<i4", (n, r))
    requested = take(n * r, "<i4", (n, r))
    group_req = take(g * r, "<i4", (g, r))
    remaining = take(g, "<i4", (g,))
    fit_mask = take(mask_rows * n, np.uint8, (mask_rows, n)).astype(bool)
    group_valid = take(g, np.uint8, (g,)).astype(bool)
    order = take(g, "<i4", (g,))
    min_member = take(g, "<i4", (g,))
    scheduled = take(g, "<i4", (g,))
    matched = take(g, "<i4", (g,))
    ineligible = take(g, np.uint8, (g,)).astype(bool)
    creation_rank = take(g, "<i4", (g,))
    if off != len(payload):
        raise ValueError(f"trailing bytes in schedule request: {len(payload) - off}")
    return ScheduleRequest(
        alloc, requested, group_req, remaining, fit_mask, group_valid, order,
        min_member, scheduled, matched, ineligible, creation_rank,
    )


# -- schedule response -----------------------------------------------------

_RESP_COUNTS = struct.Struct("<IIiBI")  # G, K, best, best_exists, batch_seq


def pack_schedule_response(resp: ScheduleResponse) -> bytes:
    g = resp.gang_feasible.shape[0]
    k = resp.assignment_nodes.shape[1]
    return b"".join(
        [
            _RESP_COUNTS.pack(g, k, resp.best, 1 if resp.best_exists else 0, resp.batch_seq),
            _u8(resp.gang_feasible).tobytes(),
            _u8(resp.placed).tobytes(),
            _i32(resp.progress).tobytes(),
            _i32(resp.assignment_nodes).tobytes(),
            _i32(resp.assignment_counts).tobytes(),
        ]
    )


def unpack_schedule_response(payload: bytes) -> ScheduleResponse:
    g, k, best, best_exists, batch_seq = _RESP_COUNTS.unpack_from(payload, 0)
    off = _RESP_COUNTS.size

    def take(count, dtype, shape):
        nonlocal off
        arr = np.frombuffer(payload, dtype=dtype, count=count, offset=off)
        off += count * np.dtype(dtype).itemsize
        return arr.reshape(shape)

    return ScheduleResponse(
        gang_feasible=take(g, np.uint8, (g,)).astype(bool),
        placed=take(g, np.uint8, (g,)).astype(bool),
        progress=take(g, "<i4", (g,)),
        best=best,
        best_exists=bool(best_exists),
        assignment_nodes=take(g * k, "<i4", (g, k)),
        assignment_counts=take(g * k, "<i4", (g, k)),
        batch_seq=batch_seq,
    )


def is_stale_batch_message(message: str) -> bool:
    """True when an in-band server error means "this batch's rows no
    longer exist": an explicit stale-batch refusal, or a row request on a
    connection with no batch state yet (the same situation seen through a
    reconnect). Shared by the Python client and the native-client
    bindings so both transports map it to StaleBatchError — the one class
    the scorer's row reads may answer conservatively."""
    return "stale batch" in message or "before any batch" in message


# -- deadline annotation ---------------------------------------------------

_DEADLINE = struct.Struct("<I")


def pack_deadline(deadline_ms: int) -> bytes:
    if not 0 < deadline_ms <= 0xFFFFFFFF:
        raise ValueError(f"deadline_ms out of range: {deadline_ms}")
    return _DEADLINE.pack(deadline_ms)


def unpack_deadline(payload: bytes) -> int:
    return int(_DEADLINE.unpack(payload)[0])


# -- trace annotation + trace-info reply -----------------------------------

# fixed-width ascii: 16-hex trace id + 8-hex parent span id. Binary-fixed
# (not JSON) because the annotation rides the REQUEST hot path; the reply
# (TRACE_INFO) is JSON because it is only ever sent to a tracing client.
_TRACE = struct.Struct("<16s8s")


def pack_trace(trace_id: str, parent_span_id: str = "") -> bytes:
    tid = trace_id.encode("ascii")
    sid = parent_span_id.encode("ascii")
    if len(tid) != 16:
        raise ValueError(f"trace_id must be 16 hex chars, got {trace_id!r}")
    return _TRACE.pack(tid, sid[:8].ljust(8, b"\0"))


def unpack_trace(payload: bytes) -> Tuple[str, str]:
    tid, sid = _TRACE.unpack(payload)
    return (
        tid.decode("ascii", errors="replace"),
        sid.rstrip(b"\0").decode("ascii", errors="replace"),
    )


def pack_trace_info(trace_id: str, spans: list, telemetry: dict) -> bytes:
    import json

    return json.dumps(
        {"trace_id": trace_id, "spans": spans, "telemetry": telemetry},
        default=str,
    ).encode()


def unpack_trace_info(payload: bytes) -> dict:
    import json

    try:
        info = json.loads(payload.decode("utf-8", errors="replace"))
    except ValueError:
        return {}
    if not isinstance(info, dict):
        return {}
    return info


# -- audit-id annotation ----------------------------------------------------

# fixed-width ascii like the TRACE annotation: 16-hex audit record ID
# (utils.audit.new_audit_id) correlating the client's and the sidecar's
# audit records of one batch
_AUDIT = struct.Struct("<16s")


def pack_audit_id(audit_id: str) -> bytes:
    aid = audit_id.encode("ascii")
    if len(aid) != 16:
        raise ValueError(f"audit_id must be 16 hex chars, got {audit_id!r}")
    return _AUDIT.pack(aid)


def unpack_audit_id(payload: bytes) -> str:
    return _AUDIT.unpack(payload)[0].decode("ascii", errors="replace")


# -- policy fingerprint annotation ------------------------------------------

# fixed-width ascii like the AUDIT_ID annotation: the 16-hex policy-config
# fingerprint (policy.engine.PolicyConfig.fingerprint) of the CLIENT's
# active policy engine, annotating the next request on this connection.
# The sidecar executes base (policy-unaware) batches; a client running
# policies compares fingerprints so a mismatched peer is a counted,
# visible condition (bst_policy_fingerprint_mismatch_total) rather than a
# silent plan divergence. No reply; old peers that don't know MsgType 13
# never receive it (clients send it only when a policy engine is live).
_POLICY = struct.Struct("<16s")


def pack_policy_info(fingerprint: str) -> bytes:
    fp = fingerprint.encode("ascii")
    if len(fp) != 16:
        raise ValueError(
            f"policy fingerprint must be 16 hex chars, got {fingerprint!r}"
        )
    return _POLICY.pack(fp)


def unpack_policy_info(payload: bytes) -> str:
    return _POLICY.unpack(payload)[0].decode("ascii", errors="replace")


# -- tenant annotation + busy admission-control reply ------------------------

# Variable-length (tenant labels are namespaces, not fixed-width hex), but
# bounded: a label is already cardinality-capped client-side
# (utils.tenancy.tenant_label), and the byte cap here keeps a hostile
# peer from using the annotation as a memory lever.
TENANT_LABEL_MAX_BYTES = 64


def pack_tenant(label: str) -> bytes:
    raw = label.encode("utf-8")
    if not raw:
        raise ValueError("tenant label must be non-empty")
    if len(raw) > TENANT_LABEL_MAX_BYTES:
        # truncate, never raise: the label is attribution metadata — a
        # long namespace must degrade to a clipped label, not crash the
        # schedule path mid-stream (annotation frames already written).
        # Re-encode through a lossy decode so a codepoint split at the
        # byte cap drops cleanly instead of shipping a partial sequence.
        raw = (
            raw[:TENANT_LABEL_MAX_BYTES]
            .decode("utf-8", errors="ignore")
            .encode("utf-8")
        )
    return raw


def unpack_tenant(payload: bytes) -> str:
    return payload[:TENANT_LABEL_MAX_BYTES].decode("utf-8", errors="replace")


# retry-after hint in ms, then a UTF-8 message for operators/logs
_BUSY = struct.Struct("<I")


def pack_busy(retry_after_ms: int, message: str = "") -> bytes:
    if not 0 <= retry_after_ms <= 0xFFFFFFFF:
        raise ValueError(f"retry_after_ms out of range: {retry_after_ms}")
    return _BUSY.pack(retry_after_ms) + message.encode()


def unpack_busy(payload: bytes) -> Tuple[int, str]:
    (retry_after_ms,) = _BUSY.unpack_from(payload, 0)
    return int(retry_after_ms), payload[_BUSY.size:].decode(errors="replace")


# DRAINING shares BUSY's layout: retry-after hint in ms, then a UTF-8
# failover hint (the standby address list, comma-separated, when the
# operator supplied one — empty otherwise).


def pack_draining(retry_after_ms: int, failover_hint: str = "") -> bytes:
    if not 0 <= retry_after_ms <= 0xFFFFFFFF:
        raise ValueError(f"retry_after_ms out of range: {retry_after_ms}")
    return _BUSY.pack(retry_after_ms) + failover_hint.encode()


def unpack_draining(payload: bytes) -> Tuple[int, str]:
    (retry_after_ms,) = _BUSY.unpack_from(payload, 0)
    return int(retry_after_ms), payload[_BUSY.size:].decode(errors="replace")


# -- device-resident state deltas -------------------------------------------

# kind, base_generation, new_generation. base_generation is the mirror
# generation this delta applies ON TOP OF (ignored for keyframes); the
# server refuses any mismatch with DELTA_RESYNC — a dropped or duplicated
# delta frame must force a keyframe resync, never silently score stale rows.
_DELTA_HEADER = struct.Struct("<BQQ")
DELTA_KEYFRAME = 1
DELTA_ROWS = 2

# counts of a rows-delta body: n, g, r, mask_rows (the padded request
# space, same convention as the full request), churned node rows, churned
# group rows
_DELTA_COUNTS = struct.Struct("<IIIIII")


@dataclass
class DeltaScheduleRequest:
    """Churned-row refresh of a connection's device-resident mirror: the
    [N,R] requested / [G,R] group-demand rows that changed since the
    mirror's generation, plus the full (tiny) O(G) tail — which is
    refresh-fresh by definition. ``alloc`` is never delta'd: alloc churn
    full-repacks host-side (the lane shifts may move), which forces a
    keyframe."""

    node_idx: np.ndarray  # i32 [Mn] churned requested-row indices
    node_rows: np.ndarray  # i32 [Mn, R]
    group_idx: np.ndarray  # i32 [Mg] churned group-demand row indices
    group_rows: np.ndarray  # i32 [Mg, R]
    remaining: np.ndarray  # i32 [G]
    fit_mask: np.ndarray  # bool [mask_rows, N]
    group_valid: np.ndarray  # bool [G]
    order: np.ndarray  # i32 [G]
    min_member: np.ndarray  # i32 [G]
    scheduled: np.ndarray  # i32 [G]
    matched: np.ndarray  # i32 [G]
    ineligible: np.ndarray  # bool [G]
    creation_rank: np.ndarray  # i32 [G]
    n: int = 0
    g: int = 0
    r: int = 0


def pack_delta_keyframe(new_generation: int, req: ScheduleRequest) -> bytes:
    """A full snapshot that (re)installs the server's mirror at
    ``new_generation`` — byte-wise the keyframe body IS a schedule
    request, so the two paths can never drift."""
    return _DELTA_HEADER.pack(
        DELTA_KEYFRAME, 0, new_generation
    ) + pack_schedule_request(req)


def pack_delta_rows(
    base_generation: int, new_generation: int, d: DeltaScheduleRequest
) -> bytes:
    node_idx = _i32(d.node_idx)
    group_idx = _i32(d.group_idx)
    parts = [
        _DELTA_HEADER.pack(DELTA_ROWS, base_generation, new_generation),
        _DELTA_COUNTS.pack(
            d.n, d.g, d.r, np.asarray(d.fit_mask).shape[0],
            node_idx.shape[0], group_idx.shape[0],
        ),
        node_idx.tobytes(),
        _i32(d.node_rows).tobytes(),
        group_idx.tobytes(),
        _i32(d.group_rows).tobytes(),
        _i32(d.remaining).tobytes(),
        _u8(d.fit_mask).tobytes(),
        _u8(d.group_valid).tobytes(),
        _i32(d.order).tobytes(),
        _i32(d.min_member).tobytes(),
        _i32(d.scheduled).tobytes(),
        _i32(d.matched).tobytes(),
        _u8(d.ineligible).tobytes(),
        _i32(d.creation_rank).tobytes(),
    ]
    return b"".join(parts)


def unpack_delta_schedule_request(payload: bytes):
    """Returns ``(kind, base_generation, new_generation, body)`` where
    ``body`` is a ScheduleRequest (keyframe) or DeltaScheduleRequest."""
    kind, base_gen, new_gen = _DELTA_HEADER.unpack_from(payload, 0)
    rest = payload[_DELTA_HEADER.size:]
    if kind == DELTA_KEYFRAME:
        return kind, base_gen, new_gen, unpack_schedule_request(rest)
    if kind != DELTA_ROWS:
        raise ValueError(f"unknown delta kind {kind}")
    n, g, r, mask_rows, m_nodes, m_groups = _DELTA_COUNTS.unpack_from(rest, 0)
    if mask_rows not in (1, g):
        raise ValueError(f"fit_mask rows must be 1 or G={g}, got {mask_rows}")
    off = _DELTA_COUNTS.size

    def take(count, dtype, shape):
        nonlocal off
        arr = np.frombuffer(rest, dtype=dtype, count=count, offset=off)
        off += count * np.dtype(dtype).itemsize
        return arr.reshape(shape)

    d = DeltaScheduleRequest(
        node_idx=take(m_nodes, "<i4", (m_nodes,)),
        node_rows=take(m_nodes * r, "<i4", (m_nodes, r)),
        group_idx=take(m_groups, "<i4", (m_groups,)),
        group_rows=take(m_groups * r, "<i4", (m_groups, r)),
        remaining=take(g, "<i4", (g,)),
        fit_mask=take(mask_rows * n, np.uint8, (mask_rows, n)).astype(bool),
        group_valid=take(g, np.uint8, (g,)).astype(bool),
        order=take(g, "<i4", (g,)),
        min_member=take(g, "<i4", (g,)),
        scheduled=take(g, "<i4", (g,)),
        matched=take(g, "<i4", (g,)),
        ineligible=take(g, np.uint8, (g,)).astype(bool),
        creation_rank=take(g, "<i4", (g,)),
        n=n,
        g=g,
        r=r,
    )
    if off != len(rest):
        raise ValueError(
            f"trailing bytes in delta schedule request: {len(rest) - off}"
        )
    return kind, base_gen, new_gen, d


def pack_delta_resync(reason: str) -> bytes:
    return reason.encode()


def unpack_delta_resync(payload: bytes) -> str:
    return payload.decode(errors="replace")


# -- row request/response --------------------------------------------------

_ROW_REQ = struct.Struct("<BII")  # kind index, group index, batch_seq


def pack_row_request(kind: str, group_index: int, batch_seq: int = 0) -> bytes:
    return _ROW_REQ.pack(ROW_KINDS.index(kind), group_index, batch_seq)


def unpack_row_request(payload: bytes) -> Tuple[str, int, int]:
    kind_idx, group_index, batch_seq = _ROW_REQ.unpack(payload)
    return ROW_KINDS[kind_idx], group_index, batch_seq
