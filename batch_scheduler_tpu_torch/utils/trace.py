"""Schedule-trace pipeline: spans, ring-buffer recorder, Chrome-trace
export, and the gang decision flight recorder.

The port of ``batch_scheduler_tpu/utils/trace.py``, line for line in its
behaviour, so both packages leave the same evidence for the same work:

- ``start_trace(name)`` opens a sampled root span with a fresh 16-hex
  trace ID; ``span(name)`` nests under whatever span is live on the
  current thread (thread-local context stack), so the decision path
  (gang transaction -> oracle refresh -> pack -> device-state sync ->
  batch -> wire round-trip) stitches into one tree without threading IDs
  through every signature.
- ``current_context()`` exposes (trace_id, span_id) for wire propagation:
  the sidecar protocol carries it in a TRACE annotation frame
  (service.protocol) and the server's spans come back in a TRACE_INFO
  frame, re-recorded here under the ``oracle-server`` track —
  client-side and server-side spans of one batch share the trace ID.
- ``TraceRecorder`` is a bounded, thread-safe ring of completed spans;
  ``chrome_trace()`` renders the ``traceEvents`` JSON that
  chrome://tracing and Perfetto load directly.
- ``FlightRecorder`` is the gang decision flight recorder: a bounded
  per-gang ring of structured decision records (phase, verdict, blame
  reason, feasible-node count, wave stats) served at ``/debug/decisions``
  on the metrics endpoint (utils.metrics).

Spans measure host wall time. A span around a device batch covers the
device work only where the host already waits for it (``collect_batch``
waits on the batch's event and its copy to host memory); no span
synchronizes the card.

Cost discipline: tracing is OFF by default and the disabled path is one
module-level boolean read returning a shared no-op context manager — no
allocation, no clock read. The flight recorder is always on: it appends
one small dict per scheduling DECISION (not per node), bounded by the
ring.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from .tenancy import gang_namespace, tenant_label

__all__ = [
    "TraceRecorder",
    "FlightRecorder",
    "DEFAULT_RECORDER",
    "DEFAULT_FLIGHT_RECORDER",
    "DEFAULT_CAPACITY",
    "configure",
    "enabled",
    "new_trace_id",
    "span",
    "start_trace",
    "current_context",
    "record_remote_spans",
]

# Span ring capacity: at ~6 spans per scheduling cycle a 16k ring holds the
# last ~2.5k cycles — minutes of history at production rates, ~few MB.
DEFAULT_CAPACITY = 16384


def new_trace_id() -> str:
    """16 lowercase hex chars (64 bits), collision-safe for a ring's
    lifetime. os.urandom avoids any seeded-PRNG correlation between
    processes (the client and sidecar must never mint the same ID)."""
    return os.urandom(8).hex()


def _new_span_id() -> str:
    return os.urandom(4).hex()


class TraceRecorder:
    """Thread-safe bounded ring of completed span events (Chrome-trace
    "X" complete-event dicts). Appends are O(1) under a lock; the ring
    drops oldest-first so a long-running process serves the recent
    window, never an unbounded log."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def add(self, event: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def _snapshot_with_dropped(self) -> tuple:
        # one locked read so the exported ring and its drop count cohere
        with self._lock:
            return list(self._events), self.dropped

    def resize(self, capacity: int) -> None:
        """Replace the ring with an empty one of ``capacity`` entries."""
        with self._lock:
            self._events = deque(maxlen=int(capacity))
            self.dropped = 0

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self) -> dict:
        """The Chrome-trace/Perfetto JSON object format: load the file at
        chrome://tracing or ui.perfetto.dev as-is. Process-name metadata
        rows label the tracks (scheduler vs oracle-server)."""
        events, dropped = self._snapshot_with_dropped()
        pids = []
        for e in events:
            if e.get("pid") not in pids:
                pids.append(e.get("pid"))
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": str(pid)},
            }
            for pid in pids
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped},
        }

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


DEFAULT_RECORDER = TraceRecorder()

# module-level switch (list-wrapped for lock-free flip from any thread) +
# sample rate
_enabled = [False]
_sample = [1.0]

_ctx = threading.local()  # per-thread stack of (trace_id, span_id)


def configure(
    enabled: bool = True,
    sample: float = 1.0,
    capacity: Optional[int] = None,
) -> None:
    """Turn the span pipeline on/off. ``sample`` is the fraction of root
    traces kept (children follow their root's fate, so a sampled-out
    cycle costs nothing downstream). ``capacity`` resizes the default
    ring (drops current contents)."""
    _enabled[0] = bool(enabled)
    _sample[0] = min(max(float(sample), 0.0), 1.0)
    if capacity is not None:
        DEFAULT_RECORDER.resize(capacity)


def enabled() -> bool:
    return _enabled[0]


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the innermost live span on this thread, or
    None — what the wire client packs into the TRACE annotation frame."""
    stack = getattr(_ctx, "stack", None)
    if not stack:
        return None
    return stack[-1]


class _NullSpan:
    """Shared no-op context manager: the entire disabled/sampled-out
    cost. __slots__ so even attribute writes fail fast in tests."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = (
        "name", "cat", "pid", "trace_id", "span_id", "parent_id",
        "args", "_t0", "_ts", "recorder",
    )

    def __init__(self, name, cat, pid, trace_id, parent_id, args, recorder):
        self.name = name
        self.cat = cat
        self.pid = pid
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.args = args
        self.recorder = recorder

    def set(self, **attrs) -> None:
        """Attach attributes mid-span (verdicts, counts, blame)."""
        self.args.update(attrs)

    def __enter__(self):
        stack = getattr(_ctx, "stack", None)
        if stack is None:
            stack = _ctx.stack = []
        stack.append((self.trace_id, self.span_id))
        self._ts = time.time() * 1e6  # epoch microseconds (Chrome ts unit)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = (time.perf_counter() - self._t0) * 1e6
        stack = getattr(_ctx, "stack", None)
        if stack:
            stack.pop()
        args = self.args
        args["trace_id"] = self.trace_id
        args["span_id"] = self.span_id
        if self.parent_id:
            args["parent_id"] = self.parent_id
        if exc_type is not None:
            args["error"] = exc_type.__name__
        self.recorder.add(
            {
                "name": self.name,
                "cat": self.cat,
                "ph": "X",
                "ts": self._ts,
                "dur": dur,
                "pid": self.pid,
                "tid": threading.get_ident() & 0xFFFF,
                "args": args,
            }
        )
        return False


def span(name: str, cat: str = "sched", pid: str = "scheduler", **attrs):
    """A child span under the current thread's live trace. No live trace
    (or tracing disabled) => the shared no-op — child spans never
    self-start a trace, so an un-sampled cycle stays free end-to-end."""
    if not _enabled[0]:
        return _NULL_SPAN
    ctx = current_context()
    if ctx is None:
        return _NULL_SPAN
    trace_id, parent_id = ctx
    return _Span(name, cat, pid, trace_id, parent_id, dict(attrs), DEFAULT_RECORDER)


# deterministic round-robin sampler (clock-free, seed-free): keeps exactly
# the sample fraction of root traces with no RNG state to coordinate
_sample_counter = [0]


def start_trace(
    name: str,
    cat: str = "sched",
    pid: str = "scheduler",
    trace_id: Optional[str] = None,
    **attrs,
):
    """Open a ROOT span with a fresh (or adopted) trace ID, subject to
    sampling. Everything opened with ``span()`` on this thread while it
    is live nests under it."""
    if not _enabled[0]:
        return _NULL_SPAN
    s = _sample[0]
    if s < 1.0:
        _sample_counter[0] += 1
        if s <= 0.0 or (_sample_counter[0] * s) % 1.0 >= s:
            return _NULL_SPAN
    return _Span(
        name, cat, pid, trace_id or new_trace_id(), None, dict(attrs),
        DEFAULT_RECORDER,
    )


def record_remote_spans(
    spans: List[dict], pid: str = "oracle-server"
) -> None:
    """Fold spans reported by a remote peer (the sidecar's TRACE_INFO
    frame) into the local ring, stitching them into the client timeline:
    they carry the same trace_id the client sent, so the exported
    Chrome trace shows one trace spanning both processes. Remote spans
    arrive as {name, ts (epoch us), dur (us), args} dicts."""
    for s in spans:
        try:
            if not isinstance(s, dict):
                continue
            args = dict(s.get("args") or {})
            DEFAULT_RECORDER.add(
                {
                    "name": str(s["name"]),
                    "cat": str(s.get("cat", "oracle")),
                    "ph": "X",
                    "ts": float(s["ts"]),
                    "dur": float(s.get("dur", 0.0)),
                    "pid": pid,
                    "tid": int(s.get("tid", 0)),
                    "args": args,
                }
            )
        except (KeyError, TypeError, ValueError):
            continue  # a malformed peer span must never break the caller


# ---------------------------------------------------------------------------
# gang decision flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded per-gang ring of structured decision records: why was gang
    G denied/placed/parked, by which phase, on what evidence. Always on
    (one dict append per scheduling decision); LRU-bounded on gangs so a
    churn workload cannot grow it without bound.

    Record fields: ``ts`` (epoch seconds), ``gang``, ``phase`` (the
    decision site: pre_filter, policy, batch), ``verdict`` (placed |
    denied | wait | error | info), ``reason`` (the blame string), plus
    free-form evidence fields — feasible_nodes, wave stats, trace_id
    (stamped from the live span context when tracing is on, linking a
    decision to its trace)."""

    def __init__(self, per_gang: int = 32, max_gangs: int = 1024):
        self.per_gang = per_gang
        self.max_gangs = max_gangs
        self._lock = threading.Lock()
        self._gangs: "OrderedDict[str, deque]" = OrderedDict()  # guarded-by: _lock
        self.dropped_gangs = 0  # guarded-by: _lock

    def record(
        self,
        gang: str,
        phase: str,
        verdict: str,
        reason: str = "",
        coalesce: bool = False,
        **fields,
    ) -> None:
        """Append one decision record. ``coalesce=True`` collapses an
        exact repeat of the gang's LAST record (same phase + verdict +
        reason) into a ``repeats`` bump on it instead of a new entry —
        the denial paths use it so a parked gang's backoff retries cannot
        flood the 32-deep ring and roll the authoritative blame record
        out."""
        rec = {
            "ts": time.time(),
            "gang": gang,
            "phase": phase,
            "verdict": verdict,
            "reason": reason,
        }
        # cardinality-capped tenant attribution on every decision record
        # (utils.tenancy): stamped here so no record site needs to know the
        # mapping. Pseudo-gangs without a namespace ("_batch") carry none.
        ns = gang_namespace(gang)
        if ns:
            rec["tenant"] = tenant_label(ns)
        ctx = current_context()
        if ctx is not None:
            rec["trace_id"] = ctx[0]
        rec.update(fields)
        with self._lock:
            ring = self._gangs.get(gang)
            if ring is None:
                ring = deque(maxlen=self.per_gang)
                self._gangs[gang] = ring
                while len(self._gangs) > self.max_gangs:
                    self._gangs.popitem(last=False)
                    self.dropped_gangs += 1
            else:
                self._gangs.move_to_end(gang)
            if coalesce and ring:
                last = ring[-1]
                if (
                    last.get("phase") == phase
                    and last.get("verdict") == verdict
                    and last.get("reason") == reason
                ):
                    last["repeats"] = last.get("repeats", 1) + 1
                    last["ts"] = rec["ts"]
                    # evidence fields refresh to the newest observation
                    # (batch seq, feasible count) — the blame is the same
                    last.update(fields)
                    return
            ring.append(rec)

    def snapshot(
        self,
        gang: Optional[str] = None,
        tenant: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> Dict[str, List[dict]]:
        return self._snapshot_with_dropped(gang, tenant, limit)[0]

    def _snapshot_with_dropped(
        self,
        gang: Optional[str] = None,
        tenant: Optional[str] = None,
        limit: Optional[int] = None,
    ):
        # one locked read so a payload and its drop count cohere.
        # ``tenant`` scopes to gangs whose records carry that tenant label;
        # ``limit`` caps to the K most recently active gangs (the rings are
        # already bounded per gang — the unbounded payload dimension is
        # gang count). Records are copied: a coalescing record() may
        # update the newest one in place after the lock is released.
        with self._lock:
            if gang is not None:
                ring = self._gangs.get(gang)
                items = (
                    [(gang, [dict(r) for r in ring])] if ring is not None else []
                )
            else:
                items = [
                    (g, [dict(r) for r in ring])
                    for g, ring in self._gangs.items()
                ]
            dropped = self.dropped_gangs
        if tenant is not None:
            items = [
                (g, recs)
                for g, recs in items
                if any(r.get("tenant") == tenant for r in recs)
            ]
        if limit is not None and limit >= 0:
            # LRU order puts the most recently active gangs LAST
            items = items[-limit:] if limit else []
        return dict(items), dropped

    def last(self, gang: str) -> Optional[dict]:
        with self._lock:
            ring = self._gangs.get(gang)
            return dict(ring[-1]) if ring else None

    def to_json(
        self,
        gang: Optional[str] = None,
        tenant: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> bytes:
        decisions, dropped = self._snapshot_with_dropped(gang, tenant, limit)
        return json.dumps(
            {
                "decisions": decisions,
                "dropped_gangs": dropped,
            },
            default=str,
        ).encode()

    def clear(self) -> None:
        with self._lock:
            self._gangs.clear()
            self.dropped_gangs = 0


DEFAULT_FLIGHT_RECORDER = FlightRecorder()
