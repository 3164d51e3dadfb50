"""Gang lifecycle observatory: the per-gang time-to-placement ledger.

The port of ``batch_scheduler_tpu/utils/lifecycle.py``: the same event
taxonomy, coalescing rules, derivations, stream cursor and export lines,
so the same event script gives the same timelines in both packages.

``GangLifecycleLedger`` records every gang's full timeline — arrival,
queue admission, each PreFilter denial (coalesced into streaks, the
FlightRecorder discipline), preemption eviction/respawn, permit quorum,
bind, delete — each event cross-stamped with the active trace ID
(utils.trace) and the batch audit ID (utils.audit) so one gang's story
joins the existing evidence chain. From the ledger derive:

* ``bst_gang_ttp_seconds{tenant,tier}`` — arrival→bind, observed at every
  bind (so preemption churn is *included*: an evicted gang's respawn does
  not reset the clock), plus ``bst_gang_ttp_phase_seconds{phase,...}``
  decomposing it into queue_wait (arrival→first scheduling attempt),
  schedule_wait (→permit, net of sidecar time), sidecar_wait (the
  coalescer queue time attributed from TRACE_INFO telemetry, best-effort:
  zero when the client ran untraced), and bind_wait (permit→bind).
* the ``/debug/gangs`` reconstructed-timeline surface and the
  ``/debug/events?since=`` long-poll stream (monotonic cursor), both in
  utils.metrics.
* a bounded JSONL export (``set_export_dir``): one line per event
  occurrence, size-rotated at ``BST_LIFECYCLE_EXPORT_MAX_MB``, so
  downstream consumers get push-shaped gang events instead of
  scrape-shaped gauges.

Offline reconstruction is exact: every occurrence is also emitted as a
``gang_lifecycle`` audit event carrying the event's stable ``seq``;
folding the flat records by (gang, seq) with the same coalesce rule the
live ring applies (``_coalesce_into``) reproduces the live timeline.

In the port, ``core.operation`` notes permit, eviction and delete,
``core.oracle_scorer`` the batch context, and the scheduler loop
(``framework.scheduler``) arrival, admission, deny, eviction and bind, as
in the reference.

Lock discipline: one mutex (a Condition, for the long-poll) guards every
mutable structure; file/audit emission happens OUTSIDE it so a slow disk
can never stall the scheduling hot path. Bounded everywhere: per-gang
event rings, an LRU gang cap, a fixed stream ring, size-rotated export
files.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from . import metrics
from .metrics import LONG_OP_BUCKETS
from .tenancy import gang_namespace, tenant_label
from .trace import current_context

__all__ = [
    "GangLifecycleLedger",
    "DEFAULT_LEDGER",
    "EVENTS",
]

# the event taxonomy (docs/observability.md): every note_* maps to one
EVENTS = (
    "arrival",    # informer saw the gang's first pod (tier/size stamped)
    "respawn",    # the preemption path re-created the gang's pods
    "admitted",   # the gang entered a scheduling cycle (coalesced)
    "deny",       # a PreFilter/feasibility denial (coalesced streaks)
    "evicted",    # a preemption plan evicted this gang
    "permit",     # the gang reached permit quorum
    "bind",       # the gang's pods were bound (TTP observed here)
    "delete",     # the gang's CRD was deleted / forgotten
)

# The steady retry cycle's events: a parked gang alternates
# admitted<->deny every cycle (with member arrivals interleaved at
# startup), so coalescing may merge one entry BACK across an event from
# this set — two ring slots per wait instead of unbounded churn.
# Terminal/boundary events (permit, bind, evicted, delete) are never
# skipped over.
_RETRY_CYCLE = frozenset({"arrival", "respawn", "admitted", "deny"})


def _export_max_bytes() -> int:
    """``BST_LIFECYCLE_EXPORT_MAX_MB`` — size cap per export file before
    rotation (events.jsonl -> events.jsonl.1). Parse-guarded: a
    malformed value falls back to the default instead of crashing the
    hot path."""
    raw = os.environ.get("BST_LIFECYCLE_EXPORT_MAX_MB")
    try:
        mb = float(raw) if raw is not None else 16.0
        if not (mb > 0):
            raise ValueError(raw)
    except (ValueError, TypeError):
        mb = 16.0
    return int(mb * 1024 * 1024)


def _quantile_from_counts(
    buckets: Tuple[float, ...], counts: List[int], total: int, q: float
) -> float:
    """Histogram-quantile over already-merged cumulative bucket counts
    (metrics.Histogram.quantile's interpolation, freed from a single
    labelset so per-tenant reports can merge the tier series first)."""
    if total <= 0:
        return 0.0
    rank = q * total
    prev_count, prev_bound = 0, 0.0
    for i, b in enumerate(buckets):
        if counts[i] >= rank:
            span = counts[i] - prev_count
            frac = 1.0 if span <= 0 else (rank - prev_count) / span
            return prev_bound + (b - prev_bound) * frac
        prev_count, prev_bound = counts[i], b
    return buckets[-1]


class GangLifecycleLedger:
    """Bounded, lock-disciplined per-gang lifecycle ledger (module
    docstring). ``DEFAULT_LEDGER`` is the process-wide instance the
    scheduler/operation/oracle hooks feed; ``ScheduleOperation`` resets
    it at construction so each sim run starts with a clean ledger (the
    PendingGangTracker isolation discipline)."""

    def __init__(
        self,
        per_gang: int = 64,
        max_gangs: int = 2048,
        stream_capacity: int = 8192,
        registry: Optional[metrics.Registry] = None,
    ):
        self.per_gang = per_gang
        self.max_gangs = max_gangs
        self._cond = threading.Condition()
        # gang -> record dict; LRU on note order
        self._gangs: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _cond
        self._stream: deque = deque(maxlen=stream_capacity)  # guarded-by: _cond
        self._cursor = 0          # guarded-by: _cond (monotonic, never reused)
        self._seq = 0             # guarded-by: _cond (stable per logical event)
        self.dropped_gangs = 0    # guarded-by: _cond
        self.stream_dropped = 0   # guarded-by: _cond
        self._batch_aid: Optional[str] = None   # guarded-by: _cond
        self._batch_sidecar_s = 0.0             # guarded-by: _cond
        self._audit = None        # guarded-by: _cond (utils.audit.AuditLog)
        self._export_dir: Optional[str] = None  # guarded-by: _cond
        # export IO happens outside _cond under its own lock so a slow
        # disk can never stall a scheduling-path note_*
        self._io_lock = threading.Lock()
        self._export_size = 0     # guarded-by: _io_lock
        reg = registry or metrics.DEFAULT_REGISTRY
        self._ttp_hist = reg.histogram(
            "bst_gang_ttp_seconds",
            "gang time-to-placement: arrival->bind seconds "
            "(preemption churn included)",
            buckets=LONG_OP_BUCKETS,
        )
        self._phase_hist = reg.histogram(
            "bst_gang_ttp_phase_seconds",
            "TTP phase decomposition: queue_wait | schedule_wait | "
            "sidecar_wait | bind_wait",
            buckets=LONG_OP_BUCKETS,
        )
        self._events_counter = reg.counter(
            "bst_lifecycle_events_total", "lifecycle events by type"
        )
        self._stream_dropped_counter = reg.counter(
            "bst_lifecycle_stream_dropped_total",
            "lifecycle stream-ring evictions (consumers saw a cursor gap)",
        )

    # -- sinks ---------------------------------------------------------------

    def attach_audit(self, audit_log) -> None:
        """Mirror every occurrence into the audit ring as a
        ``gang_lifecycle`` event record — the source ``fold`` rebuilds
        the timelines from offline."""
        with self._cond:
            self._audit = audit_log

    def set_export_dir(self, path: Optional[str]) -> None:
        """Arm the bounded JSONL export: one line
        per occurrence into ``<dir>/events.jsonl``, rotated to
        ``events.jsonl.1`` past the size cap."""
        if path is not None:
            os.makedirs(path, exist_ok=True)
        with self._cond:
            self._export_dir = path
        with self._io_lock:
            self._export_size = 0

    # -- the note_* hook surface --------------------------------------------

    def note_arrival(self, gang: str, tier: int = 0, pods: int = 0) -> None:
        """Informer arrival (framework.scheduler.enqueue*), one call per
        pod — consecutive member arrivals coalesce into one streak. The
        FIRST arrival anchors the TTP clock; an arrival AFTER an eviction
        is the preemption path's respawn (same name, new uids) and keeps
        the original anchor, so TTP includes preemption churn."""
        self._note(gang, "arrival", tier=int(tier), pods=int(pods))

    def note_admitted(self, gang: str) -> None:
        """The gang entered a scheduling cycle (the gang transaction
        fast-lane) — coalesced, so steady retry cycles bump one streak
        instead of flooding the ring. ``first_ts`` keeps the queue-wait
        anchor honest across the streak."""
        self._note(gang, "admitted", coalesce=True)

    def note_deny(self, gang: str, reason: str) -> None:
        """One PreFilter/feasibility denial, coalesced into a streak per
        blame string (the FlightRecorder discipline)."""
        self._note(gang, "deny", reason=reason, coalesce=True)

    def note_evicted(self, gang: str, preemptor: str = "") -> None:
        self._note(gang, "evicted", preemptor=preemptor)

    def note_permit(self, gang: str) -> None:
        self._note(gang, "permit")

    def note_bind(self, gang: str, members: int = 0) -> None:
        """Terminal placement event: observes ``bst_gang_ttp_seconds``
        (arrival→THIS bind, so a preempted gang's second bind measures
        the full churn) and the phase decomposition histograms.
        Coalesced: the per-pod binding cycle notes each member bind, and
        only the streak's FIRST occurrence observes the histograms — a
        5-member gang is one TTP sample, not five."""
        self._note(gang, "bind", coalesce=True, members=int(members))

    def note_delete(self, gang: str) -> None:
        self._note(gang, "delete")

    def note_batch_context(self, audit_id: Optional[str], telemetry=None) -> None:
        """The oracle's batch publish hook (core.oracle_scorer._publish):
        arms the audit-id every subsequent event stamps, plus the
        sidecar queue-wait from the coalescer's TRACE_INFO telemetry
        (``lock_wait_seconds``) — attributed once per (gang, audit_id)
        so a batch's wait is not double-counted across a gang's events.
        Telemetry only flows when the client ran traced; absent, the
        sidecar_wait phase reads zero (documented best-effort)."""
        wait_s = 0.0
        if telemetry:
            try:
                coal = telemetry.get("coalesce")
                if isinstance(coal, dict) and "queue_wait_seconds" in coal:
                    # the coalescer's explicit per-request attribution
                    # (service.coalescer) beats the aggregate timing
                    wait_s = float(coal["queue_wait_seconds"])
                else:
                    wait_s = float(telemetry.get("lock_wait_seconds", 0.0))
            except (TypeError, ValueError):
                wait_s = 0.0
        with self._cond:
            self._batch_aid = audit_id
            self._batch_sidecar_s = wait_s if audit_id is not None else 0.0

    # -- core record path ----------------------------------------------------

    @staticmethod
    def _coalesce_into(last: dict, occ: dict) -> None:
        """THE coalesce rule, shared verbatim by the live ring and the
        offline fold so reconstruction is byte-exact: preserve the
        streak's first timestamp, SUM sidecar attributions (each is a
        distinct batch's wait), refresh everything else to the newest
        occurrence, bump ``repeats``."""
        if "first_ts" not in last:
            last["first_ts"] = last.get("ts")
        sidecar = None
        if "sidecar_wait_s" in last or "sidecar_wait_s" in occ:
            sidecar = last.get("sidecar_wait_s", 0.0) + occ.get(
                "sidecar_wait_s", 0.0
            )
        repeats = last.get("repeats", 1) + 1
        last.update(occ)
        if sidecar is not None:
            last["sidecar_wait_s"] = sidecar
        last["repeats"] = repeats

    def _note(
        self,
        gang: str,
        event: str,
        reason: str = "",
        coalesce: bool = False,
        **fields,
    ) -> None:
        occ = {"seq": 0, "ts": time.time(), "event": event, "reason": reason}
        ctx = current_context()
        if ctx is not None:
            occ["trace_id"] = ctx[0]
        observe = None
        with self._cond:
            rec = self._gangs.get(gang)
            if rec is None:
                ns = gang_namespace(gang)
                rec = {
                    "gang": gang,
                    "tenant": tenant_label(ns) if ns else "",
                    "tier": 0,
                    "events": deque(maxlen=self.per_gang),
                    "dropped_events": 0,
                    "arrival_ts": None,
                    "_last_aid": None,
                    "_evicted": False,
                }
                self._gangs[gang] = rec
                while len(self._gangs) > self.max_gangs:
                    self._gangs.popitem(last=False)
                    self.dropped_gangs += 1
            else:
                self._gangs.move_to_end(gang)
            if event == "arrival" and rec["arrival_ts"] is not None:
                # a repeat arrival: either the preemption path respawning
                # the gang (relabel; the ORIGINAL anchor stands, so TTP
                # includes the churn) or just the next member pod of the
                # same gang — both coalesce into a streak
                if rec["_evicted"]:
                    event = "respawn"
                    occ["event"] = event
                coalesce = True
            elif event == "evicted":
                rec["_evicted"] = True
            elif event == "bind":
                rec["_evicted"] = False
            aid = self._batch_aid
            if aid is not None:
                occ["audit_id"] = aid
                if rec["_last_aid"] != aid:
                    rec["_last_aid"] = aid
                    if self._batch_sidecar_s > 0.0:
                        occ["sidecar_wait_s"] = self._batch_sidecar_s
            occ.update(fields)
            if event == "arrival":
                if rec["arrival_ts"] is None:
                    rec["arrival_ts"] = occ["ts"]
                rec["tier"] = max(rec["tier"], int(fields.get("tier", 0)))
            ring = rec["events"]
            merged = False
            if coalesce and ring:
                target = None
                last = ring[-1]
                if (
                    last.get("event") == event
                    and last.get("reason") == reason
                ):
                    target = last
                elif (
                    len(ring) >= 2
                    and last.get("event") in _RETRY_CYCLE
                    and event in _RETRY_CYCLE
                    and ring[-2].get("event") == event
                    and ring[-2].get("reason") == reason
                ):
                    # the steady retry ping-pong (admitted<->deny, with
                    # member arrivals interleaved) ALTERNATES two events,
                    # which defeats last-entry coalescing: a parked gang
                    # retried every cycle would flood the bounded ring
                    # and churn its arrival/evicted records out. Merging
                    # one entry back keeps the whole wait at two ring
                    # slots; terminal events (permit/bind/evicted/delete)
                    # are never skipped over, so story boundaries hold
                    target = ring[-2]
                if target is not None:
                    occ["seq"] = target["seq"]
                    self._coalesce_into(target, occ)
                    merged = True
            if not merged:
                self._seq += 1
                occ["seq"] = self._seq
                if ring.maxlen is not None and len(ring) == ring.maxlen:
                    rec["dropped_events"] += 1
                ring.append(occ)
            if event == "bind" and not merged and rec["arrival_ts"] is not None:
                derived = self.derive(list(ring), arrival_ts=rec["arrival_ts"])
                derived["ttp_s"] = max(0.0, occ["ts"] - rec["arrival_ts"])
                observe = (rec["tenant"], str(rec["tier"]), derived)
            self._cursor += 1
            entry = dict(occ)
            entry["cursor"] = self._cursor
            entry["gang"] = gang
            if len(self._stream) == self._stream.maxlen:
                self.stream_dropped += 1
                stream_drop = True
            else:
                stream_drop = False
            self._stream.append(entry)
            self._cond.notify_all()
            audit = self._audit
            export_dir = self._export_dir
        # ---- everything below runs OUTSIDE the ledger lock ----
        self._events_counter.inc(event=event)
        if stream_drop:
            self._stream_dropped_counter.inc()
        if observe is not None:
            tenant, tier, derived = observe
            self._ttp_hist.observe(derived["ttp_s"], tenant=tenant, tier=tier)
            for phase, v in derived.get("phases", {}).items():
                self._phase_hist.observe(
                    v, phase=phase, tenant=tenant, tier=tier
                )
        if audit is not None:
            # the flat evidence record: the lifecycle event rides under
            # ``op`` (``event`` is the audit record's own kind tag)
            flat = {k: v for k, v in entry.items() if k not in ("cursor", "event")}
            flat["op"] = entry["event"]
            audit.record_event("gang_lifecycle", **flat)
        if export_dir is not None:
            self._export(export_dir, entry)

    def _export(self, dir_path: str, entry: dict) -> None:
        line = json.dumps(entry, sort_keys=True, default=str) + "\n"
        path = os.path.join(dir_path, "events.jsonl")
        try:
            with self._io_lock:
                if (
                    self._export_size > 0
                    and self._export_size + len(line) > _export_max_bytes()
                ):
                    os.replace(path, path + ".1")
                    self._export_size = 0
                with open(path, "a") as f:
                    f.write(line)
                self._export_size += len(line)
        except OSError:
            pass  # export is evidence, never a failure mode for scheduling

    # -- derivation (shared live/offline) ------------------------------------

    @staticmethod
    def derive(events: List[dict], arrival_ts: Optional[float] = None) -> dict:
        """Anchors + phase decomposition from an event list (live ring or
        offline fold — same math, so the live and the offline views
        agree). Phases: queue_wait (arrival→first scheduling attempt),
        schedule_wait (→last permit, net of sidecar_wait), sidecar_wait
        (summed TRACE_INFO attributions), bind_wait (permit→last bind);
        ttp_s = arrival→last bind."""

        def _first(kind: str) -> Optional[float]:
            for ev in events:
                if ev.get("event") == kind:
                    return float(ev.get("first_ts", ev.get("ts", 0.0)))
            return None

        def _last_ts(kind: str) -> Optional[float]:
            out = None
            for ev in events:
                if ev.get("event") == kind:
                    out = float(ev.get("ts", 0.0))
            return out

        arrival = arrival_ts if arrival_ts is not None else _first("arrival")
        admitted = _first("admitted")
        deny = _first("deny")
        sched = min(
            (t for t in (admitted, deny, _first("permit")) if t is not None),
            default=None,
        )
        permit = _last_ts("permit")
        bind = _last_ts("bind")
        sidecar = sum(float(ev.get("sidecar_wait_s", 0.0)) for ev in events)
        anchors = {
            "arrival": arrival, "sched": sched, "permit": permit, "bind": bind,
        }
        phases: Dict[str, float] = {}
        if arrival is not None and sched is not None:
            phases["queue_wait"] = max(0.0, sched - arrival)
        if sched is not None and permit is not None:
            phases["schedule_wait"] = max(0.0, permit - sched - sidecar)
            phases["sidecar_wait"] = sidecar
        if permit is not None and bind is not None:
            phases["bind_wait"] = max(0.0, bind - permit)
        out = {"anchors": anchors, "phases": phases}
        if arrival is not None and bind is not None:
            out["ttp_s"] = max(0.0, bind - arrival)
        return out

    @classmethod
    def fold(cls, records, per_gang: int = 64) -> "OrderedDict[str, dict]":
        """Reconstruct per-gang timelines from flat ``gang_lifecycle``
        records (audit events or exported JSONL lines), applying the SAME
        ring bound and coalesce rule as the live ledger — so a fold over
        the evidence chain is byte-identical to the live snapshot's
        ``events``. Accepts both shapes: audit
        records carry the lifecycle event under ``op``; export lines
        carry it under ``event``."""
        gangs: "OrderedDict[str, dict]" = OrderedDict()
        for r in records:
            if not isinstance(r, dict):
                continue
            gang = r.get("gang")
            seq = r.get("seq")
            kind = r.get("op") or r.get("event")
            if not gang or seq is None or kind in (None, "gang_lifecycle"):
                continue
            rec = gangs.get(gang)
            if rec is None:
                ns = gang_namespace(gang)
                rec = {
                    "gang": gang,
                    "tenant": tenant_label(ns) if ns else "",
                    "tier": 0,
                    "events": deque(maxlen=per_gang),
                    "dropped_events": 0,
                    "arrival_ts": None,
                }
                gangs[gang] = rec
            else:
                gangs.move_to_end(gang)
            occ = {
                k: v
                for k, v in r.items()
                if k not in ("kind", "op", "gang", "cursor", "_pub")
            }
            occ["event"] = kind
            if kind == "arrival":
                if rec["arrival_ts"] is None:
                    rec["arrival_ts"] = occ.get("ts")
                rec["tier"] = max(rec["tier"], int(occ.get("tier", 0) or 0))
            ring = rec["events"]
            # a record's seq names the entry it merged into live — the
            # retry ping-pong merges one entry BACK, so look at both
            if ring and ring[-1].get("seq") == seq:
                cls._coalesce_into(ring[-1], occ)
            elif len(ring) >= 2 and ring[-2].get("seq") == seq:
                cls._coalesce_into(ring[-2], occ)
            else:
                if ring.maxlen is not None and len(ring) == ring.maxlen:
                    rec["dropped_events"] += 1
                ring.append(occ)
        return gangs

    # -- read surfaces -------------------------------------------------------

    @staticmethod
    def timeline_view(rec: dict) -> dict:
        """One gang's JSON timeline: events + derived anchors/phases.
        Works on live records and on ``fold()`` output (the /debug/gangs
        payload and the offline CLI share it)."""
        events = [dict(e) for e in rec["events"]]
        view = {
            "gang": rec["gang"],
            "tenant": rec.get("tenant", ""),
            "tier": rec.get("tier", 0),
            "dropped_events": rec.get("dropped_events", 0),
            "events": events,
        }
        view.update(
            GangLifecycleLedger.derive(events, arrival_ts=rec.get("arrival_ts"))
        )
        return view

    def snapshot(
        self,
        gang: Optional[str] = None,
        tenant: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> dict:
        """The /debug/gangs payload: reconstructed timelines, optionally
        scoped to one gang or one tenant, capped to the ``limit`` most
        recently active gangs."""
        with self._cond:
            items = [
                (g, dict(rec, events=[dict(e) for e in rec["events"]]))
                for g, rec in self._gangs.items()
                if (gang is None or g == gang)
                and (tenant is None or rec.get("tenant") == tenant)
            ]
            dropped = self.dropped_gangs
        if limit is not None and limit >= 0:
            items = items[-limit:] if limit else []
        out = OrderedDict()
        for g, rec in items:
            rec.pop("_last_aid", None)
            out[g] = self.timeline_view(rec)
        return {"gangs": out, "count": len(out), "dropped_gangs": dropped}

    def events_since(
        self, cursor: int, limit: int = 256, timeout_s: float = 0.0
    ) -> dict:
        """The /debug/events long-poll: occurrences with cursor >
        ``cursor`` (monotonic, never reused; a coalesced bump gets a NEW
        cursor but keeps its event's stable ``seq``). Blocks up to the
        (clamped) timeout when nothing is newer — push-shaped consumption
        without a persistent connection. ``dropped`` counts occurrences
        the ring evicted before this cursor could read them."""
        timeout_s = max(0.0, min(float(timeout_s), 30.0))
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._cursor <= cursor:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            avail = [dict(e) for e in self._stream if e["cursor"] > cursor]
            tip = self._cursor
            oldest = self._stream[0]["cursor"] if self._stream else tip + 1
        dropped = max(0, (oldest - 1) - cursor) if cursor < oldest - 1 else 0
        evs = avail[: max(0, int(limit))]
        if evs:
            new_cursor = evs[-1]["cursor"]
        elif avail:
            new_cursor = cursor  # limit=0 must not silently skip events
        else:
            new_cursor = max(cursor, tip)
        return {"events": evs, "cursor": new_cursor, "dropped": dropped}

    def report(self) -> dict:
        """Per-tenant p99 TTP (tier series merged) — the health
        payload's summary."""
        snaps = self._ttp_hist.snapshots()
        buckets = self._ttp_hist.buckets
        tenants: Dict[str, dict] = {}
        for key, (counts, total, n) in snaps.items():
            labels = dict(key)
            t = labels.get("tenant", "")
            agg = tenants.setdefault(
                t, {"counts": [0] * len(buckets), "sum": 0.0, "count": 0}
            )
            agg["counts"] = [a + b for a, b in zip(agg["counts"], counts)]
            agg["sum"] += total
            agg["count"] += n
        out = {}
        for t, agg in sorted(tenants.items()):
            out[t or "-"] = {
                "p99_ttp_s": _quantile_from_counts(
                    buckets, agg["counts"], agg["count"], 0.99
                ),
                "count": agg["count"],
                "mean_s": (agg["sum"] / agg["count"]) if agg["count"] else 0.0,
            }
        with self._cond:
            gangs = len(self._gangs)
        return {"tenants": out, "gangs": gangs}

    def reset(self) -> None:
        """Clean-slate for a new run (ScheduleOperation construction):
        drops records, stream, cursors, batch context AND sinks — a new
        run re-attaches its own audit/export."""
        with self._cond:
            self._gangs.clear()
            self._stream.clear()
            self._cursor = 0
            self._seq = 0
            self.dropped_gangs = 0
            self.stream_dropped = 0
            self._batch_aid = None
            self._batch_sidecar_s = 0.0
            self._audit = None
            self._export_dir = None
            self._cond.notify_all()
        with self._io_lock:
            self._export_size = 0


DEFAULT_LEDGER = GangLifecycleLedger()
