"""Batch audit log: the scheduler's black-box flight data.

Every published oracle batch is written to a bounded on-disk ring as an
audit record — the packed ``[N,R]``/``[G,R]`` host buffers, bucket shape,
gang queue order, config fingerprint, and the resulting **plan digest** —
so any batch inside the retention window can be reconstructed bit-exactly
and replayed (``core.oracle_scorer.replay_audit_record``).

The port of ``batch_scheduler_tpu/utils/audit.py``. The ring is the one
on-disk contract the two packages share: the record JSON is the
reference's key for key, so each package's :class:`AuditReader` reads the
other package's rings, and a ring recorded on the card replays in the JAX
package (and one recorded there replays here) with the same
``plan_digest``.

Cost discipline:

- recording is OFF unless an :class:`AuditLog` is configured; the
  disabled path is one ``is not None`` check in the scorer's publish;
- the hot path only computes a sha256 over the O(G) result vectors and
  enqueues ARRAY REFERENCES. They must stay what was scored until the
  writer has serialized them: a published ClusterSnapshot's arrays are
  copies the packer no longer mutates (ops.snapshot), and the host dict's
  vectors own their memory or hold the blob's pinned storage
  (ops.oracle.collect_batch), which is not reused while they live.
  JSON/base64 serialization, delta diffing and disk I/O all happen on a
  daemon writer thread;
- records are **delta-packed** like the snapshot packer that produced
  them (ops.snapshot.DeltaSnapshotPacker): a keyframe record carries the
  full arrays, subsequent records carry only the churned rows of the big
  ``[N,R]``/``[G,R]`` lane arrays (diffed here against the previously
  recorded arrays — the audit validates what was actually SCORED), and any
  shape/name change forces a fresh keyframe.

The scorer stamps each record's ``refresh`` field with the pack's
provenance (generation, pack kind, keyframe reason, source ``scan`` or
``events``, churned row indices), while the row deltas are still DIFFED
here, never trusted from the packer.

Ring discipline: records append to ``audit-<seq>.jsonl`` segment files;
when a segment exceeds ``_SEGMENT_BYTES`` a new one starts, and oldest
segments are deleted once the directory exceeds ``cap_bytes``. The reader
recovers from a rotated-away keyframe by skipping delta records (reported
as unreconstructable, never a crash) until the next keyframe.

Format ``v2`` records the event stream instead of array deltas: batches
whose snapshot came from a ``pack_fold`` are written as ``event_batch``
records — the drained, name-coalesced (names, bumps) event batch, a
compact result (assignment arrays omitted; the digest still covers them)
and an ``input_digest`` over the exact padded inputs — while every
non-fold refresh and every ``keyframe_every``-th record stays a full
array keyframe that also carries the snapshot-lite re-fold base (lane
schema + per-gang demand fingerprints). The reader re-folds event records
through a real DeltaSnapshotPacker primed from the nearest keyframe and
bit-checks each step against the recorded ``input_digest``.

A policy batch's record also carries its packed policy columns
(``POLICY_ARG_NAMES``, through the same keyframe/delta machinery) and its
``policy`` terms and weights; the reader hands them to replay as
``policy_args``.

The format and the chain length are the constructor's ``fmt=`` /
``keyframe_every=``, which default to the ``BST_AUDIT_FORMAT`` /
``BST_AUDIT_KEYFRAME_EVERY`` readers (``audit_format``,
``audit_keyframe_every``), as the reference's do.
"""

from __future__ import annotations

import base64
import glob
import hashlib
import json
import os
import queue
import sys
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import __version__
from ..ops.lanes import CORE_LANES, LaneSchema
from ..ops.oracle import _scan_wave_from_env
from ..ops.snapshot import DeltaSnapshotPacker, GroupDemand
from ..policy.engine import active_fingerprint
from .metrics import DEFAULT_REGISTRY
from .trace import new_trace_id

__all__ = [
    "AuditLog",
    "AuditReader",
    "audit_format",
    "audit_keyframe_every",
    "new_audit_id",
    "plan_digest",
    "canonical_plan",
    "config_fingerprint",
    "divergence_report",
    "input_digest",
    "ring_stats",
    "PLAN_FIELDS",
    "BATCH_ARG_NAMES",
    "PROGRESS_ARG_NAMES",
    "POLICY_ARG_NAMES",
    "EVENT_RESULT_FIELDS",
]

# the plan fields the digest covers, in canonical order — everything a
# whole-gang plan is stamped from plus the max-progress selection
PLAN_FIELDS = (
    "placed",
    "gang_feasible",
    "progress",
    "best",
    "best_exists",
    "assignment_nodes",
    "assignment_counts",
)

# ops.snapshot.ClusterSnapshot.device_args() / progress_args() order
BATCH_ARG_NAMES = (
    "alloc", "requested", "group_req", "remaining", "fit_mask",
    "group_valid", "order",
)
PROGRESS_ARG_NAMES = (
    "min_member", "scheduled", "matched", "ineligible", "creation_rank",
)

# Packed policy columns (ops.snapshot.ClusterSnapshot.policy_cols), present
# only in records of policy batches. They ride the same keyframe/delta
# machinery as the batch args, so a policy record replays with its exact
# composite inputs.
POLICY_ARG_NAMES = (
    "policy_prio", "policy_aff", "policy_anti", "policy_gang_dom",
    "policy_node_hash", "policy_node_dom",
)

# the big lane arrays worth delta-packing; everything else is O(G) or a
# broadcast row and rides full in every record. The 2-D policy columns
# delta-pack the same way; absent keys are skipped per record.
_DELTA_ARRAYS = (
    "alloc", "requested", "group_req", "policy_gang_dom",
    "policy_node_hash",
)

_BOOL_ARRAYS = ("fit_mask", "group_valid", "ineligible", "placed",
                "gang_feasible")

# the plan fields an event_batch record carries inline. The [G,K]
# assignment arrays dominate record size and are already covered by the
# recorded plan_digest, so v2 omits them: replay recomputes the plan from
# re-folded inputs and the digest bit-checks assignments too.
EVENT_RESULT_FIELDS = ("placed", "gang_feasible", "progress", "best",
                       "best_exists")


_FORMAT_ENV = "BST_AUDIT_FORMAT"
_format_warned = [False]


def audit_format() -> str:
    """Parse-guarded ``BST_AUDIT_FORMAT`` read: ``array`` (default) keeps
    the keyframe+row-delta ARRAY records; ``v2`` records the event stream
    itself between periodic array keyframes. Unrecognized values warn once
    to stderr and keep the default — a typo must degrade the ring format,
    never crash the scheduler."""
    raw = os.environ.get(_FORMAT_ENV, "").strip().lower()
    if raw in ("", "array", "v1"):
        return "array"
    if raw == "v2":
        return "v2"
    if not _format_warned[0]:
        _format_warned[0] = True
        print(
            f"ignoring unrecognized {_FORMAT_ENV}={raw!r} "
            "(expected 'array' or 'v2'); audit format stays 'array'",
            file=sys.stderr,
        )
    return "array"


_KEYFRAME_ENV = "BST_AUDIT_KEYFRAME_EVERY"
_KEYFRAME_DEFAULT = 16
_keyframe_warned = [False]


def audit_keyframe_every() -> int:
    """Parse-guarded ``BST_AUDIT_KEYFRAME_EVERY`` read: the audit chain
    length — every Nth batch record is a full array keyframe (delta or
    event records ride between). Non-integer values warn once and keep
    the default; values below 1 clamp to 1 (every record full)."""
    raw = os.environ.get(_KEYFRAME_ENV, "").strip()
    if not raw:
        return _KEYFRAME_DEFAULT
    try:
        return max(int(raw), 1)
    except ValueError:
        if not _keyframe_warned[0]:
            _keyframe_warned[0] = True
            print(
                f"ignoring non-integer {_KEYFRAME_ENV}={raw!r}; "
                f"keyframe cadence stays {_KEYFRAME_DEFAULT}",
                file=sys.stderr,
            )
        return _KEYFRAME_DEFAULT


def input_digest(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over the canonical batch+progress input arrays in argument
    order — the v2 bit-identity token for INPUTS (plan_digest covers
    outputs): recorded on every v2 batch record, recomputed after each
    reader-side re-fold, so a divergent event stream is localized to the
    exact first differing event batch."""
    h = hashlib.sha256()
    for name in BATCH_ARG_NAMES + PROGRESS_ARG_NAMES:
        a = np.asarray(arrays[name])
        if a.dtype == bool:
            a = np.ascontiguousarray(a, dtype=np.uint8)
        else:
            a = np.ascontiguousarray(a, dtype="<i4")
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _fp_payload(fp) -> list:
    """JSON form of an ops.snapshot._demand_fp tuple — the per-gang
    demand state a v2 record carries (group updates in event records,
    the full roster in keyframe re-fold bases). The tuple round-trips
    exactly: sorted member-request items stay sorted through a dict,
    and JSON preserves float creation_ts bit-for-bit."""
    return [
        [[str(k), int(v)] for k, v in fp[0]],
        int(fp[1]), int(fp[2]), int(fp[3]), int(fp[4]), float(fp[5]),
        bool(fp[6]), bool(fp[7]),
    ]


def _fp_from_payload(p) -> tuple:
    return (
        tuple((str(k), int(v)) for k, v in p[0]),
        int(p[1]), int(p[2]), int(p[3]), int(p[4]), float(p[5]),
        bool(p[6]), bool(p[7]),
    )


def _demand_from_fp(full_name: str, fp: tuple) -> GroupDemand:
    """A GroupDemand whose _demand_fp reproduces ``fp`` exactly — the
    reader-side reconstruction of a recorded gang, complete for every
    field the fold path reads (selector/toleration-bearing gangs bail
    the live fold, so they never reach an event record)."""
    return GroupDemand(
        full_name=full_name,
        min_member=fp[1],
        scheduled=fp[2],
        matched=fp[3],
        priority=fp[4],
        creation_ts=fp[5],
        member_request=dict(fp[0]),
        released=fp[6],
        has_pod=fp[7],
    )


# Segment rotation size — also the keyframe blast radius: a deleted
# segment loses at most its own records plus the delta tail that depended
# on its last keyframe.
_SEGMENT_BYTES = 8 * 1024 * 1024
# The writer queue's bound: a full queue drops the record (counted), so
# auditing never applies backpressure to scheduling.
_QUEUE_MAX = 64

# every live AuditLog, for ring_stats — weak so a dropped log disappears
# from the report instead of leaking
_ACTIVE_LOGS: "weakref.WeakSet[AuditLog]" = weakref.WeakSet()


def ring_stats() -> List[dict]:
    """Per-ring telemetry for every live AuditLog: on-disk ring size,
    record/byte counts by kind, and the bytes-per-record readout."""
    out = []
    for log in sorted(_ACTIVE_LOGS, key=lambda l: l.directory):
        written = log.records_written
        by_kind = {}
        for kind, count in sorted(log.kind_counts.items()):
            kbytes = log.kind_bytes.get(kind, 0)
            by_kind[kind] = {
                "records": count,
                "bytes": kbytes,
                "bytes_per_record": round(kbytes / count, 1) if count else 0.0,
            }
        out.append({
            "dir": log.directory,
            "format": log.fmt,
            "ring_bytes": log.ring_bytes,
            "records_written": written,
            "records_dropped": log.records_dropped,
            "bytes_written": log.bytes_written,
            "bytes_per_record": (
                round(log.bytes_written / written, 1) if written else 0.0
            ),
            "by_kind": by_kind,
        })
    return out


def new_audit_id() -> str:
    """16 lowercase hex chars — the trace-id contract (utils.trace), so an
    audit record and its identity audit correlate by one kind of id."""
    return new_trace_id()


def _canon(field: str, v) -> np.ndarray:
    """Canonical array form of one plan field — the SINGLE definition both
    the digest and the divergence compare use, so a dtype drift between
    record and replay can never masquerade as a plan divergence."""
    if field in ("placed", "gang_feasible", "best_exists"):
        return np.ascontiguousarray(np.asarray(v), dtype=np.uint8)
    return np.ascontiguousarray(np.asarray(v), dtype="<i4")


def canonical_plan(host: dict) -> Dict[str, np.ndarray]:
    """The canonical plan-field arrays of one batch result. Beyond dtype
    canonicalization, ``assignment_nodes`` entries in ZERO-COUNT slots are
    masked to 0: those indexes are top-k backfill with no semantic content
    (the reference's sidecar zeroes them for wire clients), so a plan and
    its replay never differ on semantically dead slots."""
    out = {f: _canon(f, host[f]) for f in PLAN_FIELDS}
    nodes, counts = out["assignment_nodes"], out["assignment_counts"]
    if nodes.shape == counts.shape:
        out["assignment_nodes"] = np.where(counts > 0, nodes, 0)
    return out


def plan_digest(host: dict) -> str:
    """sha256 over the canonical plan fields of one batch result. THE
    bit-identity token: recorded at publish, recomputed at replay, and
    compared by the in-production identity audit (utils.health), equal in
    both packages for the same plan."""
    h = hashlib.sha256()
    plan = canonical_plan(host)
    for field in PLAN_FIELDS:
        a = plan[field]
        h.update(field.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def config_fingerprint(device=None) -> dict:
    """The execution-relevant configuration a replay must know to explain a
    divergence: the backend (``cuda`` or ``cpu``: ``device``'s type, or
    this process's default — ``cuda`` when a card is present), the card
    count and name, the live ``BST_SCAN_WAVE`` rung, the active policy
    engine's config (``policy``, the reference's key; absent when no
    enabled engine exists) and the package version. Returned as the dict
    itself with a ``fingerprint`` sha over it, so the blame report can show
    WHICH entry differed. The reference's ``pallas`` and ``donate`` entries
    have no counterpart in the port."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    cfg: Dict[str, object] = {
        "backend": dev.type,
        "devices": torch.cuda.device_count(),
        "device_name": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        ),
        "scan_wave": _scan_wave_from_env(),
        "version": __version__,
    }
    policy = active_fingerprint()
    if policy is not None:
        cfg["policy"] = policy
    digest = hashlib.sha256(
        json.dumps(cfg, sort_keys=True, default=str).encode()
    ).hexdigest()
    cfg["fingerprint"] = digest[:16]
    return cfg


def divergence_report(
    recorded: dict,
    replayed: dict,
    *,
    node_names: Optional[List[str]] = None,
    group_names: Optional[List[str]] = None,
    context: Optional[dict] = None,
) -> Optional[dict]:
    """Structured blame for a digest mismatch: the first differing plan
    field, the first differing gang (named when the record kept names) and
    node, with both values. Returns None when the plans are bit-identical
    field by field (a digest mismatch with no field divergence means the
    record itself is damaged — reported as field="<record>")."""
    rec_plan = canonical_plan(recorded)
    rep_plan = canonical_plan(replayed)
    for field in PLAN_FIELDS:
        a = rec_plan[field]
        b = rep_plan[field]
        if a.shape != b.shape:
            return {
                "field": field,
                "reason": "shape mismatch",
                "recorded_shape": list(a.shape),
                "replayed_shape": list(b.shape),
                **(context or {}),
            }
        if np.array_equal(a, b):
            continue
        diff = np.argwhere(a != b)
        first = diff[0]
        rep: Dict[str, object] = {
            "field": field,
            "differing_elements": int(diff.shape[0]),
            "recorded": int(a[tuple(first)]),
            "replayed": int(b[tuple(first)]),
        }
        if a.ndim >= 1 and a.shape and field != "best":
            g = int(first[0])
            rep["gang_index"] = g
            # an EMPTY name list means the recorder had no names, not that
            # every index is padding — blame by index only in that case
            if group_names and g < len(group_names):
                rep["gang"] = group_names[g]
            elif group_names:
                rep["gang"] = "(pad)"
        if field in ("assignment_nodes", "assignment_counts") and a.ndim == 2:
            k = int(first[1])
            rep["slot"] = k
            node_idx = int(rec_plan["assignment_nodes"][first[0], k])
            rep["node_index"] = node_idx
            if node_names and node_idx < len(node_names):
                rep["node"] = node_names[node_idx]
        rep.update(context or {})
        return rep
    return None


# ---------------------------------------------------------------------------
# array (de)serialization
# ---------------------------------------------------------------------------


def _enc(arr: np.ndarray) -> dict:
    a = np.asarray(arr)
    if a.dtype == bool:
        payload = np.ascontiguousarray(a, dtype=np.uint8)
        return {"d": "bool", "s": list(a.shape),
                "z": base64.b64encode(payload.tobytes()).decode("ascii")}
    payload = np.ascontiguousarray(a, dtype="<i4")
    return {"d": "<i4", "s": list(a.shape),
            "z": base64.b64encode(payload.tobytes()).decode("ascii")}


def _dec(spec: dict) -> np.ndarray:
    raw = base64.b64decode(spec["z"])
    if spec["d"] == "bool":
        return np.frombuffer(raw, dtype=np.uint8).reshape(spec["s"]).astype(bool)
    return np.frombuffer(raw, dtype="<i4").reshape(spec["s"]).copy()


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


class AuditLog:
    """Bounded on-disk ring of audit records, written off the hot path.

    ``record_batch`` is the only hot-path call: it builds a small dict of
    array REFERENCES and enqueues it (bounded queue; a full queue drops the
    record and counts it — auditing must never apply backpressure to
    scheduling). The daemon writer serializes (keyframe, row-delta or
    event record), appends JSON lines to the current segment, rotates
    segments at ``_SEGMENT_BYTES``, and deletes oldest segments past
    ``cap_bytes``.

    Retention: ``cap_bytes`` (total ring size), ``keyframe_every``
    (delta/event chain length; 1 = every record full; None reads
    ``BST_AUDIT_KEYFRAME_EVERY``), ``fmt`` (``array`` or ``v2``; None reads
    ``BST_AUDIT_FORMAT``).
    """

    def __init__(
        self,
        directory: str,
        cap_bytes: int = 256 * 1024 * 1024,
        keyframe_every: Optional[int] = None,
        fmt: Optional[str] = None,
    ):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.cap_bytes = max(int(cap_bytes), 1)
        self.segment_bytes = _SEGMENT_BYTES
        self.keyframe_every = (
            audit_keyframe_every() if keyframe_every is None
            else max(int(keyframe_every), 1)
        )
        if fmt is None:
            fmt = audit_format()
        if fmt not in ("array", "v2"):
            raise ValueError(f"unknown audit format {fmt!r}")
        self.fmt = fmt
        self._q: "queue.Queue" = queue.Queue(maxsize=_QUEUE_MAX)
        # resume the seq counter past an existing ring: a restarted
        # process appending to the same directory must not mint duplicate
        # seqs (replay selects records by seq)
        self._seq = self._last_seq_on_disk()
        self._since_keyframe = 0
        self._prev: Optional[Dict[str, np.ndarray]] = None
        self._prev_names: Optional[tuple] = None
        self._segment_path: Optional[str] = None
        self._segment_size = 0
        self._segment_index = self._next_segment_index()
        self.records_written = 0
        self.records_dropped = 0
        self.write_errors = 0
        self.bytes_written = 0
        self.ring_bytes = self._scan_ring_bytes()
        self.kind_counts: Dict[str, int] = {}
        self.kind_bytes: Dict[str, int] = {}
        # publish-order counter (hot path) vs last id serialized (writer
        # thread): a queue-full drop consumes an id, so the writer sees a
        # gap and knows the on-disk chain is missing a fold step — the
        # next v2 record must re-keyframe rather than ride as an event
        self._pub = 0
        self._last_pub = 0
        # the pack generation of the last record serialized (the scorer's
        # ``refresh`` stamp): a fold whose generation does not follow it
        # has an unrecorded pack before it (the log was detached for a
        # refresh, or another scorer shares the log), so it must
        # re-keyframe too — the reference writer misses this case
        self._last_gen: Optional[int] = None
        # True while the on-disk v2 chain is rooted at a keyframe that
        # carries a re-fold base; a keyframe without one (non-lite pack)
        # forces the next fold record to keyframe too
        self._refold_chain = False
        self._config = None  # computed on the writer thread at keyframes
        self._written_counter = DEFAULT_REGISTRY.counter(
            "bst_audit_records_total",
            "Audit records by record kind and outcome "
            "(written / dropped on a full queue)",
        )
        self._ring_gauge = DEFAULT_REGISTRY.gauge(
            "bst_audit_ring_bytes",
            "On-disk audit ring size in bytes, labeled by ring directory",
        )
        self._ring_gauge.set(float(self.ring_bytes), ring=self.directory)
        _ACTIVE_LOGS.add(self)
        self._thread = threading.Thread(
            target=self._loop, name="audit-writer", daemon=True
        )
        self._thread.start()

    # -- hot path ------------------------------------------------------------

    def record_batch(
        self,
        *,
        batch_args: tuple,
        progress_args: tuple,
        result: dict,
        plan_digest: str,
        node_names: Optional[List[str]] = None,
        group_names: Optional[List[str]] = None,
        audit_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        telemetry: Optional[dict] = None,
        extra: Optional[dict] = None,
        policy=None,
        event_fold: Optional[dict] = None,
        refold=None,
        degraded: bool = False,
        speculative: bool = False,
    ) -> str:
        """Enqueue one batch record; returns its audit ID. Array arguments
        are held BY REFERENCE — callers pass published (immutable)
        snapshot/result arrays only (host numpy, never a device tensor).
        ``policy`` is the batch's ``(policy_cols, terms, weights)`` payload
        when it ran the policy scan: recorded so replay re-executes the
        exact composite.

        v2 payloads (both ignored under the array format): ``event_fold``
        is the drained event batch this snapshot was folded from
        (``{"bumps", "nodes": [(name, req_dict)...], "groups":
        [(full_name, demand_fp)...]}``, stashed by the scorer's
        ``_try_fold``); ``refold`` is the snapshot-lite re-fold base
        ``(schema, demand_fps)`` a keyframe must carry for later event
        records to reconstruct from.

        ``degraded`` marks a remote scorer's conservative fallback batch
        (replay skips it: it has no device plan); ``speculative`` a batch
        the dispatch-ahead path published."""
        aid = audit_id or new_audit_id()
        item = {
            "kind": "batch",
            "audit_id": aid,
            "ts": time.time(),
            "trace_id": trace_id,
            "speculative": bool(speculative),
            "degraded": bool(degraded),
            "telemetry": telemetry or {},
            "plan_digest": plan_digest,
            "_arrays": dict(zip(BATCH_ARG_NAMES, batch_args))
            | dict(zip(PROGRESS_ARG_NAMES, progress_args)),
            "_result": {k: result[k] for k in PLAN_FIELDS},
            "_names": (list(node_names or []), list(group_names or [])),
        }
        if policy is not None:
            cols, terms, weights = policy
            item["_arrays"] |= dict(zip(POLICY_ARG_NAMES, cols))
            item["policy"] = {"terms": list(terms), "weights": list(weights)}
        if extra:
            item.update(extra)
        if self.fmt == "v2":
            item["_event_fold"] = event_fold
            item["_refold"] = refold
            self._pub += 1
            item["_pub"] = self._pub
        self._enqueue(item)
        return aid

    def record_event(self, event: str, **fields) -> None:
        """A non-batch evidence record (e.g. an identity-audit mismatch
        flag) appended to the same ring, correlated by audit_id."""
        self._enqueue({"kind": "event", "event": event, "ts": time.time(),
                       **fields})

    def _enqueue(self, item: dict) -> None:
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self.records_dropped += 1
            self._written_counter.inc(
                outcome="dropped", kind=item.get("kind", "batch")
            )

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout: float = 30.0) -> bool:
        """Block up to ``timeout`` until every enqueued record is on disk.
        NEVER blocks past the timeout: a wedged writer (hung disk) makes
        this return False, not hang — auditing must not be able to block
        shutdown any more than it can block scheduling."""
        deadline = time.monotonic() + timeout
        while not self._q.empty():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        # one extra tick: the writer may still be serializing the last item
        done = threading.Event()
        try:
            self._q.put_nowait({"kind": "_sync", "_event": done})
        except queue.Full:
            return False  # writer wedged with a refilled queue
        return done.wait(max(deadline - time.monotonic(), 0.1))

    def stop(self, timeout: float = 10.0) -> bool:
        self.flush(timeout)
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # wedged writer: the join below times out -> False
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stats(self) -> dict:
        return {
            "audit_records": self.records_written,
            "audit_dropped": self.records_dropped,
            "audit_write_errors": self.write_errors,
            "audit_bytes": self.bytes_written,
            "audit_ring_bytes": self.ring_bytes,
            "audit_format": self.fmt,
            "audit_dir": self.directory,
        }

    # -- writer thread -------------------------------------------------------

    def _next_segment_index(self) -> int:
        existing = sorted(glob.glob(os.path.join(self.directory, "audit-*.jsonl")))
        if not existing:
            return 0
        try:
            return int(os.path.basename(existing[-1])[6:-6]) + 1
        except ValueError:
            return len(existing)

    def _last_seq_on_disk(self) -> int:
        """Highest record seq already in the ring (0 for a fresh one).
        Scans segments newest-first and stops at the first that carries
        any seq, so resuming on a large ring reads one segment, not all."""
        for path in sorted(
            glob.glob(os.path.join(self.directory, "audit-*.jsonl")),
            reverse=True,
        ):
            best = 0
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            seq = json.loads(line).get("seq")
                        except ValueError:
                            continue
                        if isinstance(seq, int):
                            best = max(best, seq)
            except OSError:
                continue
            if best:
                return best
        return 0

    def _scan_ring_bytes(self) -> int:
        total = 0
        for path in glob.glob(os.path.join(self.directory, "audit-*.jsonl")):
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if item.get("kind") == "_sync":
                item["_event"].set()
                continue
            try:
                line = self._serialize(item)
                self._append(line)
                self.records_written += 1
                # kind AFTER serialization: a v2 batch item resolves to
                # "batch" (keyframe) or "event_batch" there
                kind = item.get("kind", "batch")
                self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
                self.kind_bytes[kind] = (
                    self.kind_bytes.get(kind, 0) + len(line) + 1
                )
                self._written_counter.inc(outcome="written", kind=kind)
            except Exception:  # noqa: BLE001 — auditing must never crash serving
                self.write_errors += 1
                # _serialize may have advanced _prev before the append
                # failed: the failed record is NOT on disk, so diffing the
                # next record against it would make the reader reconstruct
                # WRONG inputs (stale rows applied as if current). Drop the
                # delta chain — the next record is forced to be a keyframe.
                self._prev = None

    def _serialize(self, item: dict) -> str:
        if item["kind"] != "batch":
            return json.dumps(item, default=str, sort_keys=True)
        arrays: Dict[str, np.ndarray] = item.pop("_arrays")
        result: Dict[str, np.ndarray] = item.pop("_result")
        names = item.pop("_names")
        ev = item.pop("_event_fold", None)
        refold = item.pop("_refold", None)
        pub = item.pop("_pub", 0)
        self._seq += 1
        item["seq"] = self._seq
        item["shape"] = {
            "n_bucket": int(np.asarray(arrays["alloc"]).shape[0]),
            "g_bucket": int(np.asarray(arrays["group_req"]).shape[0]),
            "lanes": int(np.asarray(arrays["alloc"]).shape[1]),
            "mask_rows": int(np.asarray(arrays["fit_mask"]).shape[0]),
        }
        snap = {k: np.asarray(v) for k, v in arrays.items()}
        names_t = (tuple(names[0]), tuple(names[1]))
        if self.fmt == "v2":
            line = self._serialize_v2(
                item, snap, names, names_t, result, ev, refold, pub
            )
            self._prev = snap
            self._prev_names = names_t
            return line
        keyframe = (
            self._prev is None
            or self._since_keyframe >= self.keyframe_every - 1
            or self._prev_names != names_t
            # a policy flip mid-run changes the array SET: a keyframe keeps
            # the reader's rolling state from carrying stale policy columns
            or set(self._prev) != set(snap)
            or any(self._prev[k].shape != snap[k].shape for k in snap)
        )
        if keyframe:
            # the config fingerprint is re-taken per KEYFRAME, on the
            # device the batch ran on: a change of the scan rung mid-run
            # shows up in later records' config. Delta records inherit
            # their keyframe's fingerprint.
            self._config = config_fingerprint(item["telemetry"].get("device"))
            item["keyframe"] = True
            item["names"] = {"nodes": names[0], "groups": names[1]}
            item["arrays"] = {k: _enc(v) for k, v in snap.items()}
            self._since_keyframe = 0
        else:
            # churned rows of the big lane arrays only, diffed against the
            # last RECORDED arrays so the log always reconstructs to
            # exactly what was scored
            item["keyframe"] = False
            deltas = {}
            for k in _DELTA_ARRAYS:
                if k not in snap:
                    continue
                changed = np.flatnonzero((snap[k] != self._prev[k]).any(axis=1))
                if changed.size:
                    deltas[k] = {
                        "rows": [int(r) for r in changed],
                        "data": _enc(snap[k][changed]),
                    }
            item["deltas"] = deltas
            item["arrays"] = {
                k: _enc(v) for k, v in snap.items() if k not in _DELTA_ARRAYS
            }
            self._since_keyframe += 1
        self._prev = snap
        self._prev_names = names_t
        item["config"] = self._config  # set at this (or an earlier) keyframe
        item["result"] = {
            k: _enc(v) for k, v in canonical_plan(result).items()
        }
        return json.dumps(item, default=str, sort_keys=True)

    def _serialize_v2(
        self, item, snap, names, names_t, result, ev, refold, pub
    ) -> str:
        """v2 record: an ``event_batch`` (the drained event batch this
        snapshot was folded from, a compact result, and the input digest)
        when the fold chain is intact, else a full array keyframe that
        also carries the snapshot-lite re-fold base. Every record carries
        ``input_digest`` so the reader can bit-check each re-fold step."""
        # a queue-full drop consumed a publish id without reaching disk:
        # contiguity broken means the recorded event stream is missing a
        # fold step, so the next record must re-anchor with full arrays
        gen = (item.get("refresh") or {}).get("generation")
        contiguous = pub == self._last_pub + 1 and (
            gen is None or (self._last_gen is not None and gen == self._last_gen + 1)
        )
        self._last_pub = pub
        self._last_gen = gen
        use_event = (
            ev is not None
            and contiguous
            and self._refold_chain
            and self._prev is not None
            and self._since_keyframe < self.keyframe_every - 1
            and self._prev_names == names_t
            and set(self._prev) == set(snap)
            and all(self._prev[k].shape == snap[k].shape for k in snap)
        )
        item["input_digest"] = input_digest(snap)
        plan = canonical_plan(result)
        if use_event:
            item["kind"] = "event_batch"
            item["keyframe"] = False
            item["events"] = {
                "bumps": int(ev.get("bumps", 0)),
                "nodes": [
                    [str(nm), {str(k): int(v) for k, v in d.items()}]
                    for nm, d in ev.get("nodes", ())
                ],
                "groups": [
                    [str(nm), _fp_payload(fp)]
                    for nm, fp in ev.get("groups", ())
                ],
            }
            item["result"] = {
                k: _enc(v) for k, v in plan.items()
                if k in EVENT_RESULT_FIELDS
            }
            self._since_keyframe += 1
        else:
            self._config = config_fingerprint(item["telemetry"].get("device"))
            item["keyframe"] = True
            item["names"] = {"nodes": names[0], "groups": names[1]}
            item["arrays"] = {k: _enc(v) for k, v in snap.items()}
            item["result"] = {k: _enc(v) for k, v in plan.items()}
            if refold is not None:
                schema, fps = refold
                item["lite"] = {
                    "schema": {
                        "names": list(schema.names),
                        "shifts": list(schema.shifts),
                    },
                    "fps": [_fp_payload(fp) for fp in fps],
                }
            self._since_keyframe = 0
            self._refold_chain = refold is not None
        item["config"] = self._config
        return json.dumps(item, default=str, sort_keys=True)

    def _append(self, line: str) -> None:
        data = line + "\n"
        rotated = (
            self._segment_path is None
            or self._segment_size + len(data) > self.segment_bytes
        )
        if rotated:
            self._segment_path = os.path.join(
                self.directory, f"audit-{self._segment_index:08d}.jsonl"
            )
            self._segment_index += 1
            self._segment_size = 0
        with open(self._segment_path, "a") as f:
            f.write(data)
        self._segment_size += len(data)
        self.bytes_written += len(data)
        self.ring_bytes += len(data)
        self._ring_gauge.set(float(self.ring_bytes), ring=self.directory)
        # cap enforcement on ROTATION only: the cap can only newly be
        # exceeded as segments grow, and a glob+stat of every segment per
        # append would be pure writer-thread overhead for a lag of at most
        # one segment's worth
        if rotated:
            self._enforce_cap()

    def _enforce_cap(self) -> None:
        segments = sorted(glob.glob(os.path.join(self.directory, "audit-*.jsonl")))
        sizes = []
        for path in segments:
            try:
                sizes.append((path, os.path.getsize(path)))
            except OSError:
                sizes.append((path, 0))
        total = sum(s for _, s in sizes)
        # delete oldest-first, never the segment currently being written
        for path, size in sizes[:-1]:
            if total <= self.cap_bytes:
                break
            try:
                os.remove(path)
                total -= size
            except OSError:
                pass
        # the glob+stat pass is authoritative: resync the incremental
        # ring-size counter (and its gauge) here rather than trusting
        # per-append arithmetic across deletions
        self.ring_bytes = total
        self._ring_gauge.set(float(total), ring=self.directory)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


class AuditReader:
    """Iterate an audit directory's records oldest-first, materializing the
    full input arrays per batch (applying row deltas onto the rolling
    state). Delta records whose keyframe rotated out of the ring are
    yielded as ``{"kind": "unreconstructable", ...}`` — the ring losing
    its head is expected behavior, not corruption — and reconstruction
    resumes at the next keyframe.

    v2 ``event_batch`` records are reconstructed by RE-FOLDING: each
    keyframe primes a live DeltaSnapshotPacker (the port's) from its
    recorded re-fold base (lane schema + demand fingerprints + padded
    arrays), and every event record then runs the recorded (names, bumps)
    batch through the same ``pack_fold`` the scorer used, yielding the
    exact padded ``[N,R]``/``[G,R]`` inputs (``record_kind:
    "event_batch"`` on the reconstructed record). Each step is bit-checked
    against the recorded ``input_digest``; the first mismatch is
    remembered and attached to every later record of the chain as
    ``refold.first_divergent_event``. An event record with no live base
    (rotated-away keyframe, fold bail) is unreconstructable with the fold
    outcome named — never a crash. Snapshot-lite is always on in the port,
    so the reference's ``disabled`` outcome does not occur."""

    def __init__(self, directory: str):
        self.directory = directory

    def segments(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.directory, "audit-*.jsonl")))

    def records(self) -> Iterator[dict]:
        state: Optional[Dict[str, np.ndarray]] = None
        names: Optional[dict] = None
        fold: Optional[dict] = None
        for path in self.segments():
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # a torn tail write (crash mid-append): skip the line,
                    # the next keyframe resynchronizes
                    yield {"kind": "unreconstructable",
                           "reason": "undecodable line", "segment": path}
                    state = None
                    fold = None
                    continue
                if rec.get("kind") == "event":
                    yield rec
                    continue
                if rec.get("kind") == "event_batch":
                    out, skip, fold = self._refold_event(rec, fold, names)
                    yield out if out is not None else skip
                    continue
                if rec.get("kind") != "batch":
                    continue
                if rec.get("keyframe"):
                    state = {k: _dec(v) for k, v in rec["arrays"].items()}
                    names = rec.get("names") or {"nodes": [], "groups": []}
                    fold = self._prime_refold(rec, state)
                else:
                    if state is None:
                        yield {
                            "kind": "unreconstructable",
                            "seq": rec.get("seq"),
                            "audit_id": rec.get("audit_id"),
                            "reason": "delta record before any keyframe "
                                      "(ring rotated past its keyframe)",
                        }
                        continue
                    for k, v in rec.get("arrays", {}).items():
                        state[k] = _dec(v)
                    for k, delta in rec.get("deltas", {}).items():
                        rows = delta["rows"]
                        data = _dec(delta["data"])
                        state[k] = state[k].copy()
                        state[k][rows] = data
                out = dict(rec)
                out["batch_args"] = tuple(
                    state[k] for k in BATCH_ARG_NAMES
                )
                out["progress_args"] = tuple(
                    state[k] for k in PROGRESS_ARG_NAMES
                )
                pol = rec.get("policy")
                if pol and all(k in state for k in POLICY_ARG_NAMES):
                    out["policy_args"] = (
                        tuple(state[k] for k in POLICY_ARG_NAMES),
                        tuple(pol.get("terms") or ()),
                        tuple(pol.get("weights") or ()),
                    )
                out["result_arrays"] = {
                    k: _dec(v) for k, v in rec["result"].items()
                }
                out["names"] = names or {"nodes": [], "groups": []}
                yield out

    # -- v2 re-fold ----------------------------------------------------------

    def _prime_refold(self, rec: dict, state: Dict[str, np.ndarray]):
        """Re-fold state from a keyframe: a live DeltaSnapshotPacker whose
        snapshot-lite buffers hold exactly the recorded arrays, primed
        from the keyframe's ``lite`` payload (lane schema + per-gang
        demand fingerprints). Returns a dict — ``{"ok": True, "packer",
        ...}`` or ``{"ok": False, "outcome", "reason"}`` explaining why
        event records under this keyframe cannot re-fold. Never raises."""
        lite_payload = rec.get("lite")
        if not lite_payload:
            return {
                "ok": False,
                "outcome": "no-base",
                "reason": "keyframe carries no re-fold base (the pack was "
                          "not snapshot-lite); event records under it "
                          "cannot re-fold",
            }
        try:
            sch = lite_payload["schema"]
            schema = LaneSchema(
                extended=tuple(sch["names"][len(CORE_LANES):]),
                shifts=dict(zip(sch["names"], sch["shifts"])),
            )
            if list(schema.names) != [str(n) for n in sch["names"]]:
                return {"ok": False, "outcome": "schema-mismatch",
                        "reason": "recorded lane schema does not extend "
                                  "the core lanes"}
            rec_names = rec.get("names") or {}
            node_names = [str(n) for n in rec_names.get("nodes") or []]
            group_names = [str(n) for n in rec_names.get("groups") or []]
            fps = [_fp_from_payload(p) for p in lite_payload["fps"]]
            if len(fps) != len(group_names):
                return {"ok": False, "outcome": "schema-mismatch",
                        "reason": "re-fold base group count does not "
                                  "match the recorded group names"}
            if np.asarray(state["fit_mask"]).shape[0] != 1:
                return {"ok": False, "outcome": "no-base",
                        "reason": "keyframe fit mask is per-gang (not a "
                                  "snapshot-lite pack); event records "
                                  "under it cannot re-fold"}
            packer = DeltaSnapshotPacker.from_refold_base(
                schema,
                node_names,
                [_demand_from_fp(nm, fp) for nm, fp in zip(group_names, fps)],
                state,
            )
        except Exception as exc:  # noqa: BLE001 — never crash the reader
            return {"ok": False, "outcome": "prime-error",
                    "reason": f"re-fold base priming failed: {exc!r}"}
        return {"ok": True, "packer": packer, "divergent": None}

    def _refold_event(self, rec: dict, fold, names):
        """(reconstructed record, skip record, fold state) for one
        ``event_batch`` record: exactly one of the first two is not None."""

        def unrec(reason: str, outcome: str):
            return None, {
                "kind": "unreconstructable",
                "seq": rec.get("seq"),
                "audit_id": rec.get("audit_id"),
                "reason": reason,
                "fold_outcome": outcome,
            }, fold

        if fold is None:
            return unrec(
                "event-batch record before any keyframe "
                "(ring rotated past its keyframe)",
                "no-base",
            )
        if not fold.get("ok"):
            return unrec(fold.get("reason", "re-fold base unavailable"),
                         fold.get("outcome", "no-base"))
        packer = fold["packer"]
        try:
            ev = rec.get("events") or {}
            node_updates = [
                (str(nm), {str(k): int(v) for k, v in d.items()})
                for nm, d in ev.get("nodes", ())
            ]
            group_updates = [
                _demand_from_fp(str(nm), _fp_from_payload(p))
                for nm, p in ev.get("groups", ())
            ]
            snap = packer.pack_fold(node_updates, group_updates)
        except Exception as exc:  # noqa: BLE001 — never crash the reader
            fold = {"ok": False, "outcome": "refold-error",
                    "reason": f"re-folding a recorded event batch raised "
                              f"{exc!r}; chain broken until the next "
                              f"keyframe"}
            _, skip, _ = unrec(fold["reason"], fold["outcome"])
            return None, skip, fold
        if snap is None:
            # the live fold would have bailed to a scan here; a recorded
            # event record claiming otherwise means the ring and the
            # replay environment disagree (e.g. tampering)
            fold = {"ok": False, "outcome": "packer-bail",
                    "reason": "recorded event batch did not re-fold (the "
                              "packer bailed); chain broken until the "
                              "next keyframe"}
            _, skip, _ = unrec(fold["reason"], fold["outcome"])
            return None, skip, fold
        batch_args = snap.device_args()
        progress_args = snap.progress_args()
        arrays = dict(zip(BATCH_ARG_NAMES, batch_args)) | dict(
            zip(PROGRESS_ARG_NAMES, progress_args)
        )
        digest = input_digest(arrays)
        digest_ok = digest == rec.get("input_digest")
        if not digest_ok and fold["divergent"] is None:
            fold["divergent"] = {
                "seq": rec.get("seq"),
                "audit_id": rec.get("audit_id"),
                "recorded_input_digest": rec.get("input_digest"),
                "refolded_input_digest": digest,
            }
        out = dict(rec)
        out["kind"] = "batch"
        out["record_kind"] = "event_batch"
        out["batch_args"] = batch_args
        out["progress_args"] = progress_args
        out["result_arrays"] = {
            k: _dec(v) for k, v in rec.get("result", {}).items()
        }
        out["names"] = names or {"nodes": [], "groups": []}
        out["refold"] = {
            "input_digest_ok": digest_ok,
            "first_divergent_event": fold["divergent"],
        }
        return out, None, fold

    def batches(self) -> tuple:
        """(reconstructed batch records, skipped records) — the list form
        replay and tests use."""
        batches, skipped = [], []
        for rec in self.records():
            if rec.get("kind") == "batch":
                batches.append(rec)
            elif rec.get("kind") == "unreconstructable":
                skipped.append(rec)
        return batches, skipped
