"""OracleScorer: the batch scoring strategy on the port's device.

Packs the live PodGroup status cache + cluster state into one
ClusterSnapshot (numpy), runs the batch (``ops.oracle.execute_batch_host``:
the head, the CUDA assignment scan, the compaction and the blob's copy to
pinned host memory, on the scorer's own stream), and
serves the per-group / per-node answers the scheduling callbacks need from
the cached host results, reading [G,N] rows from the device on demand.

The steady-state refresh is O(churn), as in the reference: a persistent
``DeltaSnapshotPacker`` rewrites only churned rows (the snapshot-lite
scan), or — when the cluster's event hooks prove that the drained events
cover every change — folds just the named nodes and gangs
(``pack_fold``); the packed ``[N,R]``/``[G,R]`` buffers stay resident on
the device (``ops.device_state``), which scatters the churned rows and
derives the fit row and queue order there, and the batch runs from those
resident tensors.

The port of ``batch_scheduler_tpu/core/oracle_scorer.py``: the blocking
in-process path and the three ways the scheduler keeps a batch off its
cycle's critical path (``min_batch_interval`` coalescing, the background
refresh thread and dispatch-ahead, whose speculative batch is enqueued
with ``ops.oracle.dispatch_batch`` and collected when it is consumed),
all on the scorer's own stream; generation-based dirty tracking,
cluster-version credits,
the event-fold refresh, device-resident state, the query API, the
remote scorer's seams (a batch's [G,N] rows may come from a row-fetcher
callable, the ``degraded`` flag of a conservative fallback batch, and
``conservative_cpu_batch`` itself; ``service.client.RemoteScorer``
overrides ``_execute``), the policy
engine (``policy_engine``: every snapshot carries the packed policy
columns, the node columns stay resident on the device, and every batch
runs the policy scan), and the audit layer: every published batch can be
recorded to an audit ring (``utils.audit``) and sampled for the identity
audit, and ``replay_batch`` / ``replay_audit_record`` re-execute a
recorded batch on a named rung (``REPLAY_RUNGS``); and the capacity
observatory (``ops.capacity``): every published batch offers a budget-gated
capacity sample over the resident tensors it ran on, under the same audit
id as its audit record and identity audit; and the observability layer:
under a live trace (``utils.trace``) a refresh is the span
``oracle.refresh`` with its pack or fold, device-state sync and batch as
children, every published batch leaves a ``_batch`` flight record and
arms the lifecycle ledger's batch context (``utils.lifecycle``), all from
host values. It subsumes the
reference's findMaxPG + compareClusterResourceAndRequire serial loops
(reference pkg/scheduler/core/core.go:514-632,701-739) with exact batch
answers.
"""

from __future__ import annotations

import sys
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cache.pg_cache import PGStatusCache, PodGroupMatchStatus
from ..ops.capacity import CapacitySampler, capacity_enabled, set_active_sampler
from ..ops.convert import device_stream, resolve_device
from ..ops.device_state import DeviceStateHolder
from ..ops.events import EventLog
from ..ops.bucketing import topk_bucket, wave_width_bucket
from ..ops.oracle import (
    collect_batch,
    dispatch_batch,
    execute_batch_host,
    forced_scan_rung,
)
from ..ops.snapshot import (
    ClusterSnapshot,
    DeltaSnapshotPacker,
    GroupDemand,
    _demand_fp,
)
from ..policy.terms import label_hash, parse_label_ref
from ..utils import audit as audit_mod
from ..utils import tenancy
from ..utils import trace as trace_mod
from ..utils.errors import StaleBatchError
from ..utils.health import IdentityAuditor
from ..utils.lifecycle import DEFAULT_LEDGER
from ..utils.metrics import DEFAULT_REGISTRY, LONG_OP_BUCKETS
from ..utils.labels import (
    POLICY_AFFINITY_LABEL,
    POLICY_ANTI_AFFINITY_LABEL,
    POLICY_SPREAD_LABEL,
)

__all__ = [
    "OracleScorer",
    "conservative_cpu_batch",
    "demand_from_status",
    "read_cluster_inputs",
    "replay_batch",
    "replay_audit_record",
    "REPLAY_RUNGS",
]


def read_cluster_inputs(cluster, status_cache: PGStatusCache):
    """ONE consistent read of the oracle's cluster inputs: (nodes,
    node_requested, demands) — the projection every snapshot pack
    consumes. A provider with ``nodes_requested`` (``ClusterState``)
    answers every node's requested resources in one lock pass."""
    statuses = status_cache.snapshot()
    demands: List[GroupDemand] = [
        demand_from_status(name, pgs)
        for name, pgs in sorted(statuses.items())
    ]
    nodes = cluster.list_nodes()
    names = [n.metadata.name for n in nodes]
    return nodes, _nodes_requested(cluster, names), demands


def _nodes_requested(cluster, names) -> Dict[str, Dict[str, int]]:
    """``cluster.node_requested`` of each name, in one call where the
    provider offers the batch form."""
    many = getattr(cluster, "nodes_requested", None)
    if callable(many):
        return many(names)
    return {name: cluster.node_requested(name) for name in names}


def conservative_cpu_batch(snap: ClusterSnapshot):
    """Degraded-mode batch: the conservative host-side answers a
    RemoteScorer serves while the sidecar is unreachable (breaker open /
    retries exhausted — docs/resilience.md).

    Semantics match the kube-scheduler rule that a scorer outage makes
    decisions conservative, never absent:

    - per-(group, node) member CAPACITY is computed exactly from the
      snapshot (lane-wise ``left // member_request`` under the fit mask),
      so Filter/Score keep answering with real numbers;
    - ``gang_feasible`` is exact INDEPENDENT feasibility (sum of per-node
      capacity >= remaining members): when it is False the gang provably
      cannot fit even alone, and PreFilter may deny it;
    - ``placed`` is all-False and no assignment exists: nothing is
      admitted speculatively through a whole-gang plan — members that do
      pass PreFilter go through the per-pod scan + Permit-quorum path,
      whose fit checks run against live cluster state.

    Returns the same ``(host, row_fetcher)`` pair as a real batch. Built
    lane-by-lane (R passes over a [G, N] array) so the degraded path
    never materialises the [G, N, R] broadcast cube.
    """
    left = np.maximum(
        snap.alloc.astype(np.int64) - snap.requested.astype(np.int64), 0
    )  # [N, R]
    group_req = snap.group_req.astype(np.int64)  # [G, R]
    g_count, n_count = group_req.shape[0], left.shape[0]
    cap = np.full((g_count, n_count), np.iinfo(np.int32).max, dtype=np.int64)
    for r in range(group_req.shape[1]):
        req_r = group_req[:, r]
        has = req_r > 0
        if not has.any():
            continue
        lane_cap = left[:, r][None, :] // np.maximum(req_r, 1)[:, None]
        cap = np.where(has[:, None], np.minimum(cap, lane_cap), cap)
    cap = np.where(snap.fit_mask, cap, 0)  # [1,N] broadcast or [G,N]
    cap = np.where(snap.node_valid[None, :], cap, 0)
    cap = np.clip(cap, 0, np.iinfo(np.int32).max).astype(np.int32)
    feasible = np.asarray(snap.group_valid) & (
        cap.sum(axis=1, dtype=np.int64) >= snap.remaining
    )
    host = {
        "gang_feasible": feasible,
        "placed": np.zeros(g_count, dtype=bool),
        "progress": np.zeros(g_count, dtype=np.int32),
        "best": 0,
        "best_exists": False,
        "assignment_nodes": np.zeros((g_count, 1), dtype=np.int32),
        "assignment_counts": np.zeros((g_count, 1), dtype=np.int32),
    }

    def row_fetcher(kind: str, g: int) -> np.ndarray:
        # capacity doubles as the score rank: more headroom, better seat
        return cap[g]

    return host, row_fetcher


def demand_from_status(full_name: str, pgs: PodGroupMatchStatus) -> GroupDemand:
    """Project a live PodGroupMatchStatus into the oracle's demand row.

    The policy fields project from the representative pod's policy labels
    (``utils.labels.POLICY_*``); a spread gang also records its matched
    members per node (its domain occupancy). Pods without policy labels
    pay nothing: the extra work is guarded on label presence."""
    pg = pgs.pod_group
    member_req = dict(pg.spec.min_resources or {})
    if not member_req and pgs.pod is not None:
        member_req = pgs.pod.resource_require()
    affinity_hash = anti_hash = 0
    spread = False
    placed_nodes: Dict[str, int] = {}
    if pgs.pod is not None and pgs.pod.metadata.labels:
        labels = pgs.pod.metadata.labels
        raw = labels.get(POLICY_AFFINITY_LABEL)
        if raw:
            k, v = parse_label_ref(raw)
            affinity_hash = label_hash(k, v) if k else 0
        raw = labels.get(POLICY_ANTI_AFFINITY_LABEL)
        if raw:
            k, v = parse_label_ref(raw)
            anti_hash = label_hash(k, v) if k else 0
        spread = bool(labels.get(POLICY_SPREAD_LABEL))
        if spread:
            for pair in pgs.matched_pod_nodes.items().values():
                placed_nodes[pair.node] = placed_nodes.get(pair.node, 0) + 1
    return GroupDemand(
        full_name=full_name,
        min_member=pg.spec.min_member,
        scheduled=pg.status.scheduled,
        matched=len(pgs.matched_pod_nodes.items()),
        priority=pgs.pod.spec.priority if pgs.pod is not None else 0,
        creation_ts=pg.metadata.creation_timestamp,
        member_request=member_req,
        node_selector=dict(pgs.pod.spec.node_selector) if pgs.pod else {},
        tolerations=list(pgs.pod.spec.tolerations) if pgs.pod else [],
        released=pgs.scheduled,
        has_pod=pgs.pod is not None,
        affinity_hash=affinity_hash,
        anti_hash=anti_hash,
        spread=spread,
        placed_nodes=placed_nodes,
    )


# ---------------------------------------------------------------------------
# deterministic replay
# ---------------------------------------------------------------------------

# The rungs a recorded batch can be re-executed against:
#   steady    — exactly what this process would dispatch right now (the
#               live BST_SCAN_WAVE) on the caller's device: on cuda, the
#               scan kernel of that rung.
#   wavefront — the wavefront scan pinned at width 8 on the caller's
#               device: the wave kernel on cuda.
#   topk      — the hierarchical top-K scan pinned at width 8 and K = 16
#               candidates on the caller's device: the top-K kernel on
#               cuda (the rung's claim is the serial plan bit for bit).
#   cpu-ladder— the plain serial scan on the CPU, the counterpart of the
#               reference's serial lax.scan on a CPU device: what the
#               identity audit (utils.health.IdentityAuditor) re-verifies
#               against, and the cross-backend probe for rings recorded on
#               the card.
REPLAY_RUNGS = ("steady", "wavefront", "cpu-ladder", "topk")


def replay_batch(batch_args, progress_args, against: str = "steady",
                 device="cuda", policy=None, wave: int = 8, topk: int = 16):
    """Re-execute one recorded batch's EXACT packed inputs on the requested
    rung and return ``(host, device_result)`` like ``execute_batch_host``.
    ``device`` is where the ``steady``, ``wavefront`` and ``topk`` rungs
    run (``cpu-ladder`` always runs on the CPU); ``wave`` is the width the
    ``wavefront`` and ``topk`` rungs pin (``wave_width_bucket``) and
    ``topk`` the candidate width of the ``topk`` rung (``topk_bucket``). The arrays are host numpy
    (a replay touches no scorer's resident tensor) and are uploaded on the
    calling thread's current stream, never on a scorer's stream. The rung
    pin is thread-local (ops.oracle.forced_scan_rung), so a replay —
    including the identity audit's daemon-thread re-verification — never
    changes the rung a serving thread runs. There is no fallback: on cuda
    the rung's kernel runs or the replay raises.

    ``policy`` is a recorded batch's ``(policy_cols, terms, weights)``
    payload: a policy batch always re-executes the policy scan (the
    composite is part of its semantics; ``dispatch_batch`` ignores the wave
    and candidate widths for it), so every rung runs the policy scan on its
    device: the composite-key kernel on ``steady``, ``wavefront`` and
    ``topk`` on cuda, the plain policy scan on ``cpu-ladder``."""
    if against not in REPLAY_RUNGS:
        raise ValueError(
            f"unknown replay rung {against!r} (use one of {REPLAY_RUNGS})"
        )
    batch_args = tuple(np.asarray(a) for a in batch_args)
    progress_args = tuple(np.asarray(a) for a in progress_args)
    if policy is not None:
        cols, terms, weights = policy
        policy = (tuple(np.asarray(c) for c in cols), tuple(terms), tuple(weights))
    if against == "steady":
        return execute_batch_host(batch_args, progress_args, device=device, policy=policy)
    if against in ("wavefront", "topk"):
        rung = (wave_width_bucket(wave), topk_bucket(topk) if against == "topk" else 0)
        with forced_scan_rung(*rung):
            return execute_batch_host(batch_args, progress_args, device=device,
                                      policy=policy)
    with forced_scan_rung(0):
        return execute_batch_host(batch_args, progress_args, device="cpu", policy=policy)


def replay_audit_record(record: dict, against: str = "steady",
                        device="cuda") -> dict:
    """Replay one reconstructed audit record (utils.audit.AuditReader) and
    bit-compare the resulting plan against the recorded digest. Returns a
    per-batch report: the rung that executed (``executed_rung``: device,
    scan, wave width, ``scan_topk`` for a top-K batch and ``scan_policy``
    for a policy batch, from the
    replay's telemetry) and, on a divergence, a
    structured blame dict — config fingerprints on both sides, bucket
    shape, the executed rung, and the first differing plan field / gang /
    node (named when the record kept names).

    A record flagged ``degraded`` (a reference sidecar's conservative
    fallback batch, which has no device plan) is SKIPPED, not replayed. A
    record of a policy batch (``policy_args``, from either package's ring)
    replays through the policy scan on every rung (``replay_batch``)."""
    if record.get("degraded"):
        return {
            "seq": record.get("seq"),
            "audit_id": record.get("audit_id"),
            "against": against,
            "identical": None,
            "skipped": "degraded conservative-fallback batch — no device "
                       "plan to re-execute",
        }
    refolded = record.get("record_kind") == "event_batch"
    host, _ = replay_batch(
        record["batch_args"], record["progress_args"], against=against,
        device=device, policy=record.get("policy_args"),
    )
    digest = audit_mod.plan_digest(host)
    identical = digest == record.get("plan_digest")
    telemetry = host["telemetry"]
    executed = {k: telemetry[k] for k in ("device", "scan", "wave_width")}
    if telemetry["scan_topk"]:
        executed["scan_topk"] = telemetry["scan_topk"]
    if telemetry["scan_policy"]:
        executed["scan_policy"] = True
    out = {
        "seq": record.get("seq"),
        "audit_id": record.get("audit_id"),
        "against": against,
        "identical": identical,
        "recorded_digest": record.get("plan_digest"),
        "replayed_digest": digest,
        "shape": record.get("shape"),
        "executed_rung": executed,
    }
    if refolded:
        out["refolded"] = True
    if not identical:
        names = record.get("names") or {}
        shape = record.get("shape") or {}
        recorded_result = record["result_arrays"]
        if refolded:
            # event_batch records carry a compact result (assignment
            # arrays omitted — the digest still covers them): substitute
            # the replayed assignments so the field-by-field compare runs
            # over the fields the record actually kept
            recorded_result = dict(recorded_result)
            for k in ("assignment_nodes", "assignment_counts"):
                recorded_result.setdefault(k, host[k])
        blame = audit_mod.divergence_report(
            recorded_result,
            host,
            node_names=names.get("nodes"),
            group_names=names.get("groups"),
            context={
                "recorded_config": record.get("config"),
                "replay_config": audit_mod.config_fingerprint(
                    telemetry["device"]),
                "bucket": [shape.get("g_bucket"), shape.get("n_bucket")],
                "executed_rung": executed,
            },
        )
        if refolded:
            refold = record.get("refold") or {}
            if blame is None:
                blame = {
                    "field": "<assignment>",
                    "reason": "digest mismatch confined to the assignment "
                              "arrays, which event_batch records omit — "
                              "re-execute against an array keyframe to "
                              "localize the slot",
                }
            # name the fold outcome and — when the re-folded input stream
            # itself diverged — the first differing event batch, so blame
            # points at the event, not just the downstream array field
            blame["fold"] = {
                "outcome": (
                    "refolded" if refold.get("input_digest_ok", True)
                    else "input-divergence"
                ),
                "refresh": record.get("refresh"),
            }
            if refold.get("first_divergent_event") is not None:
                blame["field"] = "<event-stream>"
                blame["first_divergent_event"] = (
                    refold["first_divergent_event"]
                )
        out["blame"] = blame or {
            "field": "<record>",
            "reason": "digest mismatch but every plan field matches — "
                      "the recorded digest (not the plan) is damaged",
        }
    return out


def _snapshot_tenancy(snap) -> Dict[str, int]:
    """Gangs per namespace of one snapshot: one O(G) pass over its gang
    names, the base of the audit record's tenant stamp."""
    ns_counts: Dict[str, int] = {}
    for name in snap.group_names:
        ns = tenancy.gang_namespace(name)
        if ns:
            ns_counts[ns] = ns_counts.get(ns, 0) + 1
    return ns_counts


class _BatchState:
    """One immutable (snapshot, results) pair, swapped in atomically so
    concurrent readers never see a torn snapshot/result combination.
    ``result`` holds the O(G) host vectors; [G,N] rows are read lazily and
    cached. ``rows`` is where they live: the batch's ``device_result``
    dict of [G,N] tensors (the in-process batch), or a row-fetcher
    callable ``(kind, g) -> row`` (a remote batch, read from the sidecar;
    the conservative fallback batch)."""

    __slots__ = ("snapshot", "result", "max_group", "rows", "_rows", "_rows_lock")

    def __init__(self, snapshot: ClusterSnapshot, result: dict,
                 max_group: str, rows):
        self.snapshot = snapshot
        self.result = result
        self.max_group = max_group
        self.rows = rows
        self._rows: Dict[tuple, np.ndarray] = {}  # guarded-by: _rows_lock
        self._rows_lock = threading.Lock()

    def row(self, kind: str, g: int) -> np.ndarray:
        """Fetch (and cache) one group's row of a [G,N] tensor. A device
        tensor's batch is complete (its collect waited on the batch's
        event), and the copy is synchronous on the reader's stream, so the
        block is not freed while the read is pending. A fetcher may raise
        StaleBatchError (the remote batch's rows are gone)."""
        key = (kind, g)
        with self._rows_lock:
            cached = self._rows.get(key)
        if cached is not None:
            return cached
        if callable(self.rows):
            row = np.asarray(self.rows(kind, g))
        else:
            row = self.rows[kind][g].cpu().numpy()
        with self._rows_lock:
            self._rows[key] = row
        return row


def _request_lanes(snap: ClusterSnapshot) -> int:
    """The nonzero entries of the batch's [G,R] request, counted on the
    snapshot's host copy (the batch reads the resident one): the lanes
    of the bound ``/debug/buckets`` gives a bucket's first batch."""
    return int(np.count_nonzero(snap.group_req > 0))


class OracleScorer:
    """Caches one batch of oracle results; invalidated by ``mark_dirty``.

    ``device`` is where batches run: ``cuda`` (default; raises at
    construction on a machine without CUDA) or ``cpu``. The packed
    buffers stay resident on that device, and each pack's churned rows
    are scattered into them. On CUDA every refresh enqueues its device
    work (the holder's uploads and scatters, the batch, the blob's copy)
    on the scorer's own ``stream``, whichever thread refreshes.

    ``audit_log`` (a ``utils.audit.AuditLog``) records every published
    batch; ``identity_audit_every`` > 0 re-verifies every Kth published
    batch on the CPU rung (``utils.health.IdentityAuditor``). See
    ``configure_audit``.

    ``policy_engine`` (an enabled ``policy.PolicyEngine``) rides the packer,
    so every snapshot carries the packed policy columns and every batch
    runs the policy scan (``ClusterSnapshot.policy_payload``), with the
    node columns resident on the device. As in the reference it turns off
    the snapshot-lite scan and the event fold: a policy refresh is a full
    O(N+G) read and delta pack. None (or a disabled engine) runs the
    pre-policy path.

    ``device=None`` keeps no local device, stream or resident state: the
    batch runs elsewhere (``service.client.RemoteScorer``, whose sidecar
    keeps the resident mirror).

    ``min_batch_interval`` > 0 serves a merely-stale batch (every queried
    gang known) until the interval since the last publication elapses;
    ``background_refresh`` re-batches such a batch on a daemon thread
    while callers keep reading the old answers; ``dispatch_ahead`` packs
    and enqueues the NEXT batch on a daemon thread after each publication
    (``dispatch_batch`` returns before the blob lands), and a later
    ``ensure_fresh`` publishes it iff nothing changed since it was packed
    (else it is collected and discarded). Every one of them runs its
    device work on ``stream`` under the refresh lock, so the holder's
    in-place scatters never overtake a batch that reads the resident
    tensors. ``drain_background`` waits them out (and collects a banked
    speculative batch): call it before teardown."""

    supports_background_refresh = True
    # in-process batches dispatch ahead freely; RemoteScorer narrows both
    # to transports with a second lane
    supports_dispatch_ahead = True
    # True while the served batch came from a degraded (conservative
    # fallback) path: RemoteScorer flips it, the in-process scorer never
    # degrades. ScheduleOperation reads it to relax the deny-by-default
    # PreFilter rule to deny-only-provably-infeasible.
    degraded = False

    def __init__(self, device="cuda", audit_log=None,
                 identity_audit_every: int = 0, policy_engine=None,
                 min_batch_interval: float = 0.0,
                 background_refresh: bool = False,
                 dispatch_ahead: bool = False,
                 compile_warmer: bool = False):
        self.device = None if device is None else resolve_device(device)
        self.stream = None if device is None else device_stream(self.device)
        # Dirty tracking is a GENERATION pair: refresh() records the
        # generation it observed BEFORE packing, so a mark_dirty landing
        # while the batch runs keeps the batch stale.
        self._dirty_gen = 1
        self._clean_gen = 0
        self._state: Optional[_BatchState] = None
        self._refresh_lock = threading.Lock()
        self._cluster_version = None
        self.batches_run = 0
        # Background refresh: a stale-but-servable batch (every queried
        # gang known) re-batches on a daemon thread while callers keep
        # reading the old answers. A missing gang or a failed background
        # batch still takes the BLOCKING path, so errors surface in a
        # cycle.
        self.background_refresh = background_refresh
        self._bg_thread: Optional[threading.Thread] = None  # guarded-by: _bg_lock
        self._bg_lock = threading.Lock()
        self._bg_error: Optional[Exception] = None
        # Re-batch coalescing: a dirty batch whose answers can still be
        # served is refreshed at most once per interval (denials are
        # 20 s-sticky through the deny cache anyway).
        self.min_batch_interval = min_batch_interval
        self._last_batch_t = 0.0
        # Dispatch-ahead: the banked speculative batch (snap, finish, gen,
        # version, pack_s, dispatch_s, resident) travels under the REFRESH
        # lock (packed and consumed inside it); _spec_lock only
        # serializes the thread's lifecycle
        self.dispatch_ahead = dispatch_ahead
        self._spec_lock = threading.Lock()
        self._spec_thread: Optional[threading.Thread] = None  # guarded-by: _spec_lock
        self._spec: Optional[tuple] = None  # guarded-by: _refresh_lock
        self._spec_error: Optional[Exception] = None
        self.spec_served = 0
        self.spec_discarded = 0
        # speculative batches enqueued (each one launch of the scan): the
        # served, the discarded and one a drain collected unconsumed
        self.spec_dispatched = 0
        # The bucket warmer (ops.bucketing.CompileWarmer): runs one batch at
        # each bucket shape adjacent to the live working set on a daemon
        # thread, so a bucket transition finds the kernel loaded and its
        # plan cached (ops.bucketing says what stays cold).
        # Local batches only: a remote scorer's batches run on the sidecar,
        # which has its own warmer.
        self._warmer = None
        if compile_warmer and self.device is not None:
            from ..ops.bucketing import maybe_compile_warmer

            self._warmer = maybe_compile_warmer(self.device)
        # Plan-covered cluster changes (member assumes/binds the current
        # batch already charged via its gang placement) are credited rather
        # than invalidating the batch.
        self._version_credits = 0  # guarded-by: _credits_lock
        self._credits_lock = threading.Lock()
        # Persistent packed host buffers (ops.snapshot.DeltaSnapshotPacker):
        # low-churn refreshes rewrite only the node/group rows that changed.
        # An enabled policy engine rides the packer (policy columns).
        self.policy_engine = policy_engine
        self._packer = DeltaSnapshotPacker(policy_engine=policy_engine)
        # Event-sourced refresh (ops.events): cluster mutations append
        # entity NAMES to a bounded event log (wired lazily to the
        # cluster's subscribe_events on first pack), and an eligible
        # refresh folds just the named entities into the packer's
        # persistent buffers (pack_fold) instead of re-reading every
        # node/group. The wiring state moves only under _refresh_lock; the
        # LOG REFERENCE is read WITHOUT it by producers (mark_dirty /
        # note_group_event run on scheduling threads and must never block
        # behind a refresh) — benign: the EventLog is internally locked,
        # and a producer racing the wiring at worst misses the log, which
        # the version-bump accounting catches as a skew (scan fallback),
        # never a stale fold.
        self._event_log: Optional[EventLog] = None  # racy-read by design
        self._event_cluster_ref = None  # guarded-by: _refresh_lock
        self._event_cache_ref = None  # guarded-by: _refresh_lock
        # completeness baselines recorded at every pack: the cluster
        # version and status-cache mutation counter the NEXT fold must
        # reconcile against (None -> the fold cannot prove coverage)
        self._fold_version = None  # guarded-by: _refresh_lock
        self._fold_mut_base = None  # guarded-by: _refresh_lock
        # fold attempts by outcome (_try_fold, under the refresh lock), and
        # the last one. The counts take the stats lock too: stats() copies
        # them from any thread without waiting out a refresh
        self.fold_outcomes: Dict[str, int] = {}  # guarded-by: _stats_lock
        self.last_fold_outcome: Optional[str] = None  # guarded-by: _refresh_lock
        # Device-resident cluster state (ops.device_state): the packed
        # [N,R]/[G,R] buffers stay on the device across batches and each
        # pack's churned rows apply as one row scatter.
        self._device_state = (
            None if device is None
            else DeviceStateHolder(self.device, label="scorer")
        )
        # host pack / device batch seconds of the recent batches, and the
        # pack seconds by path ("keyframe", "scan", "fold"); the pack
        # includes the device-state sync (its own share in sync_seconds:
        # the host side of the scatters, derive and uploads), as in the
        # reference
        self.pack_seconds: list = []  # guarded-by: _stats_lock
        self.batch_seconds: list = []  # guarded-by: _stats_lock
        self.pack_seconds_by_path: Dict[str, list] = {}  # guarded-by: _stats_lock
        self.sync_seconds: list = []  # guarded-by: _stats_lock
        self._stats_lock = threading.Lock()
        # evidence errors swallowed at publish (an audit failure never
        # fails a publish, but it is counted: stats()["audit"])
        self.audit_errors = 0
        # (gang-name list, gangs per namespace) of the last snapshot seen
        # (_tenancy); publish and the batch's tenant label read it
        self._tenancy_memo = None
        # the capacity observatory (ops.capacity): a budget-gated analytics
        # pass over the published batch's committed inputs, registered
        # UNCONDITIONALLY (None when disabled): the newest scorer owns the
        # observatory, and a capacity-off scorer clears a predecessor's
        self._capacity = (
            CapacitySampler(label="scorer") if capacity_enabled() else None
        )
        set_active_sampler(self._capacity)
        self.configure_audit(audit_log, identity_audit_every)

    def configure_audit(self, audit_log=None,
                        identity_audit_every: int = 0) -> None:
        """Attach the black-box flight data layer: a ``utils.audit.AuditLog``
        recording every published batch (inputs + plan digest, serialized
        off the hot path), and/or the sampled identity audit — every Kth
        published batch re-verified bit for bit on the ``cpu-ladder`` rung
        on a daemon thread (``utils.health.IdentityAuditor``; a mismatch
        flags the audit ring)."""
        self.audit_log = audit_log
        self._identity = (
            IdentityAuditor(identity_audit_every)
            if identity_audit_every and identity_audit_every > 0 else None
        )

    def mark_dirty(self, group: Optional[str] = None) -> None:
        """Invalidate the served batch. ``group`` names the gang whose
        demand row changed, which keeps the next refresh fold-eligible; an
        unattributed mark is a BLIND mark — the next refresh falls back to
        the full scan, which is always correct."""
        # GIL-level increment; a lost update between two racing markers
        # still leaves the generation ahead of _clean_gen
        self._dirty_gen += 1
        log = self._event_log
        if log is not None:
            if group:
                log.note_group(group)
            else:
                log.note_blind()

    def note_group_event(self, full_name: str) -> None:
        """Record that a gang's demand row (matched/scheduled progress)
        changed WITHOUT dirtying the batch — the plan-covered mutations
        the credit path already accounts for. The pending event makes the
        next refresh (whenever something else triggers it) fold this
        gang's fresh state instead of scanning."""
        log = self._event_log
        if log is not None:
            log.note_group(full_name)

    def credit_expected_change(self, n: int = 1) -> None:
        """Record n cluster-version bumps as pre-accounted by the current
        batch (a planned gang member being assumed/bound): the batch stays
        fresh. Over- or under-crediting is safe — any mismatch makes
        ``_stale`` true, which only costs an extra re-batch."""
        with self._credits_lock:
            self._version_credits += n

    @property
    def snapshot(self) -> Optional[ClusterSnapshot]:
        state = self._state
        return state.snapshot if state is not None else None

    @property
    def last_telemetry(self) -> Optional[dict]:
        """The served batch's telemetry (device, scan, mask mode, buckets,
        and the wave statistics when the wavefront scan ran)."""
        state = self._state
        return state.result.get("telemetry") if state is not None else None

    def refresh(self, cluster, status_cache: PGStatusCache) -> None:
        """Pack the current state (event fold or scan) and run one batch.
        Callers serialize refreshes (``ensure_fresh`` holds the refresh
        lock). Under a live trace (utils.trace) the refresh is the span
        ``oracle.refresh``, with the pack, the device-state sync and the
        batch as its children."""
        with trace_mod.span("oracle.refresh", cat="oracle"):
            self._refresh_traced(cluster, status_cache)

    def _refresh_traced(self, cluster, status_cache: PGStatusCache) -> None:
        with torch.cuda.stream(self.stream):
            snap, dirty_gen, version_base, pack_s = self._pack_current(
                cluster, status_cache
            )
            # the resident tensors this batch reads (None without a local
            # device): the capacity sample reads them after publication,
            # before the next pack's scatter rewrites them
            resident = getattr(snap, "device_state_args", None)
            t1 = time.perf_counter()
            # host wall time: it covers the device batch because
            # collect_batch waits on the batch's event and host copy
            with trace_mod.span(
                "oracle.batch", cat="oracle",
                groups=len(snap.group_names), nodes=len(snap.node_names),
            ):
                host, rows = self._execute(snap)
            batch_s = time.perf_counter() - t1
        self._publish(snap, host, rows, dirty_gen, version_base, pack_s,
                      batch_s, resident)

    def _publish(self, snap, host, rows, dirty_gen, version_base,
                 pack_s: float, batch_s: float, resident,
                 speculative: bool = False) -> None:
        """Install one executed batch as the served state: the blocking
        refresh's and the dispatch-ahead consume path's shared tail.
        ``resident`` is the holder's tensors the batch read (the capacity
        sample reads them before the next pack's scatter)."""
        # markers a remote batch rides on its host dict, consumed at
        # publication so the served result never carries them: whether
        # this is a conservative fallback batch, and the audit id it
        # announced on the wire
        degraded = host.pop("_degraded", None)
        audit_id = host.pop("_audit_id", None)
        if degraded is not None:
            self._set_degraded(bool(degraded))
        max_group = (
            snap.group_names[int(host["best"])]
            if host["best_exists"] and int(host["best"]) < len(snap.group_names)
            else ""
        )
        self._state = _BatchState(snap, host, max_group, rows)
        self._cluster_version = version_base
        self._clean_gen = dirty_gen  # compare-and-clear: later marks survive
        self.batches_run += 1
        # credits offset the OLD batch's staleness check and die with it
        with self._credits_lock:
            self._version_credits = 0
        self._last_batch_t = time.monotonic()
        # flight-recorder batch record: the evidence later gang decisions
        # rest on, host values only. The telemetry dict is NESTED, never
        # splatted: on the remote path it arrives verbatim from the peer's
        # TRACE_INFO JSON, and a key colliding with record()'s own
        # parameters must not fail the refresh
        telemetry = host.get("telemetry")
        record_telemetry = telemetry if isinstance(telemetry, dict) else {}
        waves = record_telemetry.get("waves_per_batch")
        if (
            isinstance(waves, (int, float))
            and not isinstance(waves, bool)
            and waves > 0
            and "per_wave_device_seconds" not in record_telemetry
        ):
            # the per-wave share of the batch, on the record's own copy:
            # the served telemetry stays the batch's as it ran
            record_telemetry = dict(
                record_telemetry,
                per_wave_device_seconds=round(batch_s / waves, 6),
            )
        if self._warmer is not None:
            try:
                self._warmer.note_batch(
                    snap.device_args(), snap.progress_args(), record_telemetry,
                )
            except Exception:  # noqa: BLE001 — warm accounting never fatal
                pass
        trace_mod.DEFAULT_FLIGHT_RECORDER.record(
            "_batch",
            phase="batch",
            verdict="info",
            batch=self.batches_run,
            batch_ms=round(batch_s * 1000, 2),
            pack_ms=round(pack_s * 1000, 2),
            groups=len(snap.group_names),
            nodes=len(snap.node_names),
            degraded=bool(self.degraded),
            speculative=speculative,
            audit_id=audit_id,
            telemetry=record_telemetry,
        )
        # one audit id for the whole evidence chain: the audit record, the
        # identity audit AND the capacity sample all correlate by it
        if audit_id is None and (
            self.audit_log is not None
            or self._identity is not None
            or self._capacity is not None
        ):
            audit_id = audit_mod.new_audit_id()
        # lifecycle batch context (utils.lifecycle): every gang event
        # noted until the NEXT publish stamps this audit id, and the
        # sidecar coalescer's queue wait (TRACE_INFO telemetry; absent
        # when the client ran untraced) is attributed once per gang
        DEFAULT_LEDGER.note_batch_context(
            audit_id, telemetry if isinstance(telemetry, dict) else None
        )
        if self.audit_log is not None or self._identity is not None:
            self._audit_publish(snap, host, audit_id, speculative)
        if self._capacity is not None:
            with torch.cuda.stream(self.stream):
                self._capacity_sample(snap, host, audit_id, resident)
        path = (
            "keyframe" if snap.delta is None or snap.delta.kind == "keyframe"
            else "fold" if snap.delta.source == "events" else "scan"
        )
        with self._stats_lock:
            self.pack_seconds.append(pack_s)
            self.batch_seconds.append(batch_s)
            del self.pack_seconds[:-1000], self.batch_seconds[:-1000]
            by_path = self.pack_seconds_by_path.setdefault(path, [])
            by_path.append(pack_s)
            del by_path[:-1000]
        # the reference's batch series (its refresh publishes them here too)
        DEFAULT_REGISTRY.counter(
            "bst_oracle_batches_total", "Fused oracle batches executed"
        ).inc()
        DEFAULT_REGISTRY.histogram(
            "bst_oracle_batch_seconds",
            "Device time per fused oracle batch (compiles included)",
            buckets=LONG_OP_BUCKETS,
        ).observe(batch_s)
        DEFAULT_REGISTRY.histogram(
            "bst_oracle_pack_seconds", "Host snapshot-pack time per batch"
        ).observe(pack_s)

    def _pack_current(self, cluster, status_cache: PGStatusCache):  # lock-held: _refresh_lock
        """Read cluster state and build one snapshot — the O(churn) event
        fold when the pending events prove complete coverage, else the
        full read + delta pack. Returns (snap, dirty_gen, version_base,
        pack_seconds).

        The dirty generation, the version base and the mutation-counter
        baseline are all taken BEFORE reading state: any change landing
        mid-pack leaves version() ahead of the base (or skews the next
        fold's comparison) and re-batches conservatively."""
        t0 = time.perf_counter()
        dirty_gen = self._dirty_gen
        version_fn = getattr(cluster, "version", None)
        version_base = version_fn() if callable(version_fn) else None
        self._ensure_event_wiring(cluster, status_cache)
        log = self._event_log
        mut_base = status_cache.mutations() if log is not None else None
        snap = None
        if log is not None:
            snap = self._try_fold(cluster, status_cache, version_base, mut_base)
        if snap is None:
            nodes, node_req, demands = read_cluster_inputs(cluster, status_cache)
            with trace_mod.span("oracle.snapshot_pack", cat="oracle"):
                snap = self._packer.pack(nodes, node_req, demands)
        if log is not None:
            self._fold_version = version_base
            self._fold_mut_base = mut_base
        self._note_pack(snap)
        return snap, dirty_gen, version_base, time.perf_counter() - t0

    def _ensure_event_wiring(self, cluster, status_cache) -> None:  # lock-held: _refresh_lock
        """Lazily subscribe one EventLog to THIS (cluster, status_cache)
        pair. A provider without subscribe_events/version (plain test
        providers) gets no log — every refresh scans. Re-wiring on a
        provider change resets the completeness baselines: a fold must
        never reconcile version arithmetic across two different
        clusters."""
        if (
            self._event_log is not None
            and self._event_cluster_ref is not None
            and self._event_cluster_ref() is cluster
            and self._event_cache_ref is not None
            and self._event_cache_ref() is status_cache
        ):
            return
        self._event_log = None
        self._event_cluster_ref = None
        self._event_cache_ref = None
        self._fold_version = None
        self._fold_mut_base = None
        subscribe = getattr(cluster, "subscribe_events", None)
        version_fn = getattr(cluster, "version", None)
        if not callable(subscribe) or not callable(version_fn):
            return
        if not callable(getattr(status_cache, "mutations", None)):
            return
        log = EventLog(label="scorer")
        subscribe(log.note_bump)  # weakly held: dies with this scorer
        on_update = getattr(status_cache, "on_update", None)
        if callable(on_update):
            # an entry re-stored in place (the controller's status sync)
            # is no mutation of the cache: the fold hears of the gang
            # here (weakly held: dies with this log)
            on_update(log.note_group)
        self._event_log = log
        self._event_cluster_ref = weakref.ref(cluster)
        self._event_cache_ref = weakref.ref(status_cache)

    def _try_fold(self, cluster, status_cache, version_base, mut_base):  # lock-held: _refresh_lock
        """Attempt the O(churn) event-fold pack. The eligibility chain
        proves — never assumes — that the drained events cover EVERY
        oracle-visible change since the last pack:

        1. the batch is complete (no blind mark, no structural node
           mutation, no cap overflow);
        2. every cluster version bump since the last pack's base has a
           matching logged event (``version delta == drained bumps`` —
           a mutation that bypassed the hooks breaks the equality);
        3. the status cache's set/delete counter is unchanged (the gang
           SET cannot have churned without it);
        4. every named entity resolves against the packer's lite state
           (pack_fold re-checks and bails to None otherwise).

        Any failure returns None and the caller runs the full scan (on
        the same device path) — correctness never depends on hook
        coverage. Outcomes (``no-base``, ``blind``, ``structural``,
        ``overflow``, ``version-skew``, ``group-churn``, ``unknown-name``,
        ``folded``, ``packer-bail``) are counted in ``fold_outcomes``; only
        ``folded`` served the O(churn) pack. The reference's ``disabled``
        needs its BST_EVENT_FOLD knob, which the port does not have."""
        batch = self._event_log.drain()
        snap = None
        if self._fold_version is None or version_base is None:
            outcome = "no-base"
        elif not batch.complete:
            outcome = (
                "blind" if batch.blind
                else "structural" if batch.structural
                else "overflow"
            )
        elif version_base - self._fold_version != batch.bumps:
            outcome = "version-skew"
        elif mut_base is None or self._fold_mut_base != mut_base:
            outcome = "group-churn"
        else:
            node_updates = list(
                _nodes_requested(cluster, sorted(batch.node_names)).items()
            )
            group_updates = []
            unresolved = False
            # one lock pass for every named gang: the status cache's lock
            # is taken per event by the controller's workers and the
            # scheduling thread, and a contended acquisition per gang
            # hands the interpreter lock away each time
            statuses = status_cache.snapshot()
            for full_name in sorted(batch.group_names):
                pgs = statuses.get(full_name)
                if pgs is None:
                    unresolved = True
                    break
                group_updates.append(demand_from_status(full_name, pgs))
            if unresolved:
                outcome = "unknown-name"
            else:
                with trace_mod.span("oracle.event_fold", cat="oracle"):
                    snap = self._packer.pack_fold(node_updates, group_updates)
                outcome = "folded" if snap is not None else "packer-bail"
                if snap is not None:
                    # the drained, name-coalesced batch this pack consumed
                    # (node dicts copied: node_requested returns live
                    # accounting)
                    snap.event_fold = {
                        "bumps": int(batch.bumps),
                        "nodes": [(name, dict(d)) for name, d in node_updates],
                        "groups": [
                            (g.full_name, _demand_fp(g)) for g in group_updates
                        ],
                    }
        with self._stats_lock:
            self.fold_outcomes[outcome] = self.fold_outcomes.get(outcome, 0) + 1
        self.last_fold_outcome = outcome
        DEFAULT_REGISTRY.counter(
            "bst_event_folds_total",
            "Event-fold refresh attempts by outcome (folded = O(churn) "
            "pack served; every other outcome fell back to the full scan)",
        ).inc(outcome=outcome)
        return snap

    def _note_pack(self, snap) -> None:  # lock-held: _refresh_lock
        """Per-pack hook: bring the device-resident state up to this pack
        (every pack — the holder mirrors the PACKER's buffers, so
        generation contiguity holds pack to pack), the node policy columns
        too when the snapshot carries them."""
        t0 = time.perf_counter()
        # host wall time of enqueueing the row scatters on the scorer's
        # stream: the scatters themselves run asynchronously
        with trace_mod.span("oracle.device_state_sync", cat="oracle"):
            snap.device_state_args = self._device_state.sync(snap)
            if snap.policy_cols is not None:
                snap.device_state_policy_cols = (
                    self._device_state.sync_policy_cols(snap)
                )
        with self._stats_lock:
            self.sync_seconds.append(time.perf_counter() - t0)
            del self.sync_seconds[:-1000]

    def _audit_publish(self, snap, host, audit_id, speculative: bool = False) -> None:
        """Durable evidence for one PUBLISHED batch: the audit record (the
        exact padded host inputs + plan digest, enqueued to the daemon
        writer) and the sampled identity audit, under the batch's audit id
        (``refresh`` passes the one a remote batch announced on the wire,
        else a fresh one, which its capacity sample shares). A
        degraded (conservative fallback) batch is recorded as such and
        never identity-audited: it has no plan to verify.
        The record holds the snapshot's HOST columns (``device_args()``,
        and a policy batch's ``policy_payload()``), not the resident
        tensors the batch ran on: replaying the host columns is what proves
        the two agreed. Evidence collection never fails the decision path;
        each swallowed error is counted in ``audit_errors``."""
        try:
            digest = audit_mod.plan_digest(host)
            policy = snap.policy_payload()
            if self.audit_log is not None:
                # gangs per cardinality-capped tenant label: one registry
                # hit per DISTINCT namespace, not per gang
                tenants: Dict[str, int] = {}
                for ns, count in self._tenancy(snap).items():
                    label = tenancy.tenant_label(ns)
                    tenants[label] = tenants.get(label, 0) + count
                extra = {"tenants": tenants}
                # the refresh's provenance rides the audit stream: which
                # rows this pack rewrote and which path produced it
                delta = snap.delta
                if delta is not None:
                    extra["refresh"] = {
                        "generation": int(delta.generation),
                        "kind": delta.kind,
                        "reason": delta.reason,
                        "source": delta.source,
                        "node_rows": [int(i) for i in delta.node_rows],
                        "group_rows": [int(i) for i in delta.group_rows],
                        "meta_rows": [int(i) for i in delta.meta_rows],
                    }
                ctx = trace_mod.current_context()
                self.audit_log.record_batch(
                    batch_args=snap.device_args(),
                    progress_args=snap.progress_args(),
                    result=host,
                    plan_digest=digest,
                    node_names=snap.node_names,
                    group_names=snap.group_names,
                    audit_id=audit_id,
                    trace_id=ctx[0] if ctx else None,
                    telemetry=host.get("telemetry") or {},
                    speculative=speculative,
                    degraded=bool(self.degraded),
                    extra=extra,
                    policy=policy,
                    # audit v2 payloads (no-ops under the array format):
                    # the drained event batch a fold pack consumed, and
                    # the snapshot-lite re-fold base a keyframe carries
                    event_fold=snap.event_fold,
                    refold=(
                        (snap.schema, snap.lite_fps)
                        if snap.lite_fps is not None else None
                    ),
                )
            # a served speculative batch equals the blocking refresh it
            # replaces (the consume-time generation check), as in the
            # reference it is recorded but not identity-audited
            if (
                self._identity is not None
                and not speculative
                and not self.degraded
            ):
                self._identity.note_batch(
                    snap.device_args(), snap.progress_args(), digest, audit_id,
                    self.audit_log, policy=policy,
                )
        except Exception:  # noqa: BLE001 — evidence, never the decision path
            self.audit_errors += 1

    def _capacity_sample(self, snap, host, audit_id, resident) -> None:
        """Budget-gated capacity-observatory hook (ops.capacity): one
        analytics pass over exactly the committed inputs this batch scored
        — the resident tensors on the scorer's device (on its stream), so
        the big arrays never leave the card; a scorer without a local
        device (a remote scorer) passes the snapshot's host arrays to the
        CPU. Evidence collection, never the decision path: every error is
        swallowed (the sampler counts its own under the ``error``
        outcome)."""
        try:
            batch_args = resident if resident is not None else snap.device_args()
            progress = snap.progress_args()
            cols = snap.policy_cols
            self._capacity.note_batch(
                batch_args, host,
                group_names=snap.group_names,
                lane_names=list(snap.schema.names),
                scheduled=progress[1], matched=progress[2],
                policy_prio=cols[0] if cols is not None else None,
                audit_log=self.audit_log, audit_id=audit_id,
                device=self.device if self.device is not None else "cpu",
            )
        except Exception:  # noqa: BLE001 — analytics never fail publish
            pass

    def _tenancy(self, snap) -> Dict[str, int]:
        """``_snapshot_tenancy(snap)``, kept while the packer serves the same
        gang-name list (a lite or fold snapshot shares its packer's, which
        is never changed in place): one O(G) pass per change of the gang
        set, not per batch."""
        names = snap.group_names
        memo = self._tenancy_memo
        if memo is None or memo[0] is not names:
            memo = self._tenancy_memo = (names, _snapshot_tenancy(snap))
        return memo[1]

    def dominant_tenant(self, snap) -> str:
        """The batch's dominant tenant LABEL: the namespace with the most
        gangs (ties to the first name), through the cardinality-capped
        registry (``utils.tenancy``) — what a remote scorer announces on
        the wire (the TENANT frame). "" when no gang is namespaced."""
        ns_counts = self._tenancy(snap)
        if not ns_counts:
            return ""
        return tenancy.tenant_label(
            min(ns_counts, key=lambda ns: (-ns_counts[ns], ns))
        )

    def _execute(self, snap: ClusterSnapshot):
        """Run one batch on this scorer's device: ``(host, device_result)``.
        A subclass may instead return ``(host, row_fetcher)``, a callable
        ``(kind, g) -> row`` (``_BatchState``), and ride the ``_degraded``
        / ``_audit_id`` markers on ``host`` (consumed by ``refresh``).
        The batch reads the resident tensors the pack's sync produced (a
        policy batch its resident node policy columns too); the snapshot
        then drops them (the next scatter rewrites them in place), keeping
        only its host arrays."""
        batch_args, policy = self._batch_inputs(snap)
        # the batch's dominant tenant labels the scan counter
        # (ops.oracle.collect_batch), cleared so a reused thread never
        # inherits it
        tenancy.set_batch_tenant(self.dominant_tenant(snap))
        try:
            return execute_batch_host(
                batch_args, snap.progress_args(), device=self.device, policy=policy,
                request_lanes=_request_lanes(snap),
            )
        finally:
            tenancy.set_batch_tenant(None)

    def _batch_inputs(self, snap: ClusterSnapshot):
        """The resident tensors and policy payload one batch reads, taken
        off the snapshot (which keeps only its host arrays)."""
        batch_args = snap.device_state_args
        snap.device_state_args = None
        policy = snap.policy_payload()
        if policy is not None:
            self.policy_engine.note_batch()
            policy = (snap.device_state_policy_cols, policy[1], policy[2])
            snap.device_state_policy_cols = None
        return batch_args, policy

    def _dispatch_ahead(self, snap: ClusterSnapshot):
        """Enqueue one batch WITHOUT waiting for it (``dispatch_batch``, on
        the caller's current stream: the scorer's) and return the
        zero-argument ``finish`` that collects it into ``_execute``'s
        ``(host, rows)``. A subclass whose batch runs elsewhere
        (RemoteScorer) runs it here and returns its result."""
        batch_args, policy = self._batch_inputs(snap)
        pending = dispatch_batch(
            batch_args, snap.progress_args(), device=self.device, policy=policy,
            request_lanes=_request_lanes(snap),
        )
        tenant = self.dominant_tenant(snap)

        def finish():
            tenancy.set_batch_tenant(tenant)
            try:
                return collect_batch(pending)
            finally:
                tenancy.set_batch_tenant(None)

        return finish

    def stats(self) -> dict:
        """Refresh-path counters: fold outcomes, the packer's pack counts
        and the device holder's keyframes / scatters / derivations; and
        the audit layer's (``audit``: errors swallowed at publish, the
        audit log's and the identity auditor's counters when attached)."""
        with self._stats_lock:
            fold_outcomes = dict(self.fold_outcomes)
        out = {
            "batches_run": self.batches_run,
            "fold_outcomes": fold_outcomes,
            "packer": self._packer.stats(),
            "device_state": (
                self._device_state.stats()
                if self._device_state is not None else None
            ),
        }
        log = self._event_log
        if log is not None:
            out["event_log"] = log.stats()
        if self.dispatch_ahead or self.spec_dispatched:
            out["spec_served"] = self.spec_served
            out["spec_discarded"] = self.spec_discarded
            out["spec_dispatched"] = self.spec_dispatched
        audit = {"publish_errors": self.audit_errors}
        if self.audit_log is not None:
            audit.update(self.audit_log.stats())
        if self._identity is not None:
            audit.update(self._identity.stats())
        out["audit"] = audit
        if self._warmer is not None:
            out.update(self._warmer.stats())
        return out

    def _set_degraded(self, flag: bool) -> None:
        """Install the served batch's degradedness (at publication, in
        ``refresh``). RemoteScorer mirrors the flip into its metrics."""
        self.degraded = flag

    def _probe_due(self) -> bool:
        """Whether a degraded batch is worth re-attempting now (RemoteScorer
        asks its client's breaker): while the cooldown runs, the fallback
        batch is served as an ordinary fresh batch."""
        return True

    def _stale(self, cluster) -> bool:
        if self._dirty_gen != self._clean_gen or self._state is None:
            return True
        if self.degraded and self._probe_due():
            # a conservative fallback batch expires the moment the
            # transport is worth probing again, so recovery needs no
            # cluster change to trigger it
            return True
        version_fn = getattr(cluster, "version", None)
        if callable(version_fn):
            with self._credits_lock:
                credits = self._version_credits
            if version_fn() - credits != self._cluster_version:
                return True
        return False

    def _group_missing(self, group: Optional[str]) -> bool:
        return group is not None and (
            self._state is None
            or self._state.snapshot.group_index(group) is None
        )

    def ensure_fresh(
        self, cluster, status_cache: PGStatusCache, group: Optional[str] = None
    ) -> None:
        """Re-batch if dirty, the cluster changed, or ``group`` (a group the
        caller is about to query) is missing from the cached snapshot —
        newly created PodGroups must not be denied off a stale batch.

        With ``min_batch_interval`` > 0, a merely-stale batch (the queried
        group is known) is served as-is until the interval elapses; with
        ``background_refresh`` it is re-batched on a daemon thread instead
        of on the caller's; with ``dispatch_ahead`` a blocking re-batch
        first tries the banked speculative batch."""
        if not self._stale(cluster):
            if not self._group_missing(group):
                return
        elif not self._group_missing(group) and self._state is not None:
            if (
                self.min_batch_interval > 0
                and time.monotonic() - self._last_batch_t < self.min_batch_interval
            ):
                return
            if self.background_refresh and self._bg_error is None:
                self._kick_background_refresh(cluster, status_cache)
                return
        published = False
        with self._refresh_lock:
            if self._stale(cluster) or self._group_missing(group):
                if self._consume_speculative(cluster, group):
                    published = True
                else:
                    # a background or speculative failure is consumed
                    # here: this blocking refresh either succeeds
                    # (recovery) or raises into the caller's cycle
                    self._bg_error = None
                    self._spec_error = None
                    self.refresh(cluster, status_cache)
                    published = True
        if published and self.dispatch_ahead:
            self._kick_speculative(cluster, status_cache)

    def drain_background(self, timeout: float = 60.0) -> bool:
        """Wait out any in-flight background or speculative batch, then
        collect (and drop) a banked speculative batch, so no batch stays
        dispatched and uncollected (``ops.oracle.inflight_batches``) and
        no daemon thread dies inside a CUDA call at teardown. The flag
        flips and the thread reads share the kick paths' locks, so no new
        thread starts after this returns. Returns True when nothing is
        left in flight."""
        with self._bg_lock:
            self.background_refresh = False  # no new kicks after the drain
            t = self._bg_thread
        with self._spec_lock:
            self.dispatch_ahead = False
            spec_t = self._spec_thread
        ok = True
        # the warmer stops first: it is a batch producer of its own, and
        # its thread must not be inside a CUDA call at teardown
        if self._warmer is not None:
            ok = self._warmer.stop(timeout) and ok
        for name, th in (("background", t), ("dispatch-ahead", spec_t)):
            if th is not None and th.is_alive():
                th.join(timeout)
                if th.is_alive():
                    print(
                        f"drain_background: {name} batch still in flight "
                        f"after {timeout}s",
                        file=sys.stderr,
                    )
                    ok = False
        if ok:
            with self._refresh_lock:
                spec, self._spec = self._spec, None
            if spec is not None:
                with torch.cuda.stream(self.stream):
                    spec[1]()
        if self._identity is not None:
            ok = self._identity.drain(timeout) and ok
        return ok

    # -- dispatch-ahead ---------------------------------------------------

    def _consume_speculative(self, cluster, group: Optional[str]) -> bool:  # lock-held: _refresh_lock
        """Publish the banked speculative batch iff NOTHING changed since
        it was packed — the generation and the raw cluster version, with
        no credit forgiveness (a credited bump is an assume the
        speculative snapshot may predate). Either way the batch is
        collected (its blob waited for), so nothing stays in flight.
        Returns True when the batch was published."""
        spec = self._spec
        if spec is None:
            return False
        self._spec = None  # consumed either way
        snap, finish, gen, version, pack_s, dispatch_s, resident = spec
        t0 = time.perf_counter()
        with torch.cuda.stream(self.stream):
            host, rows = finish()
        batch_s = dispatch_s + time.perf_counter() - t0
        version_fn = getattr(cluster, "version", None)
        current_version = version_fn() if callable(version_fn) else None
        spec_counter = DEFAULT_REGISTRY.counter(
            "bst_oracle_spec_batches_total",
            "Dispatch-ahead speculative batches by outcome (served = "
            "published without a blocking device round-trip; discarded = "
            "invalidated by a mid-flight cluster change)",
        )
        if (
            gen != self._dirty_gen
            or current_version != version
            or (group is not None and snap.group_index(group) is None)
        ):
            self.spec_discarded += 1
            spec_counter.inc(outcome="discarded")
            return False
        self._publish(snap, host, rows, gen, version, pack_s, batch_s,
                      resident, speculative=True)
        self.spec_served += 1
        spec_counter.inc(outcome="served")
        return True

    def _kick_speculative(self, cluster, status_cache: PGStatusCache) -> None:
        """Pack and enqueue the NEXT batch on a daemon thread so a later
        ensure_fresh can publish it without a blocking round trip. At most
        one in flight; a failure parks the mode until the next successful
        blocking refresh."""
        with self._spec_lock:
            if not self.dispatch_ahead or self._spec_error is not None:
                return
            if self._spec_thread is not None and self._spec_thread.is_alive():
                return

            def _run() -> None:
                try:
                    with self._refresh_lock:
                        if self._spec is not None:
                            return  # an unconsumed batch is already banked
                        with torch.cuda.stream(self.stream):
                            snap, gen, version, pack_s = self._pack_current(
                                cluster, status_cache
                            )
                            # invalidated while packing: consume would
                            # discard it anyway, so skip the batch
                            version_fn = getattr(cluster, "version", None)
                            if gen != self._dirty_gen or (
                                callable(version_fn) and version_fn() != version
                            ):
                                return
                            resident = getattr(snap, "device_state_args", None)
                            t1 = time.perf_counter()
                            with trace_mod.span(
                                "oracle.spec_batch", cat="oracle",
                                groups=len(snap.group_names),
                                nodes=len(snap.node_names),
                            ):
                                finish = self._dispatch_ahead(snap)
                            self._spec = (
                                snap, finish, gen, version, pack_s,
                                time.perf_counter() - t1, resident,
                            )
                            self.spec_dispatched += 1
                except Exception as e:  # noqa: BLE001 — surfaced via consume
                    self._spec_error = e

            self._spec_thread = threading.Thread(
                target=_run, name="oracle-dispatch-ahead", daemon=True
            )
            self._spec_thread.start()

    def _kick_background_refresh(self, cluster, status_cache: PGStatusCache) -> None:
        with self._bg_lock:
            # recheck under the lock: ensure_fresh's unlocked read can race
            # a concurrent drain_background, and spawning after the drain
            # would start a batch the drain no longer waits for
            if not self.background_refresh:
                return
            if self._bg_thread is not None and self._bg_thread.is_alive():
                return

            def _run() -> None:
                try:
                    with self._refresh_lock:
                        if self._stale(cluster):
                            self.refresh(cluster, status_cache)
                except Exception as e:  # noqa: BLE001 — surfaced via _bg_error
                    self._bg_error = e

            self._bg_thread = threading.Thread(
                target=_run, name="oracle-refresh", daemon=True
            )
            self._bg_thread.start()

    # -- query API (host-side, post-batch) ---------------------------------

    def max_group(self) -> str:
        state = self._state
        return state.max_group if state is not None else ""

    def gang_feasible(self, full_name: str) -> bool:
        state = self._state
        g = state.snapshot.group_index(full_name) if state else None
        return bool(state.result["gang_feasible"][g]) if g is not None else False

    def placed(self, full_name: str) -> bool:
        state = self._state
        g = state.snapshot.group_index(full_name) if state else None
        return bool(state.result["placed"][g]) if g is not None else False

    def node_capacity(self, full_name: str, node_name: str) -> int:
        state = self._state
        if state is None:
            return 0
        g = state.snapshot.group_index(full_name)
        n = state.snapshot.node_index(node_name)
        if g is None or n is None:
            return 0
        try:
            return int(state.row("capacity", g)[n])
        except StaleBatchError:
            # the remote batch's rows are gone (a newer batch on its
            # connection, or a reconnect): answer conservatively now and
            # invalidate, so the next ensure_fresh re-batches. Only this
            # class is swallowed: a dead transport must surface.
            self.mark_dirty()
            return 0

    def feasible_node_count(self, full_name: str) -> Optional[int]:
        """How many (real) nodes could hold at least one member of this
        gang, per the served batch's capacity row; None when the gang or
        batch is unknown."""
        state = self._state
        g = state.snapshot.group_index(full_name) if state else None
        if g is None:
            return None
        try:
            row = state.row("capacity", g)
        except StaleBatchError:
            self.mark_dirty()  # see node_capacity
            return None
        n_real = len(state.snapshot.node_names)
        return int((row[:n_real] > 0).sum())

    def node_score(self, full_name: str, node_name: str) -> int:
        state = self._state
        if state is None:
            return -(2**30)
        g = state.snapshot.group_index(full_name)
        n = state.snapshot.node_index(node_name)
        if g is None or n is None:
            return -(2**30)
        try:
            return int(state.row("scores", g)[n])
        except StaleBatchError:
            self.mark_dirty()  # see node_capacity
            return -(2**30)

    def assignment(self, full_name: str) -> Dict[str, int]:
        """node name -> member count placed there for this gang's batch plan
        (from the compact top-K output; exact for gangs spanning <= K nodes)."""
        state = self._state
        g = state.snapshot.group_index(full_name) if state else None
        if g is None:
            return {}
        names = state.snapshot.node_names
        nodes_row = state.result["assignment_nodes"][g]
        counts_row = state.result["assignment_counts"][g]
        out: Dict[str, int] = {}
        for idx, count in zip(nodes_row, counts_row):
            if count <= 0:
                continue
            if idx < len(names):
                out[names[int(idx)]] = int(count)
        return out
