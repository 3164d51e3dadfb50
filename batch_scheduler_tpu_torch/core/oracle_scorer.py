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

The port of ``batch_scheduler_tpu/core/oracle_scorer.py``'s blocking
in-process path: generation-based dirty tracking, cluster-version credits,
the event-fold refresh, device-resident state and the query API. It subsumes the reference's findMaxPG +
compareClusterResourceAndRequire serial loops (reference pkg/scheduler/
core/core.go:514-632,701-739) with exact batch answers.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cache.pg_cache import PGStatusCache, PodGroupMatchStatus
from ..ops.convert import device_stream, resolve_device
from ..ops.device_state import DeviceStateHolder
from ..ops.events import EventLog
from ..ops.oracle import execute_batch_host
from ..ops.snapshot import (
    ClusterSnapshot,
    DeltaSnapshotPacker,
    GroupDemand,
    _demand_fp,
)

__all__ = ["OracleScorer", "demand_from_status", "read_cluster_inputs"]


def read_cluster_inputs(cluster, status_cache: PGStatusCache):
    """ONE consistent read of the oracle's cluster inputs: (nodes,
    node_requested, demands) — the projection every snapshot pack
    consumes."""
    statuses = status_cache.snapshot()
    demands: List[GroupDemand] = [
        demand_from_status(name, pgs)
        for name, pgs in sorted(statuses.items())
    ]
    nodes = cluster.list_nodes()
    node_req = {
        n.metadata.name: cluster.node_requested(n.metadata.name)
        for n in nodes
    }
    return nodes, node_req, demands


def demand_from_status(full_name: str, pgs: PodGroupMatchStatus) -> GroupDemand:
    """Project a live PodGroupMatchStatus into the oracle's demand row."""
    pg = pgs.pod_group
    member_req = dict(pg.spec.min_resources or {})
    if not member_req and pgs.pod is not None:
        member_req = pgs.pod.resource_require()
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
    )


class _BatchState:
    """One immutable (snapshot, results) pair, swapped in atomically so
    concurrent readers never see a torn snapshot/result combination.
    ``result`` holds the O(G) host vectors; [G,N] rows are fetched from
    the device tensors lazily and cached."""

    __slots__ = ("snapshot", "result", "max_group", "device_result", "_rows", "_rows_lock")

    def __init__(self, snapshot: ClusterSnapshot, result: dict,
                 max_group: str, device_result: dict):
        self.snapshot = snapshot
        self.result = result
        self.max_group = max_group
        self.device_result = device_result
        self._rows: Dict[tuple, np.ndarray] = {}  # guarded-by: _rows_lock
        self._rows_lock = threading.Lock()

    def row(self, kind: str, g: int) -> np.ndarray:
        """Fetch (and cache) one group's row of a [G,N] tensor. The batch
        that wrote it is complete (its collect waited on the batch's
        event), and the copy is synchronous on the reader's stream, so the
        block is not freed while the read is pending."""
        key = (kind, g)
        with self._rows_lock:
            cached = self._rows.get(key)
        if cached is not None:
            return cached
        row = self.device_result[kind][g].cpu().numpy()
        with self._rows_lock:
            self._rows[key] = row
        return row


class OracleScorer:
    """Caches one batch of oracle results; invalidated by ``mark_dirty``.

    ``device`` is where batches run: ``cuda`` (default; raises at
    construction on a machine without CUDA) or ``cpu``. The packed
    buffers stay resident on that device, and each pack's churned rows
    are scattered into them. On CUDA every refresh enqueues its device
    work (the holder's uploads and scatters, the batch, the blob's copy)
    on the scorer's own ``stream``, whichever thread refreshes."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.stream = device_stream(self.device)
        # Dirty tracking is a GENERATION pair: refresh() records the
        # generation it observed BEFORE packing, so a mark_dirty landing
        # while the batch runs keeps the batch stale.
        self._dirty_gen = 1
        self._clean_gen = 0
        self._state: Optional[_BatchState] = None
        self._refresh_lock = threading.Lock()
        self._cluster_version = None
        self.batches_run = 0
        # Plan-covered cluster changes (member assumes/binds the current
        # batch already charged via its gang placement) are credited rather
        # than invalidating the batch.
        self._version_credits = 0  # guarded-by: _credits_lock
        self._credits_lock = threading.Lock()
        # Persistent packed host buffers (ops.snapshot.DeltaSnapshotPacker):
        # low-churn refreshes rewrite only the node/group rows that changed.
        self._packer = DeltaSnapshotPacker()
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
        # fold attempts by outcome (_try_fold), and the last one
        self.fold_outcomes: Dict[str, int] = {}  # guarded-by: _refresh_lock
        self.last_fold_outcome: Optional[str] = None  # guarded-by: _refresh_lock
        # Device-resident cluster state (ops.device_state): the packed
        # [N,R]/[G,R] buffers stay on the device across batches and each
        # pack's churned rows apply as one row scatter.
        self._device_state = DeviceStateHolder(self.device, label="scorer")
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
        return state.result["telemetry"] if state is not None else None

    def refresh(self, cluster, status_cache: PGStatusCache) -> None:
        """Pack the current state (event fold or scan) and run one batch.
        Callers serialize refreshes (``ensure_fresh`` holds the refresh
        lock)."""
        with torch.cuda.stream(self.stream):
            snap, dirty_gen, version_base, pack_s = self._pack_current(
                cluster, status_cache
            )
            t1 = time.perf_counter()
            host, device_result = self._execute(snap)
            t2 = time.perf_counter()
        max_group = (
            snap.group_names[int(host["best"])]
            if host["best_exists"] and int(host["best"]) < len(snap.group_names)
            else ""
        )
        self._state = _BatchState(snap, host, max_group, device_result)
        self._cluster_version = version_base
        self._clean_gen = dirty_gen  # compare-and-clear: later marks survive
        self.batches_run += 1
        # credits offset the OLD batch's staleness check and die with it
        with self._credits_lock:
            self._version_credits = 0
        path = (
            "keyframe" if snap.delta is None or snap.delta.kind == "keyframe"
            else "fold" if snap.delta.source == "events" else "scan"
        )
        with self._stats_lock:
            self.pack_seconds.append(pack_s)
            self.batch_seconds.append(t2 - t1)
            del self.pack_seconds[:-1000], self.batch_seconds[:-1000]
            by_path = self.pack_seconds_by_path.setdefault(path, [])
            by_path.append(pack_s)
            del by_path[:-1000]

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
            node_updates = [
                (name, cluster.node_requested(name))
                for name in sorted(batch.node_names)
            ]
            group_updates = []
            unresolved = False
            for full_name in sorted(batch.group_names):
                pgs = status_cache.get(full_name)
                if pgs is None:
                    unresolved = True
                    break
                group_updates.append(demand_from_status(full_name, pgs))
            if unresolved:
                outcome = "unknown-name"
            else:
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
        self.fold_outcomes[outcome] = self.fold_outcomes.get(outcome, 0) + 1
        self.last_fold_outcome = outcome
        return snap

    def _note_pack(self, snap) -> None:  # lock-held: _refresh_lock
        """Per-pack hook: bring the device-resident state up to this pack
        (every pack — the holder mirrors the PACKER's buffers, so
        generation contiguity holds pack to pack)."""
        t0 = time.perf_counter()
        snap.device_state_args = self._device_state.sync(snap)
        with self._stats_lock:
            self.sync_seconds.append(time.perf_counter() - t0)
            del self.sync_seconds[:-1000]

    def _execute(self, snap: ClusterSnapshot):
        """Run one batch on this scorer's device: ``(host, device_result)``.
        The batch reads the resident tensors the pack's sync produced; the
        snapshot then drops them (the next scatter rewrites them in
        place), keeping only its host arrays."""
        batch_args = snap.device_state_args
        snap.device_state_args = None
        return execute_batch_host(
            batch_args, snap.progress_args(), device=self.device
        )

    def stats(self) -> dict:
        """Refresh-path counters: fold outcomes, the packer's pack counts
        and the device holder's keyframes / scatters / derivations."""
        out = {
            "batches_run": self.batches_run,
            "fold_outcomes": dict(self.fold_outcomes),
            "packer": self._packer.stats(),
            "device_state": self._device_state.stats(),
        }
        log = self._event_log
        if log is not None:
            out["event_log"] = log.stats()
        return out

    def _stale(self, cluster) -> bool:
        if self._dirty_gen != self._clean_gen or self._state is None:
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
        caller is about to query) is missing from the cached snapshot."""
        if not self._stale(cluster) and not self._group_missing(group):
            return
        with self._refresh_lock:
            if self._stale(cluster) or self._group_missing(group):
                self.refresh(cluster, status_cache)

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
        return int(state.row("capacity", g)[n])

    def feasible_node_count(self, full_name: str) -> Optional[int]:
        """How many (real) nodes could hold at least one member of this
        gang, per the served batch's capacity row; None when the gang or
        batch is unknown."""
        state = self._state
        g = state.snapshot.group_index(full_name) if state else None
        if g is None:
            return None
        row = state.row("capacity", g)
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
        return int(state.row("scores", g)[n])

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
