"""OracleScorer: the batch scoring strategy on the port's device.

Packs the live PodGroup status cache + cluster state into one
ClusterSnapshot (numpy), runs the batch (``ops.oracle.execute_batch_host``:
the head, the CUDA assignment scan, the compaction and one blob copy), and
serves the per-group / per-node answers the scheduling callbacks need from
the cached host results, reading [G,N] rows from the device on demand.

The port of ``batch_scheduler_tpu/core/oracle_scorer.py``'s blocking
in-process path: generation-based dirty tracking, cluster-version credits
and the query API. It subsumes the reference's findMaxPG +
compareClusterResourceAndRequire serial loops (reference pkg/scheduler/
core/core.go:514-632,701-739) with exact batch answers.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..cache.pg_cache import PGStatusCache, PodGroupMatchStatus
from ..ops.convert import resolve_device
from ..ops.oracle import execute_batch_host
from ..ops.snapshot import ClusterSnapshot, GroupDemand

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
        """Fetch (and cache) one group's row of a [G,N] tensor."""
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
    construction on a machine without CUDA) or ``cpu``."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
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
        # host pack / device batch seconds of the recent batches
        self.pack_seconds: list = []  # guarded-by: _stats_lock
        self.batch_seconds: list = []  # guarded-by: _stats_lock
        self._stats_lock = threading.Lock()

    def mark_dirty(self, group: Optional[str] = None) -> None:
        """Invalidate the served batch. ``group`` names the gang whose row
        changed (kept for the reference's call signature; every refresh
        here is a full pack)."""
        self._dirty_gen += 1

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
        """Rebuild the snapshot and run one batch."""
        t0 = time.perf_counter()
        dirty_gen = self._dirty_gen
        version_fn = getattr(cluster, "version", None)
        version_base = version_fn() if callable(version_fn) else None
        nodes, node_req, demands = read_cluster_inputs(cluster, status_cache)
        snap = ClusterSnapshot(nodes, node_req, demands)
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
        with self._stats_lock:
            self.pack_seconds.append(t1 - t0)
            self.batch_seconds.append(t2 - t1)
            del self.pack_seconds[:-1000], self.batch_seconds[:-1000]

    def _execute(self, snap: ClusterSnapshot):
        """Run one batch on this scorer's device: ``(host, device_result)``."""
        return execute_batch_host(
            snap.device_args(), snap.progress_args(), device=self.device
        )

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
