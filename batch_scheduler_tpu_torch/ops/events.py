"""Bounded host event log: the O(churn) refresh feed.

Cluster, bind and permit mutations append the NAMES of the entities whose
oracle-visible state changed (a node's requested view, a gang's demand
row) instead of the mutation payloads. The scorer drains the log once
per refresh and re-reads just the named entities from the live cluster
state, so an event that raced the drain window re-folds harmlessly on
the next pack — the fold is idempotent by construction, which is what
lets producers emit outside any scorer lock.

The log is name-coalesced: N mutations to one node are one entry. What
it must track exactly is the NUMBER of cluster version bumps it saw
(``note_bump`` per ``ClusterState._version += 1``) so the scorer can
prove completeness — if ``version_now - version_at_last_pack`` does not
equal the drained bump count, some mutation bypassed the hooks and the
fold falls back to the full O(N+G) scan (always correct, never stale).

Capacity is bounded by ``EventLog.cap`` (``EVENT_LOG_CAP`` unless the
constructor says otherwise); hitting the cap sets the overflow flag and
the next drain reports incomplete (scan fallback), exactly like a blind
mark from an uninstrumented mutation path.

The port of ``batch_scheduler_tpu/ops/events.py``; its Prometheus
counters are plain counters here, read through ``stats()``, and the
fold and the cap are not environment knobs: the fold is always on, and
the cap is a constant.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import FrozenSet

__all__ = ["EVENT_LOG_CAP", "EventLog", "EventBatch"]


# the bound on distinct names the log coalesces before it declares
# overflow (the reference's BST_EVENT_LOG_CAP default)
EVENT_LOG_CAP = 4096


@dataclass(frozen=True)
class EventBatch:
    """One drain's worth of pending events.

    ``complete`` is the fold-eligibility verdict from the log's own side:
    no blind marks, no overflow, no structural (node-object) mutation
    since the last drain. The scorer layers its own checks on top
    (version-bump accounting, status-cache mutation counter, resolvable
    names) before trusting a targeted fold."""

    node_names: FrozenSet[str] = frozenset()
    group_names: FrozenSet[str] = frozenset()
    bumps: int = 0
    blind: bool = False
    structural: bool = False
    overflow: bool = False

    @property
    def complete(self) -> bool:
        return not (self.blind or self.structural or self.overflow)

    @property
    def empty(self) -> bool:
        return not (self.node_names or self.group_names or self.bumps
                    or self.blind or self.structural or self.overflow)


class EventLog:
    """Thread-safe bounded, name-coalescing event accumulator.

    Producers (ClusterState mutators via ``subscribe_events``, the
    operation layer's gang hints, blind ``mark_dirty`` fallbacks) only
    ever append; the single consumer (the scorer's refresh path, under
    its refresh lock) drains. Producers may call under the cluster lock:
    the log takes only its own ``_lock``, which never takes the cluster
    lock back, so there is no ordering cycle.
    """

    def __init__(self, cap: int = EVENT_LOG_CAP, label: str = "scorer"):
        self.label = label
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._node_names: set = set()  # guarded-by: _lock
        self._group_names: set = set()  # guarded-by: _lock
        self._bumps = 0  # guarded-by: _lock
        self._blind = False  # guarded-by: _lock
        self._structural = False  # guarded-by: _lock
        self._overflow = False  # guarded-by: _lock
        self.appended = 0  # guarded-by: _lock
        self.appended_by_kind: dict = {}  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        self.blind_marks = 0  # guarded-by: _lock
        self.drains = 0  # guarded-by: _lock

    # -- internals (lock-held) ---------------------------------------------

    def _depth(self) -> int:  # lock-held: _lock
        return len(self._node_names) + len(self._group_names)

    def _add(self, names, target: set, kind: str) -> None:  # lock-held: _lock
        for name in names:
            if name in target:
                continue
            if self._depth() >= self.cap:
                self._overflow = True
                self.dropped += 1
                continue
            target.add(name)
        self.appended += 1
        self.appended_by_kind[kind] = self.appended_by_kind.get(kind, 0) + 1

    # -- producer API -------------------------------------------------------

    def note_bump(self, kind: str, names=()) -> None:
        """One cluster version bump: ``names`` are the nodes whose
        requested view changed under it (may be empty — e.g. a no-op
        release). ``kind == "node-object"`` marks a structural mutation
        (add/update/remove of the node OBJECT): the packer's lane schema
        may have moved, so the batch reports incomplete and the next
        refresh scans."""
        with self._lock:
            self._bumps += 1
            if kind == "node-object":
                self._structural = True
            self._add(names, self._node_names, kind)

    def note_group(self, full_name: str) -> None:
        """A gang's demand row changed (permit/bind/register progress)."""
        with self._lock:
            self._add((full_name,), self._group_names, "group")

    def note_blind(self) -> None:
        """A mutation with no event attribution (legacy ``mark_dirty``
        callers): the next drain reports incomplete and the refresh falls
        back to the full scan — correctness never depends on coverage."""
        with self._lock:
            self._blind = True
            self.blind_marks += 1

    # -- consumer API -------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return self._depth()

    def drain(self) -> EventBatch:
        """Snapshot-and-reset the pending events. The single consumer is
        the scorer's refresh path (serialized by its refresh lock)."""
        with self._lock:
            batch = EventBatch(
                node_names=frozenset(self._node_names),
                group_names=frozenset(self._group_names),
                bumps=self._bumps,
                blind=self._blind,
                structural=self._structural,
                overflow=self._overflow,
            )
            self._node_names.clear()
            self._group_names.clear()
            self._bumps = 0
            self._blind = False
            self._structural = False
            self._overflow = False
            self.drains += 1
            return batch

    def stats(self) -> dict:
        with self._lock:
            return {
                "label": self.label,
                "cap": self.cap,
                "depth": self._depth(),
                "bumps_pending": self._bumps,
                "appended": self.appended,
                "appended_by_kind": dict(self.appended_by_kind),
                "dropped": self.dropped,
                "blind_marks": self.blind_marks,
                "drains": self.drains,
                "blind_pending": self._blind,
                "structural_pending": self._structural,
                "overflow_pending": self._overflow,
            }
