"""In-memory PodGroup scheduling-state cache.

Equivalent of the reference's ``pkg/scheduler/cache``
(reference pkg/scheduler/cache/cache.go:30-116): a thread-safe map from
PodGroup full name to its live match status, where per-group TTL caches hold
the permitted-but-unbound pod→node pairs. TTL expiry of the pod-name→UID
cache is the gang timeout signal (see controller wiring).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from ..api.types import Pod, PodGroup
from ..utils.ttl_cache import TTLCache

__all__ = ["PodNodePair", "PodGroupMatchStatus", "PGStatusCache"]

# go-cache defaults used by the reference when building per-group caches
# (reference pkg/scheduler/controller/controller.go:317-318).
DEFAULT_MATCH_TTL = 60.0
DEFAULT_JANITOR_INTERVAL = 2.0


@dataclass
class PodNodePair:
    """A permitted pod and its chosen node
    (reference pkg/scheduler/cache/cache.go:70-73)."""

    pod_name: str  # "namespace/name"
    node: str


class PodGroupMatchStatus:
    """Live gang bookkeeping for one PodGroup
    (reference pkg/scheduler/cache/cache.go:52-67)."""

    def __init__(
        self,
        pod_group: PodGroup,
        match_ttl: float = DEFAULT_MATCH_TTL,
        janitor_interval: float = DEFAULT_JANITOR_INTERVAL,
        clock=None,
    ):
        kwargs = {} if clock is None else {"clock": clock}
        self.pod_group = pod_group
        # permitted pod UID -> PodNodePair, TTL = gang wait time
        self.matched_pod_nodes = TTLCache(match_ttl, janitor_interval, **kwargs)
        # "namespace/podName" -> pod UID, TTL = gang wait time; its expiry
        # callback is the gang abort trigger.
        self.pod_name_uids = TTLCache(match_ttl, janitor_interval, **kwargs)
        self.failed: Dict[str, str] = {}
        self.succeed: Dict[str, str] = {}
        self.count_lock = threading.RLock()
        # A representative member pod; fixes the group's per-member resource
        # shape when spec.min_resources is unset (reference core.go:486-493).
        self.pod: Optional[Pod] = None
        # True once the gang has been released to bind at least once.
        self.scheduled = False
        # Binds THIS scheduler committed (PostBind-side counter). The
        # status.scheduled field has two monotone lower-bound sources —
        # this counter and the controller's live member count — and
        # PostBind takes max(status.scheduled, binds_committed) instead of
        # blind addition, so the two writers commute: a controller count
        # that already includes a bind this counter later accounts cannot
        # double it (and vice versa for binds whose API responses were
        # lost, which only the controller ever sees).
        self.binds_committed = 0
        # Gang-granular admission plan (no reference equivalent — it admits
        # gangs pod by pod against a TTL cache, core.go:268-309): the oracle
        # batch that places this gang stamps its node->member-count plan
        # here, and member pods ride pre_filter/permit/select off the plan
        # without re-running the batch per pod. ``plan_base_matched`` is the
        # matched-per-node counter at stamp time: slots consumed on a node =
        # current matched there minus the base, so evicted/rejected permits
        # automatically re-open their slots.
        self.placement_plan: Optional[Dict[str, int]] = None
        self.plan_base_matched: Dict[str, int] = {}
        self.plan_batch_seq: int = -1

    def close(self) -> None:
        self.matched_pod_nodes.close()
        self.pod_name_uids.close()


class PGStatusCache:
    """Thread-safe full-name -> PodGroupMatchStatus map
    (reference pkg/scheduler/cache/cache.go:45-116)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._map: Dict[str, PodGroupMatchStatus] = {}  # guarded-by: _lock
        # monotone set/delete counter: the scorer's event fold compares it
        # across refreshes to prove the GROUP SET could not have changed
        # without an event (a silently added/removed entry would otherwise
        # let a targeted fold serve a wrong-group-set snapshot)
        self._mutations = 0  # guarded-by: _lock

    def mutations(self) -> int:
        """Monotone count of set/delete calls (membership churn proxy)."""
        with self._lock:
            return self._mutations

    def get(self, full_name: str) -> Optional[PodGroupMatchStatus]:
        with self._lock:
            return self._map.get(full_name)

    def set(self, full_name: str, status: PodGroupMatchStatus) -> None:
        with self._lock:
            self._map[full_name] = status
            self._mutations += 1

    def delete(self, full_name: str) -> None:
        with self._lock:
            status = self._map.pop(full_name, None)
            self._mutations += 1
        if status is not None:
            status.close()

    def snapshot(self) -> Dict[str, PodGroupMatchStatus]:
        """Consistent point-in-time view for batch scoring."""
        with self._lock:
            return dict(self._map)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)
