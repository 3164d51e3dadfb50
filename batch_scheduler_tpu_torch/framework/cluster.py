"""ClusterState: the scheduler's live view of nodes and pod placements.

Plays the role of kube-scheduler's scheduler cache + snapshot shared lister
(what the reference reads via frameworkHandler.SnapshotSharedLister(),
core.go:437,567): nodes, per-node requested resources from bound pods, and
*assumed* pods — pods the scheduler has decided to place but whose binds
have not committed — so successive scheduling cycles see reserved capacity.

The port of ``batch_scheduler_tpu/framework/cluster.py``: the typed pod and
node mutators with the version counter and the event hooks
(``subscribe_events``) that make the scorer's O(churn) event fold
reachable; the scheduler's batch forms (``assume_many``,
``finish_binding_many``) and the informers' raw-dict forms
(``observe_pod_raw``, ``remove_pod_raw``), which emit into the event log
exactly what the reference's do; and ``pods_on`` (the preemption
planner's victim candidates). Implements core.ClusterStateProvider, so
both the serial scorer and the oracle snapshot pack straight from here.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

from ..api.types import Node, Pod, PodPhase

__all__ = ["ClusterState"]

_TERMINAL = (PodPhase.SUCCEEDED, PodPhase.FAILED)


class ClusterState:
    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[str, Node] = {}  # guarded-by: _lock
        # node -> pod uid -> canonical requested resources (incl. pod slot)
        self._requested: Dict[str, Dict[str, Dict[str, int]]] = {}  # guarded-by: _lock
        # pod uid -> node, for pods assumed but not yet observed bound
        self._assumed: Dict[str, str] = {}  # guarded-by: _lock
        self._pod_nodes: Dict[str, str] = {}  # guarded-by: _lock
        # pod uid -> Pod object, for victim search in the preemption cycle
        self._pod_objs: Dict[str, Pod] = {}  # guarded-by: _lock
        # bumped on every capacity-relevant change; the oracle scorer uses it
        # to invalidate its batch without explicit mark_dirty plumbing
        self._version = 0  # guarded-by: _lock
        # event subscribers (ops.events.EventLog.note_bump, weakly held):
        # the emission invariant is ONE _emit per _version += 1, each
        # naming the nodes whose requested view changed under that bump —
        # subscribers prove fold completeness by matching bump counts
        # against version deltas (ops.events)
        self._event_subs: list = []  # guarded-by: _lock

    def subscribe_events(self, fn) -> None:
        """Register a bound method called as ``fn(kind, names)`` once per
        version bump, under the cluster lock (callees must not call back
        into this state). ``kind`` is ``"node-object"`` for node add /
        update / remove (structural — lane schema may move) and
        ``"node-requested"`` for capacity accounting; ``names`` lists the
        affected node names. Held via weakref: a collected subscriber is
        pruned, never leaked."""
        with self._lock:
            self._event_subs.append(weakref.WeakMethod(fn))

    def _emit(self, kind: str, names=()) -> None:  # lock-held: _lock
        if not self._event_subs:
            return
        dead = []
        for ref in self._event_subs:
            fn = ref()
            if fn is None:
                dead.append(ref)
                continue
            try:
                fn(kind, names)
            except Exception:  # noqa: BLE001 — a broken subscriber must
                pass  # never poison informer handling; fold just degrades
        for ref in dead:
            self._event_subs.remove(ref)

    def version(self) -> int:
        with self._lock:
            return self._version

    # -- node lifecycle ----------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.metadata.name] = node
            self._requested.setdefault(node.metadata.name, {})
            self._version += 1
            self._emit("node-object", (node.metadata.name,))

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        with self._lock:
            self._nodes.pop(name, None)
            self._requested.pop(name, None)
            self._version += 1
            self._emit("node-object", (name,))

    # -- pod lifecycle -----------------------------------------------------

    @staticmethod
    def _require(pod: Pod) -> Dict[str, int]:
        req = dict(pod.resource_require())
        req["pods"] = req.get("pods", 0) + 1
        return req

    def assume(self, pod: Pod, node_name: str) -> None:
        """Reserve the pod's resources on the node before bind commits."""
        with self._lock:
            uid = pod.metadata.uid
            # a re-assume after a failed cycle must release the old node
            prev = self._pod_nodes.get(uid)
            if prev is not None and prev != node_name:
                self._requested.get(prev, {}).pop(uid, None)
            self._requested.setdefault(node_name, {})[uid] = self._require(pod)
            self._assumed[uid] = node_name
            self._pod_nodes[uid] = node_name
            self._pod_objs[uid] = pod
            self._version += 1
            touched = (
                (node_name,) if prev in (None, node_name)
                else (node_name, prev)
            )
            self._emit("node-requested", touched)

    def assume_many(self, pairs) -> None:
        """Batch form of :meth:`assume` — one lock pass for a whole gang's
        seat assignment (per-member acquisitions contend with the watch
        handlers ~quorum times per gang). ``pairs``: (pod, node_name)."""
        with self._lock:
            for pod, node_name in pairs:
                uid = pod.metadata.uid
                prev = self._pod_nodes.get(uid)
                if prev is not None and prev != node_name:
                    self._requested.get(prev, {}).pop(uid, None)
                self._requested.setdefault(node_name, {})[uid] = self._require(
                    pod
                )
                self._assumed[uid] = node_name
                self._pod_nodes[uid] = node_name
                self._pod_objs[uid] = pod
                touched = (
                    (node_name,) if prev in (None, node_name)
                    else (node_name, prev)
                )
                self._emit("node-requested", touched)
            self._version += len(pairs)

    def forget(self, pod_uid: str) -> None:
        """Drop an assumed pod whose permit/bind failed."""
        with self._lock:
            node = self._assumed.pop(pod_uid, None)
            if node is None:
                return
            self._pod_nodes.pop(pod_uid, None)
            self._pod_objs.pop(pod_uid, None)
            self._requested.get(node, {}).pop(pod_uid, None)
            self._version += 1
            self._emit("node-requested", (node,))

    def finish_binding(self, pod_uid: str) -> None:
        with self._lock:
            self._assumed.pop(pod_uid, None)

    def finish_binding_many(self, pod_uids) -> None:
        with self._lock:
            for uid in pod_uids:
                self._assumed.pop(uid, None)

    def observe_pod(self, pod: Pod) -> None:
        """Apply an informer event for a pod: bound pods charge their node,
        terminal pods release it.

        The version only bumps when the *capacity view* actually changes:
        the assumed→bound transition of a pod already charged to the same
        node with the same request is a no-op here, so a gang member's bind
        commit does not invalidate the oracle batch that planned it."""
        if not pod.spec.node_name:
            return
        with self._lock:
            uid = pod.metadata.uid
            node = pod.spec.node_name
            if pod.status.phase in _TERMINAL:
                charged = self._requested.get(node, {}).pop(uid, None)
                known = self._pod_nodes.pop(uid, None)
                self._assumed.pop(uid, None)
                self._pod_objs.pop(uid, None)
                if charged is not None or known is not None:
                    self._version += 1
                    self._emit("node-requested", (node,))
                return
            req = self._require(pod)
            unchanged = (
                self._pod_nodes.get(uid) == node
                and self._requested.get(node, {}).get(uid) == req
            )
            prev = self._pod_nodes.get(uid)
            if prev is not None and prev != node:
                self._requested.get(prev, {}).pop(uid, None)
            self._requested.setdefault(node, {})[uid] = req
            self._pod_nodes[uid] = node
            self._pod_objs[uid] = pod
            self._assumed.pop(uid, None)
            if not unchanged:
                self._version += 1
                touched = (
                    (node,) if prev in (None, node) else (node, prev)
                )
                self._emit("node-requested", touched)

    def observe_pod_raw(self, d: dict) -> None:
        """Raw-dict fast path for pod watch events (the informer's ``raw``
        handler form): terminal phases release by uid, and a pod already
        charged to the same node is a no-op WITHOUT parsing its resource
        quantities — k8s pod requests are immutable, so same (uid, node)
        implies same charge. Only a placement this state has never charged
        (an external/bound-elsewhere pod) pays typed rehydration and
        delegates to :meth:`observe_pod`."""
        spec = d.get("spec") or {}
        node = spec.get("node_name")
        if not node:
            return
        meta = d.get("metadata") or {}
        uid = meta.get("uid", "")
        phase = (d.get("status") or {}).get("phase") or "Pending"
        with self._lock:
            if phase in ("Succeeded", "Failed"):
                charged = self._requested.get(node, {}).pop(uid, None)
                known = self._pod_nodes.pop(uid, None)
                self._assumed.pop(uid, None)
                self._pod_objs.pop(uid, None)
                if charged is not None or known is not None:
                    self._version += 1
                    self._emit("node-requested", (node,))
                return
            if self._pod_nodes.get(uid) == node:
                self._assumed.pop(uid, None)  # bind commit observed
                return
        from ..api.serde import pod_from_dict

        # no defensive deepcopy: pod_from_dict copies every nested
        # container it keeps (same contract PodInfo.pod relies on)
        self.observe_pod(pod_from_dict(d))

    def remove_pod(self, pod: Pod) -> None:
        self._remove_uid(pod.metadata.uid)

    def remove_pod_raw(self, d: dict) -> None:
        self._remove_uid(((d.get("metadata") or {}).get("uid", "")))

    def _remove_uid(self, uid: str) -> None:
        with self._lock:
            node = self._pod_nodes.pop(uid, None)
            self._assumed.pop(uid, None)
            self._pod_objs.pop(uid, None)
            if node is not None:
                self._requested.get(node, {}).pop(uid, None)
                self._version += 1
                self._emit("node-requested", (node,))

    # -- ClusterStateProvider ---------------------------------------------

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def node_requested(self, node_name: str) -> Dict[str, int]:
        with self._lock:
            total: Dict[str, int] = {}
            for req in self._requested.get(node_name, {}).values():
                for k, v in req.items():
                    total[k] = total.get(k, 0) + v
            return total

    def nodes_requested(self, names=None) -> Dict[str, Dict[str, int]]:
        """``node_requested`` of every node (or of ``names``) in ONE lock
        pass: the scorer's pack reads thousands of nodes while the
        informers, the scheduling thread and the bind workers take this
        lock per event, and a contended acquisition per node hands the
        interpreter lock away each time (a port-only batch form; the
        values are ``node_requested``'s)."""
        with self._lock:
            if names is None:
                names = list(self._nodes)
            out: Dict[str, Dict[str, int]] = {}
            for name in names:
                total: Dict[str, int] = {}
                for req in self._requested.get(name, {}).values():
                    for k, v in req.items():
                        total[k] = total.get(k, 0) + v
                out[name] = total
            return out

    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(name)

    def pod_count(self, node_name: str) -> int:
        with self._lock:
            return len(self._requested.get(node_name, {}))

    def pods_on(self, node_name: str) -> List[Pod]:
        """Pods currently charged to a node (bound or assumed) — the victim
        candidate set for the preemption cycle."""
        with self._lock:
            return [
                self._pod_objs[uid]
                for uid in self._requested.get(node_name, {})
                if uid in self._pod_objs
            ]

    def is_assumed(self, pod_uid: str) -> bool:
        with self._lock:
            return pod_uid in self._assumed

    def is_placed(self, pod_uid: str) -> bool:
        """Whether the pod is charged to a node here, assumed or bound (a
        bind this scheduler finished counts before the informer's event)."""
        with self._lock:
            return pod_uid in self._pod_nodes
