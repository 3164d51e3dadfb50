"""Typed clientset over the API server.

Mirror of the reference's generated clientset surface
(reference pkg/generated/clientset/versioned/typed/podgroup/v1/
podgroup.go:67-191: Get/List/Watch/Create/Update/UpdateStatus/Delete/
DeleteCollection/Patch) plus the core/v1 slices the controller consumes
(pods by label selector, nodes — reference controller.go:206,240).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api.serde import node_from_dict, pod_from_dict, pod_group_from_dict
from ..api.types import Node, Pod, PodGroup, to_dict
from .apiserver import APIServer, NotFoundError

__all__ = ["Clientset", "PodGroupInterface", "PodInterface", "NodeInterface"]


class _TypedInterface:
    KIND = ""

    def __init__(self, api: APIServer, namespace: Optional[str]):
        self._api = api
        self._ns = namespace

    def _decode(self, d: dict):
        raise NotImplementedError

    def create(self, obj):
        return self._decode(self._api.create(self.KIND, to_dict(obj)))

    def get(self, name: str):
        return self._decode(self._api.get(self.KIND, self._ns, name))

    def list(self, label_selector: Optional[Dict[str, str]] = None):
        return [
            self._decode(d)
            for d in self._api.list(self.KIND, self._ns, label_selector)
        ]

    def update(self, obj):
        return self._decode(self._api.update(self.KIND, to_dict(obj)))

    def update_status(self, obj):
        """Status-subresource update: merge only the status stanza, like the
        reference's UpdateStatus verb."""
        d = to_dict(obj)
        return self._decode(
            self._api.patch(
                self.KIND,
                self._ns,
                d["metadata"]["name"],
                {"status": d["status"]},
            )
        )

    def patch(self, name: str, patch: dict):
        return self._decode(self._api.patch(self.KIND, self._ns, name, patch))

    def patch_many(self, pairs) -> List[str]:
        """Bulk merge patch: one API pass where the backend supports it,
        per-object patches otherwise. Missing objects are skipped; returns
        the names actually patched (no response decode — callers that
        need the updated objects patch individually)."""
        api_patch_many = getattr(self._api, "patch_many", None)
        if api_patch_many is not None:
            return api_patch_many(self.KIND, self._ns, pairs)
        patched = []
        for name, patch in pairs:
            try:
                self._api.patch(self.KIND, self._ns, name, patch)
            except NotFoundError:
                continue
            patched.append(name)
        return patched

    def delete(self, name: str) -> None:
        self._api.delete(self.KIND, self._ns, name)

    def delete_collection(self) -> int:
        return self._api.delete_collection(self.KIND, self._ns)

    def watch(self, replay: bool = True):
        return self._api.watch(self.KIND, replay=replay)


class PodGroupInterface(_TypedInterface):
    KIND = "PodGroup"

    def _decode(self, d: dict) -> PodGroup:
        return pod_group_from_dict(d)


class PodInterface(_TypedInterface):
    KIND = "Pod"

    def _decode(self, d: dict) -> Pod:
        return pod_from_dict(d)

    def bind(self, name: str, node_name: str) -> Pod:
        """The bind subresource: commit a pod to a node."""
        return self.patch(name, {"spec": {"node_name": node_name}})

    def bind_many(self, pairs: List[Tuple[str, str]]) -> List[str]:
        """Batched bind: one API round trip for a whole released gang
        (gang-granular choreography; reference precedent for whole-gang
        release sweeps is StartBatchSchedule, batchscheduler.go:254-344).
        Falls back to per-pod binds when the backing API lacks the batched
        verb (e.g. the HTTP gateway). Returns the names actually bound;
        missing pods are skipped."""
        bind_pods = getattr(self._api, "bind_pods", None)
        if bind_pods is not None:
            return bind_pods(self._ns, pairs)
        bound = []
        for name, node_name in pairs:
            try:
                self.patch(name, {"spec": {"node_name": node_name}})
            except NotFoundError:
                continue
            bound.append(name)
        return bound


class NodeInterface(_TypedInterface):
    KIND = "Node"

    def _decode(self, d: dict) -> Node:
        return node_from_dict(d)

    def create(self, obj):
        d = to_dict(obj)
        d.setdefault("metadata", {})["namespace"] = ""  # cluster-scoped
        return self._decode(self._api.create(self.KIND, d))


class Clientset:
    """``clientset.podgroups(ns)`` / ``clientset.pods(ns)`` /
    ``clientset.nodes()`` — the typed CRUD surface."""

    def __init__(self, api: APIServer):
        self.api = api

    def podgroups(self, namespace: str = "default") -> PodGroupInterface:
        return PodGroupInterface(self.api, namespace)

    def pods(self, namespace: str = "default") -> PodInterface:
        return PodInterface(self.api, namespace)

    def nodes(self) -> NodeInterface:
        # nodes are cluster-scoped; stored under the "" namespace
        return NodeInterface(self.api, "")

    def all_pod_groups(self) -> List[PodGroup]:
        return [pod_group_from_dict(d) for d in self.api.list("PodGroup")]

    def all_pods(self) -> List[Pod]:
        return [pod_from_dict(d) for d in self.api.list("Pod")]
