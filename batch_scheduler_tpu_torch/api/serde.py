"""Dict <-> object serde for API objects.

The API server stores plain dicts (so JSON merge patches apply naturally,
matching the reference's apiserver interactions) and rehydrates typed
objects at the clientset boundary. ``to_dict`` lives in api.types; these are
the inverse constructors.
"""

from __future__ import annotations

from typing import Optional

from .types import (
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodGroupSpec,
    PodGroupStatus,
    PodPhase,
    PodSpec,
    PodStatus,
    Taint,
    Toleration,
)

__all__ = [
    "pod_group_from_dict",
    "pod_from_dict",
    "node_from_dict",
    "object_from_dict",
    "KIND_CONSTRUCTORS",
]


def _meta(d: Optional[dict]) -> ObjectMeta:
    d = d or {}
    return ObjectMeta(
        name=d.get("name", ""),
        namespace=d.get("namespace", "default"),
        uid=d.get("uid", ""),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
        owner_references=list(d.get("owner_references") or []),
        creation_timestamp=d.get("creation_timestamp", 0.0),
        resource_version=d.get("resource_version", 0),
    )


def pod_group_from_dict(d: dict) -> PodGroup:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    return PodGroup(
        metadata=_meta(d.get("metadata")),
        spec=PodGroupSpec(
            min_member=spec.get("min_member", 0),
            priority_class_name=spec.get("priority_class_name", ""),
            # copied like every other nested container: typed objects must
            # never alias the source dict (it may be an informer store entry)
            min_resources=(
                dict(spec["min_resources"])
                if spec.get("min_resources") is not None
                else None
            ),
            max_schedule_time=spec.get("max_schedule_time"),
        ),
        status=PodGroupStatus(
            phase=PodGroupPhase(status.get("phase", "")),
            occupied_by=status.get("occupied_by", ""),
            scheduled=status.get("scheduled", 0),
            running=status.get("running", 0),
            succeeded=status.get("succeeded", 0),
            failed=status.get("failed", 0),
            schedule_start_time=status.get("schedule_start_time", 0.0),
        ),
    )


def _container(d: dict) -> Container:
    return Container(
        name=d.get("name", "main"),
        requests=dict(d.get("requests") or {}),
        limits=dict(d.get("limits") or {}),
    )


def _toleration(d: dict) -> Toleration:
    return Toleration(
        key=d.get("key", ""),
        operator=d.get("operator", "Equal"),
        value=d.get("value", ""),
        effect=d.get("effect", ""),
    )


def pod_from_dict(d: dict) -> Pod:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    return Pod(
        metadata=_meta(d.get("metadata")),
        spec=PodSpec(
            containers=[_container(c) for c in spec.get("containers") or []],
            node_selector=dict(spec.get("node_selector") or {}),
            tolerations=[_toleration(t) for t in spec.get("tolerations") or []],
            # "priority": null is legal external JSON; normalize here so
            # every typed consumer (compare, preemption sorts) sees an int
            priority=spec.get("priority") or 0,
            node_name=spec.get("node_name") or "",
        ),
        # explicit null is as legal as a missing field here (same contract
        # as priority above; the raw-path consumers normalize identically)
        status=PodStatus(phase=PodPhase(status.get("phase") or "Pending")),
    )


def _taint(d: dict) -> Taint:
    return Taint(
        key=d.get("key", ""),
        value=d.get("value", ""),
        effect=d.get("effect", "NoSchedule"),
    )


def node_from_dict(d: dict) -> Node:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    return Node(
        metadata=_meta(d.get("metadata")),
        spec=NodeSpec(
            taints=[_taint(t) for t in spec.get("taints") or []],
            unschedulable=spec.get("unschedulable", False),
        ),
        status=NodeStatus(
            allocatable=dict(status.get("allocatable") or {}),
            capacity=dict(status.get("capacity") or {}),
        ),
    )


KIND_CONSTRUCTORS = {
    "PodGroup": pod_group_from_dict,
    "Pod": pod_from_dict,
    "Node": node_from_dict,
}


def object_from_dict(kind: str, d: dict):
    return KIND_CONSTRUCTORS[kind](d)
