"""Core API object model: PodGroup CRD, Pods, Nodes.

This is the data-model equivalent of the reference's CRD types
(reference pkg/apis/podgroup/v1/types.go:25-143) plus the minimal slices of
the core/v1 Pod and Node objects the scheduler consumes
(reference pkg/scheduler/core/core.go:436-475,634-669,741-772).

Everything is a plain dataclass with exact-integer canonical resource lists
(see ``api.quantity``), deep-copyable and JSON-serialisable — the properties
the reference gets from k8s deepcopy-gen and apimachinery. Durable state
lives in object ``status`` fields stored in the (simulated or real) API
server; in-memory caches can always be rebuilt from watches, which is what
makes the scheduling oracle stateless per batch.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from .quantity import parse_resource_list

__all__ = [
    "PodGroupPhase",
    "PodPhase",
    "ObjectMeta",
    "Toleration",
    "Taint",
    "Container",
    "PodSpec",
    "PodStatus",
    "Pod",
    "NodeSpec",
    "NodeStatus",
    "Node",
    "PodGroupSpec",
    "PodGroupStatus",
    "PodGroup",
    "new_uid",
]

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    """Generate a unique, deterministic-per-process object UID."""
    return f"{prefix}-{next(_uid_counter):08d}"


class PodGroupPhase(str, enum.Enum):
    """PodGroup lifecycle (reference pkg/apis/podgroup/v1/types.go:28-56)."""

    PENDING = "Pending"
    PRE_SCHEDULING = "PreScheduling"
    SCHEDULING = "Scheduling"
    SCHEDULED = "Scheduled"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    FINISHED = "Finished"
    FAILED = "Failed"
    # The empty phase of a freshly created object, normalised to PENDING by
    # the controller (reference pkg/scheduler/controller/controller.go:199-200).
    EMPTY = ""


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    # Owner UIDs, used for PodGroup occupancy fencing
    # (reference pkg/scheduler/core/core.go:477-512).
    owner_references: list = field(default_factory=list)
    creation_timestamp: float = 0.0
    resource_version: int = 0

    def full_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: str = ""  # "" tolerates all effects for the key

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Container:
    name: str = "main"
    # Canonical integer resource lists (cpu in milli, bytes elsewhere).
    requests: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)

    @classmethod
    def from_raw(cls, name: str = "main", requests: dict = None, limits: dict = None):
        return cls(
            name=name,
            requests=parse_resource_list(requests),
            limits=parse_resource_list(limits),
        )


@dataclass
class PodSpec:
    containers: list = field(default_factory=list)
    node_selector: dict = field(default_factory=dict)
    tolerations: list = field(default_factory=list)
    priority: int = 0
    node_name: str = ""


@dataclass
class PodStatus:
    phase: PodPhase = PodPhase.PENDING


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def resource_require(self) -> dict:
        """Per-pod required resources: sum of container limits, falling back
        to requests when no limits are set — the exact accounting rule of the
        reference (pkg/scheduler/core/core.go:761-772)."""
        total: dict = {}
        for c in self.spec.containers:
            chosen = c.limits if c.limits else c.requests
            for k, v in chosen.items():
                total[k] = total.get(k, 0) + v
        return total

    def deepcopy(self) -> "Pod":
        return copy.deepcopy(self)


@dataclass
class NodeSpec:
    taints: list = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeStatus:
    # Canonical integer lists; "pods" is the allowed pod count.
    allocatable: dict = field(default_factory=dict)
    capacity: dict = field(default_factory=dict)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    def deepcopy(self) -> "Node":
        return copy.deepcopy(self)


@dataclass
class PodGroupSpec:
    """Reference pkg/apis/podgroup/v1/types.go:79-101."""

    min_member: int = 0
    priority_class_name: str = ""
    # Per-member resource floor (canonical integers); initialised from the
    # first observed member pod when unset (reference core.go:489-493).
    min_resources: Optional[dict] = None
    # Seconds; per-group override of the scheduler-wide max schedule time.
    max_schedule_time: Optional[float] = None


@dataclass
class PodGroupStatus:
    """Reference pkg/apis/podgroup/v1/types.go:104-130."""

    phase: PodGroupPhase = PodGroupPhase.EMPTY
    occupied_by: str = ""
    scheduled: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    schedule_start_time: float = 0.0


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    def full_name(self) -> str:
        return self.metadata.full_name()

    def deepcopy(self) -> "PodGroup":
        return copy.deepcopy(self)


def _meta_dict(m: ObjectMeta) -> dict:
    return {
        "name": m.name,
        "namespace": m.namespace,
        "uid": m.uid,
        "labels": dict(m.labels),
        "annotations": dict(m.annotations),
        "owner_references": list(m.owner_references),
        "creation_timestamp": m.creation_timestamp,
        "resource_version": m.resource_version,
    }


def _pod_dict(p: "Pod") -> dict:
    return {
        "metadata": _meta_dict(p.metadata),
        "spec": {
            "containers": [
                {
                    "name": c.name,
                    "requests": dict(c.requests),
                    "limits": dict(c.limits),
                }
                for c in p.spec.containers
            ],
            "node_selector": dict(p.spec.node_selector),
            "tolerations": [
                {
                    "key": t.key,
                    "operator": t.operator,
                    "value": t.value,
                    "effect": t.effect,
                }
                for t in p.spec.tolerations
            ],
            "priority": p.spec.priority,
            "node_name": p.spec.node_name,
        },
        "status": {"phase": p.status.phase.value},
    }


def _node_dict(n: "Node") -> dict:
    return {
        "metadata": _meta_dict(n.metadata),
        "spec": {
            "taints": [
                {"key": t.key, "value": t.value, "effect": t.effect}
                for t in n.spec.taints
            ],
            "unschedulable": n.spec.unschedulable,
        },
        "status": {
            "allocatable": dict(n.status.allocatable),
            "capacity": dict(n.status.capacity),
        },
    }


def _pg_status_dict(s: PodGroupStatus) -> dict:
    return {
        "phase": s.phase.value,
        "occupied_by": s.occupied_by,
        "scheduled": s.scheduled,
        "running": s.running,
        "succeeded": s.succeeded,
        "failed": s.failed,
        "schedule_start_time": s.schedule_start_time,
    }


def _pg_dict(g: "PodGroup") -> dict:
    return {
        "metadata": _meta_dict(g.metadata),
        "spec": {
            "min_member": g.spec.min_member,
            "priority_class_name": g.spec.priority_class_name,
            "min_resources": (
                dict(g.spec.min_resources)
                if g.spec.min_resources is not None
                else None
            ),
            "max_schedule_time": g.spec.max_schedule_time,
        },
        "status": _pg_status_dict(g.status),
    }


_TO_DICT_FAST = {}  # populated below Pod/Node/PodGroup definitions


def to_dict(obj) -> dict:
    """Serialise an API object to plain JSON-able data (for patches/storage).

    The API kinds (and PodGroupStatus, the controller's patch unit) have
    explicit encoders — ``dataclasses.asdict`` walks the reduce protocol per
    field and was the control plane's single largest CPU line at 10k-pod
    scale. Output is field-for-field identical (asserted in
    tests/test_patch.py); unknown dataclasses still fall back to asdict.
    """
    fast = _TO_DICT_FAST.get(type(obj))
    if fast is not None:
        return fast(obj)

    def encode(v):
        if isinstance(v, enum.Enum):
            return v.value
        return v

    def factory(items):
        return {k: encode(v) for k, v in items}

    return dataclasses.asdict(obj, dict_factory=factory)


_TO_DICT_FAST.update(
    {
        Pod: _pod_dict,
        Node: _node_dict,
        PodGroup: _pg_dict,
        PodGroupStatus: _pg_status_dict,
    }
)
