"""Kubernetes-manifest loader: YAML documents -> API model objects. The
port's copy of ``batch_scheduler_tpu/api/manifest.py``: the same documents
parse to the same objects in both packages (``tests/test_torch_manifest.py``).
PyYAML reads the documents, as in the reference.

The reference consumes manifests through the Kubernetes API server (CRD
``deploy/crd.yaml`` + workloads like ``examples/example1.yaml`` — a PodGroup
plus a Parallel StatefulSet whose template carries the group label, reference
examples/example1.yaml:1-34). This framework has no API server in front of
it, so this module does the equivalent translation directly: camelCase
Kubernetes YAML -> the internal snake_case/canonical-integer model in
:mod:`batch_scheduler_tpu_torch.api.types`, expanding workload controllers
(StatefulSet / Deployment / ReplicaSet / Job) into their member pods the way
kube-controller-manager would.

Quantity strings ("1", "500m", "4Gi") are canonicalised to exact integers via
:func:`batch_scheduler_tpu_torch.api.quantity.parse_resource_list`.
"""

from __future__ import annotations

import io
import re
from typing import List, Optional, Union

import yaml

from .quantity import parse_resource_list
from .types import (
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupSpec,
    PodSpec,
    Taint,
    Toleration,
)

__all__ = [
    "load_manifests",
    "load_manifest_file",
    "parse_pod_group",
    "parse_pod",
    "parse_node",
    "expand_workload",
    "WORKLOAD_KINDS",
]

WORKLOAD_KINDS = ("StatefulSet", "Deployment", "ReplicaSet", "Job")


def _meta(d: Optional[dict]) -> ObjectMeta:
    d = d or {}
    return ObjectMeta(
        name=d.get("name", ""),
        namespace=d.get("namespace", "default"),
        uid=d.get("uid", ""),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
    )


def parse_pod_group(doc: dict) -> PodGroup:
    """PodGroup manifest -> model (reference pkg/apis/podgroup/v1/types.go:79-101).

    ``spec.minResources`` is a per-member resource floor with Kubernetes
    quantity strings; ``spec.maxScheduleTime`` accepts seconds (int/float) or
    a Go-style duration string handled by the caller's config layer.
    """
    spec = doc.get("spec") or {}
    min_resources = spec.get("minResources")
    return PodGroup(
        metadata=_meta(doc.get("metadata")),
        spec=PodGroupSpec(
            min_member=int(spec.get("minMember", 0)),
            priority_class_name=spec.get("priorityClassName", ""),
            min_resources=(
                parse_resource_list(min_resources) if min_resources else None
            ),
            max_schedule_time=_duration_seconds(spec.get("maxScheduleTime")),
        ),
    )


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h)")
_DURATION_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def _duration_seconds(v) -> Optional[float]:
    """Accept seconds (number) or a Go-style duration ("30s", "5m", "1m30s",
    "500ms", "1h2m3s")."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    matches = list(_DURATION_RE.finditer(s))
    if matches and "".join(m.group(0) for m in matches) == s:
        return sum(float(m.group(1)) * _DURATION_UNITS[m.group(2)] for m in matches)
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"invalid maxScheduleTime duration: {s!r}") from None


def _container_from_manifest(d: dict) -> Container:
    res = d.get("resources") or {}
    return Container(
        name=d.get("name", "main"),
        requests=parse_resource_list(res.get("requests")),
        limits=parse_resource_list(res.get("limits")),
    )


def _pod_spec_from_manifest(spec: Optional[dict]) -> PodSpec:
    spec = spec or {}
    return PodSpec(
        containers=[_container_from_manifest(c) for c in spec.get("containers") or []],
        node_selector=dict(spec.get("nodeSelector") or {}),
        tolerations=[
            Toleration(
                key=t.get("key", ""),
                operator=t.get("operator", "Equal"),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
            for t in spec.get("tolerations") or []
        ],
        priority=int(spec.get("priority", 0)),
        node_name=spec.get("nodeName", ""),
    )


def parse_pod(doc: dict) -> Pod:
    return Pod(metadata=_meta(doc.get("metadata")), spec=_pod_spec_from_manifest(doc.get("spec")))


def parse_node(doc: dict) -> Node:
    status = doc.get("status") or {}
    spec = doc.get("spec") or {}
    allocatable = parse_resource_list(status.get("allocatable"))
    capacity = parse_resource_list(status.get("capacity"))
    return Node(
        metadata=_meta(doc.get("metadata")),
        spec=NodeSpec(
            taints=[
                Taint(
                    key=t.get("key", ""),
                    value=t.get("value", ""),
                    effect=t.get("effect", "NoSchedule"),
                )
                for t in spec.get("taints") or []
            ],
            unschedulable=bool(spec.get("unschedulable", False)),
        ),
        status=NodeStatus(
            allocatable=allocatable or dict(capacity),
            capacity=capacity or dict(allocatable),
        ),
    )


def expand_workload(doc: dict) -> List[Pod]:
    """Expand a workload controller manifest into its member pods.

    Mirrors what the pod controllers do for the reference's gang demo: a
    Parallel StatefulSet with ``replicas: 9`` whose pod template carries the
    group label becomes 9 pods named ``<name>-<ordinal>`` (reference
    examples/example1.yaml:8-34). Jobs use ``spec.parallelism``.
    """
    meta = doc.get("metadata") or {}
    spec = doc.get("spec") or {}
    name = meta.get("name", "workload")
    namespace = meta.get("namespace", "default")
    replicas = int(spec.get("replicas", spec.get("parallelism", 1)))
    template = spec.get("template") or {}
    tmeta = template.get("metadata") or {}
    labels = dict(tmeta.get("labels") or {})
    annotations = dict(tmeta.get("annotations") or {})

    pods: List[Pod] = []
    for ordinal in range(replicas):
        pod = Pod(
            metadata=ObjectMeta(
                name=f"{name}-{ordinal}",
                namespace=namespace,
                labels=dict(labels),
                annotations=dict(annotations),
            ),
            spec=_pod_spec_from_manifest(template.get("spec")),
        )
        pods.append(pod)
    return pods


def load_manifests(source: Union[str, io.TextIOBase]) -> List[object]:
    """Parse a (possibly multi-document) YAML manifest string/stream into
    model objects: PodGroup / Pod / Node directly, workload kinds expanded
    into their member Pods. Unknown kinds (Service, CRD, ...) are skipped —
    they configure layers this framework does not model."""
    text = source.read() if hasattr(source, "read") else source
    out: List[object] = []
    for doc in yaml.safe_load_all(text):
        if not doc or not isinstance(doc, dict):
            continue
        kind = doc.get("kind", "")
        if kind == "PodGroup":
            out.append(parse_pod_group(doc))
        elif kind == "Pod":
            out.append(parse_pod(doc))
        elif kind == "Node":
            out.append(parse_node(doc))
        elif kind in WORKLOAD_KINDS:
            out.extend(expand_workload(doc))
        # else: skip (CRD manifests, Services, ... are deploy-time config)
    return out


def load_manifest_file(path: str) -> List[object]:
    with open(path, "r", encoding="utf-8") as fh:
        return load_manifests(fh)
