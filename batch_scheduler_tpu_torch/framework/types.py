"""Scheduling-framework data types: pod queue entries and cycle statuses.

Shapes mirror the k8s scheduler framework v1alpha1 surface the reference
plugs into (PodInfo with queue timestamp, Status codes Success/
Unschedulable/Wait/Error) without depending on it.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass
from typing import Optional

from ..api.types import Pod
from ..utils.labels import POD_GROUP_LABEL

__all__ = ["PodInfo", "StatusCode", "CycleStatus"]

_seq = itertools.count(1)


class PodInfo:
    """One queue entry. Constructed either from a typed ``Pod`` or from the
    informer's RAW stored dict (``raw=``): the raw form defers the deep
    copy + rehydrate to first ``.pod`` access on the scheduling thread, so
    the watch-dispatch thread (which feeds the queue and every other
    event consumer) only parses the handful of scalars the queue itself
    needs — at 10k pods the per-event typed materialisation was the
    dispatch thread's dominant cost.

    The scalar fields (``namespace``/``name``/``uid``/``priority``/
    ``gang``) are snapshot at construction and power the queue comparator
    and gang index without touching ``.pod``."""

    __slots__ = (
        "_pod",
        "raw",
        "timestamp",
        "attempts",
        "seq",
        "namespace",
        "name",
        "uid",
        "priority",
        "gang",
    )

    def __init__(
        self,
        pod: Optional[Pod] = None,
        timestamp: float = 0.0,
        attempts: int = 0,
        raw: Optional[dict] = None,
    ):
        if pod is None and raw is None:
            raise ValueError("PodInfo needs a pod or a raw dict")
        self._pod = pod
        self.raw = raw
        self.timestamp = timestamp
        self.attempts = attempts
        # Monotonic tiebreak so heap ordering is total even when Less()
        # says neither pod precedes the other.
        self.seq = next(_seq)
        if pod is not None:
            self.namespace = pod.metadata.namespace
            self.name = pod.metadata.name
            self.uid = pod.metadata.uid
            # nullable in external JSON: an explicit null must not poison
            # the queue's -priority sort key on the watch-dispatch thread
            self.priority = pod.spec.priority or 0
            self.gang = (pod.metadata.labels or {}).get(POD_GROUP_LABEL, "")
        else:
            meta = raw.get("metadata") or {}
            self.namespace = meta.get("namespace", "default")
            self.name = meta.get("name", "")
            self.uid = meta.get("uid", "")
            self.priority = (raw.get("spec") or {}).get("priority") or 0
            self.gang = (meta.get("labels") or {}).get(POD_GROUP_LABEL, "")

    @property
    def pod(self) -> Pod:
        if self._pod is None:
            from ..api.serde import pod_from_dict

            # no defensive deepcopy: pod_from_dict copies every nested
            # container it keeps (dict()/list builds), so the typed object
            # shares nothing mutable with the informer's stored dict
            self._pod = pod_from_dict(self.raw)
        return self._pod

    @pod.setter
    def pod(self, value: Pod) -> None:
        self._pod = value


class StatusCode(enum.Enum):
    SUCCESS = "Success"
    UNSCHEDULABLE = "Unschedulable"
    WAIT = "Wait"
    ERROR = "Error"


@dataclass
class CycleStatus:
    code: StatusCode
    message: str = ""
    # for WAIT: permit timeout in seconds
    timeout: float = 0.0
