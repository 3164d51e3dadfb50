from .cluster import ClusterState
from .queue import SchedulingQueue
from .scheduler import FrameworkHandle, Scheduler
from .types import CycleStatus, PodInfo, StatusCode
from .waiting import WaitingPod, WaitingPods

__all__ = [
    "ClusterState",
    "SchedulingQueue",
    "FrameworkHandle",
    "Scheduler",
    "CycleStatus",
    "PodInfo",
    "StatusCode",
    "WaitingPod",
    "WaitingPods",
]
