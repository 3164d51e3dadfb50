"""Waiting pods: the Permit gate's parking lot.

Event-driven equivalent of the k8s framework's waitingPodsMap + per-pod
goroutine: a pod whose Permit returns Wait parks here with a deadline; the
gang-release choreography resolves it via ``allow``/``reject``
(reference batchscheduler.go:310-343,347-354), and a single timer thread
enforces deadlines. Resolution is pushed onto a ready queue consumed by the
bind worker pool — no thread blocks per waiting pod, so 10k parked pods
cost zero threads.
"""

from __future__ import annotations

import heapq
import queue
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..api.types import Pod

__all__ = ["WaitingPod", "WaitingPods"]

ALLOW = "allow"
REJECT = "reject"
TIMEOUT = "timeout"


class WaitingPod:
    def __init__(self, pod: Pod, node_name: str, deadline: float):
        self.pod = pod
        self.node_name = node_name
        self.deadline = deadline
        self._lock = threading.Lock()
        self._outcome: Optional[Tuple[str, str]] = None  # guarded-by: _lock
        # written once by park() before the pod is published (single-thread
        # phase); read under _lock thereafter
        self._sink: Optional[Callable[["WaitingPod", str, str], None]] = None  # guarded-by: _lock

    def get_pod(self) -> Pod:
        return self.pod

    def _resolve(self, outcome: str, message: str) -> bool:
        with self._lock:
            if self._outcome is not None:
                return False
            self._outcome = (outcome, message)
            sink = self._sink
        if sink is not None:
            sink(self, outcome, message)
        return True

    def allow(self, plugin_name: str) -> bool:
        """Release the pod to bind (reference waitingPod.Allow)."""
        return self._resolve(ALLOW, plugin_name)

    def reject(self, message: str) -> bool:
        """Fail the pod's wait (reference waitingPod.Reject)."""
        return self._resolve(REJECT, message)


class WaitingPods:
    """Registry + deadline enforcement + resolution fan-in."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.RLock()
        self._pods: Dict[str, WaitingPod] = {}  # guarded-by: _lock
        self._deadlines: list = []  # heap of (deadline, uid); guarded-by: _lock
        self.resolved: "queue.Queue[Tuple[WaitingPod, str, str]]" = queue.Queue()
        self._stop = threading.Event()
        self._timer = threading.Thread(
            target=self._timer_loop, name="permit-timeouts", daemon=True
        )
        self._timer.start()

    def park(self, wp: WaitingPod) -> None:
        # sink BEFORE publishing: once the pod is visible in _pods, a
        # concurrent allow()/reject() must find the sink or its resolution
        # would be lost and the gang stuck one bind short
        wp._sink = self._on_resolved
        with self._lock:
            self._pods[wp.pod.metadata.uid] = wp
            heapq.heappush(self._deadlines, (wp.deadline, wp.pod.metadata.uid))

    def get(self, uid: str) -> Optional[WaitingPod]:
        with self._lock:
            return self._pods.get(uid)

    def iterate(self, fn: Callable[[WaitingPod], None]) -> None:
        """reference frameworkHandler.IterateOverWaitingPods."""
        with self._lock:
            pods = list(self._pods.values())
        for wp in pods:
            fn(wp)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pods)

    def _on_resolved(self, wp: WaitingPod, outcome: str, message: str) -> None:
        with self._lock:
            self._pods.pop(wp.pod.metadata.uid, None)
        self.resolved.put((wp, outcome, message))

    def _timer_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(0.05)
            now = self._clock()
            expired = []
            with self._lock:
                while self._deadlines and self._deadlines[0][0] <= now:
                    _, uid = heapq.heappop(self._deadlines)
                    wp = self._pods.get(uid)
                    if wp is not None:
                        expired.append(wp)
            for wp in expired:
                wp._resolve(TIMEOUT, "permit wait deadline exceeded")

    def close(self) -> None:
        self._stop.set()
