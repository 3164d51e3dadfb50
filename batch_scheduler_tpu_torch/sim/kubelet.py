"""SimKubelet: KWOK-style pod lifecycle simulation.

The reference validates multi-node gang behaviour only manually against a
real cluster (SURVEY.md §4); here a simulated kubelet drives bound pods
through Pending -> Running (-> Succeeded/Failed) so the controller's phase
machine and the gang timeout/abort paths run end-to-end in-process, at any
cluster size — the KWOK harness the build plan calls for.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, Optional

from ..api.types import PodPhase
from ..client.apiserver import APIServer, NotFoundError, WatchEvent
from ..client.clientset import Clientset
from ..utils.drain import drain_queue

__all__ = ["SimKubelet"]


class SimKubelet:
    def __init__(
        self,
        api: APIServer,
        start_delay: float = 0.05,
        run_duration: Optional[float] = None,
        fail_pod: Optional[Callable[[str], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """``start_delay``: bind -> Running latency. ``run_duration``: if
        set, Running -> Succeeded after this long. ``fail_pod``: fault
        injection — pods whose "namespace/name" it accepts go to Failed
        instead of Running."""
        self.api = api
        self.clientset = Clientset(api)
        self.start_delay = start_delay
        self.run_duration = run_duration
        self.fail_pod = fail_pod
        self._clock = clock
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pending: list = []  # heap of (due, seq, ns, name, next_phase)
        self._seq = 0
        self._batch_failures = 0  # consecutive _apply_due failures
        self._threads = []
        self._events = None

    def start(self) -> None:
        self._events = self.api.watch("Pod", replay=True)
        self._threads = [
            threading.Thread(target=self._watch_loop, name="kubelet-watch", daemon=True),
            threading.Thread(target=self._tick_loop, name="kubelet-tick", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        if self._events is not None:
            self.api.stop_watch("Pod", self._events)

    def _schedule_transition(self, ns: str, name: str, phase: PodPhase, delay: float) -> None:
        with self._lock:
            self._seq += 1
            heapq.heappush(
                self._pending, (self._clock() + delay, self._seq, ns, name, phase)
            )

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            batch = drain_queue(self._events, timeout=0.1)
            if batch is None:
                continue
            for event in batch:
                self._handle_event(event)

    def _handle_event(self, event) -> None:
        if event.type == WatchEvent.DELETED:
            return
        obj = event.obj
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        if not spec.get("node_name"):
            return
        if status.get("phase", "Pending") != "Pending":
            return
        meta = obj.get("metadata") or {}
        ns, name = meta.get("namespace", "default"), meta.get("name", "")
        key = f"{ns}/{name}"
        next_phase = (
            PodPhase.FAILED
            if self.fail_pod is not None and self.fail_pod(key)
            else PodPhase.RUNNING
        )
        self._schedule_transition(ns, name, next_phase, self.start_delay)

    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(0.02)
            now = self._clock()
            due = []
            with self._lock:
                while self._pending and self._pending[0][0] <= now:
                    due.append(heapq.heappop(self._pending))
            if not due:
                continue
            try:
                self._apply_due(due)
                self._batch_failures = 0
            except Exception:
                # the tick thread must survive a transport outage (HTTP
                # API): push the batch back and retry next tick — but
                # BOUNDED, then per-item with failures dropped, so one
                # poisoned pod cannot starve every co-due transition
                self._batch_failures += 1
                if self._batch_failures <= 25:  # ~5s outage budget
                    with self._lock:
                        for item in due:
                            heapq.heappush(self._pending, item)
                    self._stop.wait(0.2)
                else:
                    for item in due:
                        try:
                            self._apply_due([item])
                        except Exception:
                            pass  # poisoned item: dropped
                    self._batch_failures = 0

    def _apply_due(self, due) -> None:
        applied = set()
        patch_many = getattr(self.api, "patch_many", None)
        if patch_many is not None:
            # batched phase transitions: one lock pass per (tick, ns)
            # instead of a patch round trip per pod — at 10k pods the
            # per-pod form was measurable GIL load beside the scheduler
            by_ns: Dict[str, list] = {}
            for _, _, ns, name, phase in due:
                by_ns.setdefault(ns, []).append(
                    (name, {"status": {"phase": phase.value}})
                )
            for ns, patches in by_ns.items():
                for name in patch_many("Pod", ns, patches):
                    applied.add((ns, name))
        else:
            for _, _, ns, name, phase in due:
                try:
                    self.clientset.pods(ns).patch(
                        name, {"status": {"phase": phase.value}}
                    )
                except NotFoundError:
                    continue
                applied.add((ns, name))
        if self.run_duration is not None:
            # deleted pods (patch skipped) must not get phantom SUCCEEDED
            # transitions queued against their name
            for _, _, ns, name, phase in due:
                if phase == PodPhase.RUNNING and (ns, name) in applied:
                    self._schedule_transition(
                        ns, name, PodPhase.SUCCEEDED, self.run_duration
                    )
