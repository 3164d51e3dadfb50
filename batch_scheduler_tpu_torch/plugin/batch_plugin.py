"""BatchSchedulingPlugin: the framework-extension-point adapter.

Behavioural port of the reference plugin
(reference pkg/scheduler/batch/batchscheduler.go:60-374): maps
QueueSort/PreFilter/Filter/Score/Permit/PostBind onto the ScheduleOperation,
owns the start-signal channel and the gang release/abort choreography
(UpdateBatchCache + StartBatchSchedule + rejectPod), and runs the
ReconcileStatus loop thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

from ..api.types import Pod, PodGroupPhase, to_dict
from ..cache.pg_cache import PodGroupMatchStatus
from ..client.apiserver import NotFoundError
from ..core.operation import ScheduleOperation
from ..framework.types import StatusCode
from ..utils import errors as errs
from ..utils.labels import DEFAULT_WAIT_SECONDS, get_wait_seconds, pod_group_name
from ..utils.metrics import DEFAULT_REGISTRY, Registry
from ..utils.patch import create_merge_patch

__all__ = ["BatchSchedulingPlugin", "PLUGIN_NAME"]

PLUGIN_NAME = "batch-scheduler"

# Retry tuning for the waiting-pod race between the permit signal and the
# framework's waiting-pod registration (reference batchscheduler.go:85-89).
GET_WAIT_POD_RETRIES = 3
GET_WAIT_POD_SLEEP = 0.01


class BatchSchedulingPlugin:
    name = PLUGIN_NAME

    def __init__(
        self,
        handle,
        operation: ScheduleOperation,
        pg_client,
        max_schedule_seconds: Optional[float] = None,
        registry: Optional[Registry] = None,
    ):
        self.handle = handle
        self.operation = operation
        self.pg_client = pg_client
        self.max_schedule_seconds = max_schedule_seconds
        self.start_chan: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()
        self._reconcile_thread: Optional[threading.Thread] = None
        # per-extension-point latency (SURVEY.md §5 build note: the
        # reference has no instrumentation of its own)
        registry = registry or DEFAULT_REGISTRY
        self._ext_seconds = registry.histogram(
            "bst_extension_point_seconds",
            "Wall-clock seconds spent in each plugin extension point",
        )
        self._gang_releases = registry.counter(
            "bst_gang_releases_total", "Gangs released to bind"
        )

    # ------------------------------------------------------------------
    # framework extension points
    # ------------------------------------------------------------------

    def less(self, info1, info2) -> bool:
        return self.operation.compare(
            info1.pod, info1.timestamp, info2.pod, info2.timestamp
        )

    def sort_key(self, info) -> tuple:
        """Precomputed queue key equivalent to ``less`` — see
        ScheduleOperation.sort_key."""
        return self.operation.sort_key(info)

    def pre_filter(self, pod: Pod) -> None:
        with self._ext_seconds.time(point="preFilter"):
            self.operation.pre_filter(pod)

    def filter(self, pod: Pod, node_name: str) -> None:
        with self._ext_seconds.time(point="filter"):
            self.operation.filter(pod, node_name)

    def score(self, pod: Pod, node_name: str) -> int:
        with self._ext_seconds.time(point="score"):
            return self.operation.score(pod, node_name)

    def permit(self, pod: Pod, node_name: str) -> Tuple[StatusCode, float]:
        """Returns (status, wait timeout). Gang pods always Wait; the wait
        timeout is the gang TTL + 1s so cache eviction (gang abort) fires
        before the framework's own timeout (reference batchscheduler.go:
        165-202, the +1s at :180-182)."""
        with self._ext_seconds.time(point="permit"):
            outcome = self.operation.permit(pod, node_name)
        wait = DEFAULT_WAIT_SECONDS
        if outcome.pg_name:
            full_name = f"{pod.metadata.namespace}/{outcome.pg_name}"
            pgs = self.operation.status_cache.get(full_name)
            if pgs is not None:
                wait = get_wait_seconds(pgs.pod_group, self.max_schedule_seconds)
        wait += 1.0

        if outcome.error is not None:
            if isinstance(outcome.error, errs.WaitingError):
                return StatusCode.WAIT, wait
            if isinstance(outcome.error, errs.NotMatchedError):
                return StatusCode.SUCCESS, 0.0
            return StatusCode.UNSCHEDULABLE, DEFAULT_WAIT_SECONDS

        if outcome.ready:
            self._gang_releases.inc()
            # non-blocking put on an unbounded queue; no thread needed
            self.send_start_schedule_signal(
                f"{pod.metadata.namespace}/{outcome.pg_name}"
            )
        return StatusCode.WAIT, wait

    def post_bind(self, pod: Pod, node_name: str) -> None:
        with self._ext_seconds.time(point="postBind"):
            self.operation.post_bind(pod, node_name)

    # PreFilterExtensions (reference batchscheduler.go:116-144): the
    # preemption dry-run's add/remove hooks
    def preempt_add_pod(self, pod_to_add: Pod, node_name: str) -> None:
        self.operation.preempt_add_pod(pod_to_add, node_name)

    def preempt_remove_pod(self, pod_to_schedule: Pod, pod_to_remove: Pod) -> None:
        self.operation.preempt_remove_pod(pod_to_schedule, pod_to_remove)

    # Vectorized policy preemption (policy.preempt): the dry-run victim plan for a denied gang, and the
    # post-eviction gang reset. The framework drives the transaction
    # (Scheduler._evict_gang_plan: verify → evict → requeue).
    def preempt_victim_plan(self, pod: Pod):
        with self._ext_seconds.time(point="preemptPlan"):
            return self.operation.preempt_victim_plan(pod)

    def note_gang_evicted(self, full_name: str) -> None:
        self.operation.note_gang_evicted(full_name)

    def forget_denied(self, full_name: str) -> None:
        self.operation.forget_denied(full_name)

    def mark_dirty(self) -> None:
        self.operation.mark_dirty()

    # Whole-gang fast lane (gang-granular release+bind; reference
    # precedent: StartBatchSchedule's one-sweep gang release,
    # batchscheduler.go:254-344)
    def gang_plan(self, pod: Pod):
        return self.operation.gang_plan(pod)

    def permit_gang(self, full_name: str, members) -> bool:
        with self._ext_seconds.time(point="permit"):
            ok = self.operation.permit_gang(full_name, members)
        if ok:
            self._gang_releases.inc()
        return ok

    def post_bind_gang(self, full_name: str, bound: int) -> None:
        with self._ext_seconds.time(point="postBind"):
            self.operation.post_bind_gang(full_name, bound)

    def post_bind_gangs(self, items) -> None:
        with self._ext_seconds.time(point="postBind"):
            self.operation.post_bind_gangs(items)

    def suggested_node(self, pod: Pod) -> Optional[str]:
        """Gang-granular admission: the batch plan's next open slot for this
        pod, letting the framework skip the full node scan."""
        return self.operation.suggested_node(pod)

    def on_assume(self, pod: Pod, node_name: str, from_plan: bool = False) -> None:
        self.operation.on_assume(pod, node_name, from_plan)

    # ------------------------------------------------------------------
    # gang release choreography (the batchScheduler interface,
    # reference batchscheduler.go:53-58)
    # ------------------------------------------------------------------

    def update_batch_cache(self) -> None:
        """Reconcile waiting-pod UIDs into the per-group caches
        (reference UpdateBatchCache, batchscheduler.go:219-251)."""

        def visit(waiting_pod) -> None:
            pod = waiting_pod.get_pod()
            group, ok = pod_group_name(pod)
            if not ok:
                return
            full_name = f"{pod.metadata.namespace}/{group}"
            pgs = self.operation.status_cache.get(full_name)
            if pgs is None:
                return
            pod_key = f"{pod.metadata.namespace}/{pod.metadata.name}"
            old_uid = pgs.pod_name_uids.get(pod_key)
            if old_uid is not None and old_uid != pod.metadata.uid:
                pgs.matched_pod_nodes.delete(old_uid)
                pgs.pod_name_uids.delete(pod_key)

        self.handle.iterate_over_waiting_pods(visit)

    def start_batch_schedule(self, full_name: str) -> None:
        """Release a complete gang: stamp ScheduleStartTime, then Allow every
        matched waiting pod (reference StartBatchSchedule,
        batchscheduler.go:254-344)."""
        pgs = self.operation.status_cache.get(full_name)
        if pgs is None:
            return
        phase = pgs.pod_group.status.phase
        if phase not in (PodGroupPhase.PRE_SCHEDULING, PodGroupPhase.SCHEDULING):
            return

        if (
            pgs.pod_group.status.scheduled >= pgs.pod_group.spec.min_member
            and self.pg_client is not None
        ):
            # re-stamp schedule start to survive abnormal exit during bind
            # (reference batchscheduler.go:263-288)
            try:
                ns = pgs.pod_group.metadata.namespace
                live = self.pg_client.podgroups(ns).get(pgs.pod_group.metadata.name)
                live_copy = live.deepcopy()
                live_copy.status.schedule_start_time = time.time()
                patch = create_merge_patch(to_dict(live), to_dict(live_copy))
                self.pg_client.podgroups(ns).patch(live.metadata.name, patch)
            except NotFoundError:
                self.start_chan.put(full_name)
                return

        pending = self.operation.get_pod_node_pairs(full_name)
        pending_ids = self.operation.get_pod_name_uids(full_name)
        if pending is None or pending_ids is None:
            return
        pending_map = pending.items()
        needed = pgs.pod_group.spec.min_member - pgs.pod_group.status.scheduled
        if len(pending_map) < needed:
            return

        # Two-pass sweep. Pass 1 allows every pair whose waiting pod is
        # already visible (no sleeping). Pass 2 gives ALL the misses one
        # shared retry grace — each pair's WaitingPod materialises
        # independently in the permit-signal/park gap, so every pair gets
        # the full grace, while the sweep's total sleep stays one grace
        # period regardless of gang size (a mostly-stale big gang must
        # not serially stall the single reconcile thread per member).
        # Pairs still missing after the grace are dropped — but the sweep
        # CONTINUES. The reference RETURNS on the first miss
        # (batchscheduler.go:316-323), abandoning every not-yet-allowed
        # member to its full Permit timeout with no further release
        # signal coming (the quorum event already happened — found as the
        # ~100s stragglers in the gateway-restart e2e). The pairs are
        # independent TTL entries; one raced pod says nothing about the
        # rest. Deviation, not copied.
        def consume(uid, pair, waiting_pod) -> None:
            # allow() returning False means the wait already resolved
            # (timeout/reject) — that is permanent, so never retry;
            # either way the pair is consumed
            waiting_pod.allow(self.name)
            pending.delete(uid)
            pending_ids.delete(pair.pod_name)

        missing = []
        for uid, pair in pending_map.items():
            waiting_pod = self.handle.get_waiting_pod(uid)
            if waiting_pod is None:
                missing.append((uid, pair))
            else:
                consume(uid, pair, waiting_pod)
        for attempt in range(GET_WAIT_POD_RETRIES - 1):
            if not missing:
                break
            time.sleep(GET_WAIT_POD_SLEEP)
            still = []
            for uid, pair in missing:
                waiting_pod = self.handle.get_waiting_pod(uid)
                if waiting_pod is None:
                    still.append((uid, pair))
                else:
                    consume(uid, pair, waiting_pod)
            missing = still
        for uid, pair in missing:
            # raced ahead of the framework cache for the whole grace:
            # drop the stale pair (reference batchscheduler.go:316-323)
            pending.delete(uid)
            pending_ids.delete(pair.pod_name)

    def reject_pod(self, uid: str) -> None:
        """Abort one waiting pod (reference rejectPod,
        batchscheduler.go:347-354)."""
        waiting_pod = self.handle.get_waiting_pod(uid)
        if waiting_pod is None:
            return
        waiting_pod.reject("Group failed")

    # ------------------------------------------------------------------
    # reconcile loop (reference ReconcileStatus, batchscheduler.go:357-368)
    # ------------------------------------------------------------------

    def send_start_schedule_signal(self, full_name: str) -> None:
        self.start_chan.put(full_name)

    # release-signal retry bound: ~10s of 0.5s-spaced attempts rides out
    # an API-server outage; a persistently-failing signal is then dropped
    # and the gang recovers via its TTL abort (reference behavior drops
    # immediately, batchscheduler.go:263-288 returns on patch error)
    RELEASE_RETRIES = 20

    def reconcile_status(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.start_chan.get(timeout=0.2)
            except queue.Empty:
                continue
            full_name, attempt = (
                item if isinstance(item, tuple) else (item, 0)
            )
            try:
                self.update_batch_cache()
                self.start_batch_schedule(full_name)
            except Exception:
                # the reconcile loop must survive any single release — and
                # the SIGNAL must survive a transient failure too (an API
                # outage during the ScheduleStartTime stamp would strand a
                # complete gang in Permit waits until its TTL abort). The
                # re-enqueue is DELAYED on a timer, never blocking this
                # consumer thread, and bounded so a poisoned signal cannot
                # starve other gangs' releases forever.
                if attempt < self.RELEASE_RETRIES:
                    timer = threading.Timer(
                        0.5,
                        self.start_chan.put,
                        args=((full_name, attempt + 1),),
                    )
                    timer.daemon = True
                    timer.start()

    def start(self) -> None:
        self._reconcile_thread = threading.Thread(
            target=self.reconcile_status, name="reconcile-status", daemon=True
        )
        self._reconcile_thread.start()

    def stop(self) -> None:
        self._stop.set()
