"""The scheduling loop: pop -> prefilter -> feasible nodes -> score ->
assume -> permit -> (wait) -> bind.

This is the embedded mini-framework the plugin runs inside — the role
upstream kube-scheduler plays for the reference (SURVEY.md §1 "control-flow
relationship"). One scheduling cycle is single-threaded (the property the
reference's cross-call maxPGStatus coupling relies on); permit waits are
event-driven (no thread per waiting pod) and binds run on a small worker
pool, mirroring the scheduling-cycle/binding-cycle split.

The port of ``batch_scheduler_tpu/framework/scheduler.py``: the queue, the
whole-gang fast lane, the cross-gang commit flush, the bind workers, the
preemption commit (``_policy_preempt`` / ``_evict_gang_plan`` and the
host-scan ``_try_preempt``) and the reference's spans, flight records,
lifecycle events and cycle histogram. ``device`` follows the port's rule
for entry points: "cuda" by default (the scheduler raises on a machine
without CUDA) unless the caller asks for "cpu"; the embedded plugin's
oracle takes its own from ``PluginConfig.device``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..api.types import Pod, PodPhase
from ..client.apiserver import NotFoundError
from ..client.clientset import Clientset
from ..core import resources as rmath
from ..ops.convert import resolve_device
from ..utils.errors import (
    OracleDeadlineError,
    OracleTransportError,
    ResourceNotEnoughError,
    SchedulingError,
)
from ..utils.labels import pod_group_name
from ..utils.lifecycle import DEFAULT_LEDGER
from ..utils.metrics import DEFAULT_REGISTRY
from ..utils import trace as trace_mod
from ..utils.trace import DEFAULT_FLIGHT_RECORDER
from .cluster import ClusterState
from .queue import SchedulingQueue
from .types import PodInfo, StatusCode
from .waiting import ALLOW, WaitingPod, WaitingPods

__all__ = ["Scheduler", "FrameworkHandle"]


def _gang_key(info: PodInfo) -> Optional[str]:
    """namespace/group queue-index key for gang-unit admission (None for
    non-gang pods) — served from the entry's scalar fields, no typed
    materialisation."""
    if not info.gang:
        return None
    return f"{info.namespace}/{info.gang}"


class FrameworkHandle:
    """What plugins see of the framework (reference framework.FrameworkHandle):
    waiting-pod access, the cluster snapshot provider, and the clientset."""

    def __init__(
        self, clientset: Clientset, cluster: ClusterState, waiting: WaitingPods
    ):
        self.clientset = clientset
        self.cluster = cluster
        self._waiting = waiting

    def get_waiting_pod(self, uid: str) -> Optional[WaitingPod]:
        return self._waiting.get(uid)

    def iterate_over_waiting_pods(self, fn: Callable[[WaitingPod], None]) -> None:
        self._waiting.iterate(fn)


class Scheduler:
    def __init__(
        self,
        clientset: Clientset,
        cluster: ClusterState,
        plugin=None,
        plugin_factory=None,
        bind_workers: int = 4,
        backoff_base: float = 1.0,
        backoff_cap: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        pod_informer=None,
        device="cuda",
    ):
        self.clientset = clientset
        self.cluster = cluster
        self.device = resolve_device(device)
        self._clock = clock
        # optional SharedInformer("Pod"): liveness checks read its raw store
        # instead of issuing a deep-copying API GET per cycle
        self._pod_informer = pod_informer
        self.waiting = WaitingPods(clock)
        self.handle = FrameworkHandle(clientset, cluster, self.waiting)
        # plugins need the handle at construction (reference New() receives
        # the FrameworkHandle); plugin_factory resolves the cycle
        self.plugin = plugin_factory(self.handle) if plugin_factory else plugin
        less = self.plugin.less if self.plugin is not None else None
        self.queue = SchedulingQueue(
            less,
            backoff_base,
            backoff_cap,
            clock,
            group_key_fn=_gang_key,
            sort_key_fn=getattr(self.plugin, "sort_key", None),
        )
        self._bind_workers = bind_workers
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # cross-gang commit buffer: (gang, namespace, assigned) awaiting
        # the batched bind + post-bind flush. Every access holds
        # _flush_lock (uncontended in the normal case): the buffer SWAP in
        # _flush_gangs takes it so stop()'s safety-net flush (after a join
        # that may time out mid-outage) can never double-commit a batch
        # the cycle thread is still flushing — concurrent flushes take
        # disjoint buffers. _buffer_since bounds deferral.
        self._gang_buffer: List[tuple] = []  # guarded-by: _flush_lock
        self._buffer_since = 0.0  # guarded-by: _flush_lock
        self._flush_lock = threading.Lock()
        # uids whose bind failed AMBIGUOUSLY (transport error: the request
        # may have applied with only the response lost) and whose capacity
        # was therefore kept. Consulted at pop time to release the ghost
        # once a fresh liveness read proves the bind never applied —
        # WITHOUT this marker, a duplicate queue entry (HTTP watch replay
        # re-enqueues every Pending pod) could release a permit-parked or
        # flush-buffered pod's LIVE reservation. GIL-atomic set ops; add
        # on the bind-worker/flush failure paths, discard at pop.
        self._kept_assumes: set = set()
        # counters for observability (SURVEY.md §5 build note)
        self.stats = {
            "scheduled": 0,
            "unschedulable": 0,
            "permit_waits": 0,
            "permit_rejects": 0,
            "binds": 0,
            "cycles": 0,
            "preemptions": 0,
        }
        # schedule-cycle latency: THE headline metric (SURVEY.md §5)
        self._cycle_seconds = DEFAULT_REGISTRY.histogram(
            "bst_schedule_cycle_seconds",
            "Wall-clock seconds per scheduling cycle (pop to permit/park)",
        )
        self._binds_total = DEFAULT_REGISTRY.counter(
            "bst_pods_bound_total", "Pods successfully bound"
        )
        # cycles aborted by an unexpected error (pod requeued with
        # backoff), split by cause: "oracle-transport" covers sidecar
        # transport/deadline failures in --oracle-fallback=deny mode —
        # the series an operator alerts on during a sidecar outage
        self._cycle_errors = DEFAULT_REGISTRY.counter(
            "bst_cycle_errors_total",
            "Scheduling cycles aborted by an error, by kind",
        )
        # preemption events by reason: "priority-tier" = the vectorized
        # policy victim plan (policy.preempt), "host-scan" = the legacy
        # per-node dry-run loop (docs/policy.md "Preemption pass")
        self._preemptions_total = DEFAULT_REGISTRY.counter(
            "bst_preemptions_total",
            "Preemption transactions committed, by reason",
        )
        # Evicted gang members are recreated as fresh Pending pods (the
        # in-process stand-in for the workload controller's recreate),
        # which is what re-queues the evicted gang exactly once. Off =
        # victims stay deleted and their gang waits for external recreation.
        self.requeue_evicted = True
        # feasible-node count of the last _select_node scan (evidence for
        # the flight recorder's "no feasible node" blame records)
        self._last_scan_feasible = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._threads = [
            threading.Thread(target=self._loop, name="sched-cycle", daemon=True)
        ]
        for i in range(self._bind_workers):
            self._threads.append(
                threading.Thread(
                    target=self._bind_worker, name=f"bind-{i}", daemon=True
                )
            )
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        self.waiting.close()
        # the cycle thread's exit path flushes the gang commit buffer; wait
        # for it so no permitted gang stays assumed-but-unbound, and flush
        # here if the thread could not (single-threaded buffer contract is
        # preserved: a joined or dead thread no longer touches it)
        for t in self._threads:
            if t.name == "sched-cycle" and t is not threading.current_thread():
                t.join(timeout=5.0)
        self._flush_gangs()

    # -- enqueue (wired to pod informer events) ---------------------------

    def enqueue(self, pod: Pod) -> None:
        if pod.spec.node_name or pod.status.phase != PodPhase.PENDING:
            return
        info = PodInfo(pod=pod, timestamp=self._clock())
        self.queue.push(info)
        key = _gang_key(info)
        if key is not None:
            # lifecycle TTP anchor: the informer saw this gang member
            # (member arrivals coalesce; a post-eviction arrival is the
            # respawn and keeps the original anchor)
            DEFAULT_LEDGER.note_arrival(
                key, tier=int(pod.spec.priority or 0), pods=1
            )

    def enqueue_raw(self, d: dict) -> None:
        """Raw-dict enqueue (the informer's ``raw`` handler form): the
        entry's typed pod materialises lazily on the scheduling thread,
        keeping the watch-dispatch thread to scalar parsing."""
        if (d.get("spec") or {}).get("node_name"):
            return
        if ((d.get("status") or {}).get("phase") or "Pending") != "Pending":
            return
        info = PodInfo(raw=d, timestamp=self._clock())
        self.queue.push(info)
        key = _gang_key(info)
        if key is not None:
            try:
                tier = int((d.get("spec") or {}).get("priority") or 0)
            except (TypeError, ValueError):
                tier = 0
            DEFAULT_LEDGER.note_arrival(key, tier=tier, pods=1)

    # -- main cycle --------------------------------------------------------

    # gangs per cross-gang commit flush: big enough to amortize the bind/
    # patch API passes, small enough that binds trail their permits by
    # only a few transactions
    FLUSH_GANGS = 16
    # wall-clock bound on commit deferral: sustained per-pod traffic must
    # not hold already-permitted gangs unbound until the queue idles
    FLUSH_SECONDS = 0.05

    def _loop(self) -> None:
        while not self._stop.is_set():
            # with commits buffered, drain fast and flush the moment the
            # queue goes momentarily idle; otherwise wait normally
            info = self.queue.pop(
                timeout=0.005 if self._buffer_pending() else 0.2
            )
            if info is None:
                self._flush_gangs()
                continue
            gang = self._run_cycle(info)
            if gang is not None:
                # gang-unit admission: the pod was placed through its
                # gang's batch plan, so its queued siblings ride the same
                # plan NOW — one drain instead of a heap pop + comparator
                # churn + plan lookup cycle each. Members the plan can't
                # seat fall through to the scan/backoff path as usual.
                for sibling in self.queue.pop_group(gang):
                    self._run_cycle(sibling)
            if self._buffer_ripe():
                self._flush_gangs()
        self._flush_gangs()  # nothing may stay assumed-but-unbound

    def _buffer_pending(self) -> bool:
        with self._flush_lock:
            return bool(self._gang_buffer)

    def _buffer_ripe(self) -> bool:
        """Commit buffer due for a flush: size or age threshold crossed.
        Pre-analyzer these peeks ran lock-free on the scheduling thread (a
        documented benign race); the lock is uncontended, so holding the
        guarded-by contract costs nothing and keeps the invariant clean."""
        with self._flush_lock:
            return bool(self._gang_buffer) and (
                len(self._gang_buffer) >= self.FLUSH_GANGS
                or self._clock() - self._buffer_since > self.FLUSH_SECONDS
            )

    # -- whole-gang fast lane ---------------------------------------------

    def _gang_transaction(self, info: PodInfo, pod: Pod, gang: str) -> bool:
        """Whole-gang transaction (gang-granular release+bind): when the
        popped pod's entire gang is queued and its batch plan covers the
        quorum, admit the gang as ONE unit — direct seat assignment from
        the plan, one bulk permit, one batched bind API call, one status
        patch — instead of ``min_member`` independent pod cycles with
        permit parking and release choreography. Reference precedent for
        gang-unit choreography: StartBatchSchedule
        (batchscheduler.go:254-344).

        Called from _schedule_one AFTER pre_filter passed (which is what
        stamps a fresh gang's plan). Returns True when the gang was
        admitted (the popped pod and every queued sibling consumed);
        False falls through to the per-pod path with nothing repeated."""
        plugin = self.plugin
        plan = plugin.gang_plan(pod)
        if plan is None:
            return False  # no whole-gang plan: per-pod path
        slots, needed = plan
        if 1 + self.queue.group_size(gang) < needed:
            return False  # partial arrival: members park via Permit waits
        members = [(info, pod)]
        sibs = self.queue.pop_group(gang)
        if self._pod_informer is not None and sibs:
            # batch liveness: one informer lock pass for the whole gang
            docs = self._pod_informer.peek_raw_many(
                info.namespace, [s.name for s in sibs]
            )
            for sib, d in zip(sibs, docs):
                if d is None:
                    continue
                dmeta = d.get("metadata") or {}
                if dmeta.get("uid") != sib.uid or (
                    (d.get("spec") or {}).get("node_name")
                ):
                    continue
                members.append((sib, sib.pod))
        else:
            for sib in sibs:
                p = self._live_pod(sib)
                if p is not None:
                    members.append((sib, p))

        # consumed siblings bypass _schedule_one's checks, so apply them
        # HERE, on the pop path's evidence. A sib this scheduler bound, or
        # an assumed one without the kept marker (or whose assume has a
        # live owner), is a duplicate entry: dropped. A kept one (an
        # ambiguous bind failure) is read fresh through the API
        # (_unbound_in_store; the informer's view may predate the lost
        # bind): unbound releases its ghost; bound drops the sib (its
        # charge stays, the informer's bound event squares it); a failed
        # read keeps the charge and requeues it. Either way the marker
        # goes, or it outlives this consumption and lets a duplicate queue
        # entry forget the re-assumed LIVE reservation later.
        kept = {s.uid for s in sibs if s.uid in self._kept_assumes}
        self._kept_assumes -= kept
        stale = False
        retained = [members[0]]
        for sib, p in members[1:]:
            if not self.cluster.is_assumed(sib.uid):
                if not self.cluster.is_placed(sib.uid):
                    retained.append((sib, p))
                continue
            if sib.uid in kept and not self._assume_owned(sib.uid):
                unbound = self._unbound_in_store(sib)
                if unbound:
                    self.cluster.forget(sib.uid)
                    stale = True
                    retained.append((sib, p))
                elif unbound is None:
                    self._kept_assumes.add(sib.uid)
                    self.queue.push_backoff(sib)
        members = retained
        if stale:
            plugin.mark_dirty()

        def hand_back() -> bool:
            # everything except the popped pod returns to the queue; the
            # caller continues with the per-pod path for ``info``
            for m, _ in members[1:]:
                self.queue.push(m)
            return False

        if len(members) < needed:
            return hand_back()  # stale siblings thinned the quorum
        seat, extras = members[:needed], members[needed:]
        assigned = []

        def rollback() -> None:
            # forget releases only still-ASSUMED capacity (bound pods are
            # untouched), so this is safe at every failure point; re-pushed
            # bound entries are dropped by the next pop's liveness check
            for _, p, _ in assigned:
                self.cluster.forget(p.metadata.uid)

        try:
            assigned, shortfall = self._seat_plan(seat, slots)
            if shortfall or len(assigned) < needed:
                rollback()
                return hand_back()
            try:
                ok = plugin.permit_gang(
                    gang, [(p, n) for _, p, n in assigned]
                )
            except SchedulingError as e:
                rollback()
                hand_back()
                self._unschedulable(info, str(e))
                return True
            if not ok:
                rollback()
                return hand_back()

            # commit is DEFERRED into the cross-gang flush buffer: binds
            # and the post-bind status patch batch across up to
            # FLUSH_GANGS gangs (one API pass each, one re-batch total).
            # Appended under _flush_lock (uncontended in the normal
            # single-threaded cycle) so stop()'s safety-net flush cannot
            # swap the buffer out from under a still-running cycle thread
            # and strand a permitted gang assumed-but-unbound.
            with self._flush_lock:
                if not self._gang_buffer:
                    self._buffer_since = self._clock()
                self._gang_buffer.append(
                    (gang, pod.metadata.namespace, assigned)
                )
            DEFAULT_FLIGHT_RECORDER.record(
                gang,
                phase="gang_transaction",
                verdict="placed",
                members=len(assigned),
                nodes=len({n for _, _, n in assigned}),
            )
        except Exception:
            # unexpected failure (transport, bug): release what was only
            # assumed, hand the gang back, and let the outer handler run
            # the popped pod through the per-pod path
            rollback()
            hand_back()
            raise
        if extras:
            # flush BEFORE handing extras to the per-pod path: their
            # permit reads status.scheduled, and a deferred commit would
            # park them against a stale quorum (one TTL-abort + 20s deny
            # detour per extra)
            self._flush_gangs()
        for m, _ in extras:
            # members beyond the quorum: ordinary per-pod scan placement
            self.queue.push(m)
        return True

    def _flush_gangs(self) -> None:
        """Commit the buffered gang transactions: ONE batched bind call
        per namespace, one finish-binding lock pass, one post-bind status
        sweep (bulk patch + single batch invalidation). Runs on the
        scheduling thread only. Bind-failure policy mirrors the per-pod
        worker (_bind_worker): a bind_many exception is AMBIGUOUS — the
        request may have applied server-side with only the response lost
        — so the failed namespace's members KEEP their assumed capacity
        and requeue (the retry either drops them on the bound-pod
        liveness check or re-assumes, squaring the charge). Only
        namespaces never attempted are rolled back, and namespaces whose
        bind_many already returned still go through the normal finish +
        post_bind path."""
        with self._flush_lock:
            buf = self._gang_buffer
            if not buf:
                return
            self._gang_buffer = []
        by_ns = {}
        for _, ns, assigned in buf:
            by_ns.setdefault(ns, []).extend(
                (p.metadata.name, n) for _, p, n in assigned
            )
        bound_keys = set()
        done_ns = set()
        failed_ns = None
        unattempted_ns = set()
        ns_order = list(by_ns.items())
        for i, (ns, pairs) in enumerate(ns_order):
            try:
                for name in self.clientset.pods(ns).bind_many(pairs):
                    bound_keys.add((ns, name))
                done_ns.add(ns)
            except Exception:
                failed_ns = ns
                unattempted_ns = {n2 for n2, _ in ns_order[i + 1:]}
                break
        if failed_ns is not None and self.plugin is not None:
            self.plugin.mark_dirty()
        finished = []
        items = []
        for gang, ns, assigned in buf:
            if ns not in done_ns:
                for m, p, _ in assigned:
                    if ns in unattempted_ns:
                        # never reached the API: the assume is pure local
                        # state — release it
                        self.cluster.forget(p.metadata.uid)
                    else:
                        # failed_ns: keep the assume (ambiguous outcome)
                        # and mark it so the next pop can release the
                        # ghost once a fresh read proves it never bound
                        self._kept_assumes.add(p.metadata.uid)
                    self.queue.push_backoff(m)
                continue
            bound = 0
            for _, p, n in assigned:
                if (ns, p.metadata.name) in bound_keys:
                    finished.append(p.metadata.uid)
                    p.spec.node_name = n
                    bound += 1
                else:
                    self.cluster.forget(p.metadata.uid)
            items.append((gang, bound))
            self.stats["binds"] += bound
            self.stats["scheduled"] += bound
            self._binds_total.inc(bound)
            # lifecycle terminal event: observes bst_gang_ttp_seconds
            # (arrival->THIS bind) + the phase decomposition
            DEFAULT_LEDGER.note_bind(gang, members=bound)
        if not items:
            return
        self.cluster.finish_binding_many(finished)
        post_many = getattr(self.plugin, "post_bind_gangs", None)
        if post_many is not None:
            post_many(items)
        else:
            for gang, bound in items:
                self.plugin.post_bind_gang(gang, bound)

    def _seat_plan(self, seat, slots):
        """Assign each (info, pod) in ``seat`` to a plan slot, verifying
        node capacity against a local running balance, then assume the
        whole seating in ONE cluster-lock pass. Returns
        ``(assigned, shortfall)`` where assigned holds
        (info, pod, node_name) triples; on shortfall the caller rolls the
        assumes back. Safe to defer the assumes to the end: the scheduling
        cycle is single-threaded, concurrent mutators only RELEASE
        capacity (bind-failure forgets, terminal-pod observes), and the
        local ``left`` balance accounts this gang's own seats — the same
        check-then-assume window the per-pod path has."""
        assigned = []
        idx = 0
        for node_name, count in slots.items():
            if idx >= len(seat):
                break
            node = self.cluster.get_node(node_name)
            if node is None or node.spec.unschedulable:
                continue
            left = rmath.single_node_left(
                node, self.cluster.node_requested(node_name), None
            )
            left = dict(left)  # private running balance, mutated in place
            remaining = count
            while remaining > 0 and idx < len(seat):
                m, p = seat[idx]
                require = p.resource_require()  # fresh dict per call
                require["pods"] = require.get("pods", 0) + 1
                if not (
                    rmath.check_fit(p, node)
                    and rmath.resource_satisfied(left, require)
                ):
                    break  # slot stale for this member: try the next node
                assigned.append((m, p, node_name))
                for k, v in require.items():
                    left[k] = left.get(k, 0) - v
                idx += 1
                remaining -= 1
        shortfall = idx < len(seat)
        if not shortfall:
            self.cluster.assume_many([(p, n) for _, p, n in assigned])
        return assigned, shortfall

    def _run_cycle(self, info: PodInfo) -> Optional[str]:
        try:
            with self._cycle_seconds.time():
                # root span: one trace per scheduling cycle (pop ->
                # prefilter -> select -> permit/park), the unit the
                # sidecar round-trip stitches into (docs/observability.md)
                with trace_mod.start_trace(
                    "schedule_cycle", pod=info.name,
                    gang=_gang_key(info) or "",
                ):
                    return self._schedule_one(info)
        except Exception as e:
            # a broken cycle must not kill the loop; release any
            # capacity assumed mid-cycle, then retry the pod
            kind = (
                "oracle-transport"
                if isinstance(e, (OracleTransportError, OracleDeadlineError))
                else "other"
            )
            self._cycle_errors.inc(kind=kind)
            DEFAULT_FLIGHT_RECORDER.record(
                _gang_key(info) or info.name,
                phase="cycle",
                verdict="error",
                reason=f"{type(e).__name__}: {e}",
                kind=kind,
            )
            self.cluster.forget(info.uid)
            if self.plugin is not None:
                self.plugin.mark_dirty()
            self.queue.push_backoff(info)
            return None

    def _live_pod(self, info: PodInfo) -> Optional[Pod]:
        """Liveness check: the queued copy may be stale (deleted, replaced,
        already bound). Prefer the informer's raw store — same signal as
        an API GET without the deep copy + rehydration. Returns the pod to
        schedule, or None when the entry is stale (consume silently)."""
        if self._pod_informer is not None:
            d = self._pod_informer.peek_raw(info.namespace, info.name)
            if d is None:
                return None
            meta = d.get("metadata") or {}
            if meta.get("uid") != info.uid or (
                (d.get("spec") or {}).get("node_name")
            ):
                return None
            return info.pod  # lazy: typed materialises only past liveness
        try:
            pod = self.clientset.pods(info.namespace).get(info.name)
        except NotFoundError:
            return None
        if pod.spec.node_name or pod.metadata.uid != info.uid:
            return None
        info.pod = pod
        return pod

    def _unbound_in_store(self, info: PodInfo) -> Optional[bool]:
        """A kept assume's evidence: one read through the API server (the
        live gateway generation), never the informer's cache, which may not
        have delivered the lost bind yet. True: the pod is there, unbound;
        False: it is bound (the lost bind applied), gone or replaced; None:
        the read failed (the API server is still unreachable)."""
        try:
            pod = self.clientset.pods(info.namespace).get(info.name)
        except NotFoundError:
            return False
        except Exception:  # noqa: BLE001 — an outage: the outcome is unknown
            return None
        return not pod.spec.node_name and pod.metadata.uid == info.uid

    def _schedule_one(self, info: PodInfo) -> Optional[str]:
        self.stats["cycles"] += 1
        kept = info.uid in self._kept_assumes
        if kept:
            self._kept_assumes.discard(info.uid)
        pod = self._live_pod(info)
        if pod is None:
            return

        if not self.cluster.is_assumed(info.uid):
            if self.cluster.is_placed(info.uid):
                # a duplicate queue entry of a pod this scheduler bound,
                # the informer's bound event not yet in: never bind again
                return
        elif not kept or self._assume_owned(info.uid):
            # a duplicate queue entry: an informer's relist re-adds a pod
            # that is parked in Permit, buffered for a flush or being
            # bound, and its owner holds the assume. Scheduling this copy
            # would bind the pod a second time, to another node, and the
            # assume it moves frees the first node while the store has it
            # filled (config 6 over the HTTP gateway over-committed nodes
            # that way after a restart; the reference shares the fault).
            return
        else:
            # a kept assume from an ambiguous bind failure (the worker/
            # flush keep-capacity policy). The informer's view above can
            # predate the lost bind (its watch reconnects and relists after
            # an outage): only a fresh read through the API server, served
            # by the live gateway generation (whose startup fenced every
            # older generation's in-flight binds out of the store,
            # serve_gateway / APIServer.bind_pods; both bind routes here,
            # the flush and _bind, take that fenced verb), proves the lost
            # request never applied and never will. Without it the forget
            # below freed a node the store had filled.
            unbound = self._unbound_in_store(info)
            if unbound is None:
                # still unreachable: keep the charge and the marker
                self._kept_assumes.add(info.uid)
                self.queue.push_backoff(info)
                return
            if not unbound:
                # bound in the store (or gone): the entry is stale, the
                # charge stays until the informer's event squares it
                return
            # unbound: release the ghost reservation before planning, or
            # the pod competes against its own charge and a gang that
            # exactly fills a node livelocks on it forever. (A stale
            # informer view self-heals: a late bound event re-charges the
            # node via observe_pod.)
            self.cluster.forget(info.uid)
            if self.plugin is not None:
                self.plugin.mark_dirty()

        if info.gang:
            # lifecycle: the gang entered a scheduling cycle (coalesced —
            # steady retries bump one streak; first_ts keeps the
            # queue-wait anchor)
            DEFAULT_LEDGER.note_admitted(_gang_key(info))

        if self.plugin is not None:
            try:
                with trace_mod.span("pre_filter"):
                    self.plugin.pre_filter(pod)
            except SchedulingError as e:
                # policy preemption entry point for DENIED GANGS: gang
                # pods fail at PreFilter (the oracle's whole-batch
                # verdict), never reaching the per-pod select/preempt
                # path below — so the vectorized victim plan hangs off
                # the denial itself. Evicted capacity frees
                # asynchronously; the pod retries from backoff and the
                # deny-cache entry is dropped so the retry isn't sticky.
                if self._policy_preempt(info, pod, e):
                    self.stats["preemptions"] += 1
                self._unschedulable(info, str(e))
                return
            # whole-gang fast lane: pre_filter just ran (stamping a fresh
            # gang's plan); a plan covering the quorum admits the gang as
            # one transaction and consumes its queued siblings
            if info.gang and hasattr(self.plugin, "gang_plan"):
                with trace_mod.span("gang_transaction"):
                    admitted = self._gang_transaction(
                        info, pod, _gang_key(info)
                    )
                if admitted:
                    return

        with trace_mod.span("select_node"):
            node_name, from_plan = self._select_node(pod)
        if node_name is None:
            # preemption cycle (the role upstream kube-scheduler's
            # PostFilter plays for the reference, whose policy hooks are
            # PreFilterExtensions — batchscheduler.go:116-144): dry-run a
            # victim search; evicted capacity frees asynchronously and the
            # pod retries from backoff
            if self._try_preempt(pod):
                self.stats["preemptions"] += 1
            self._unschedulable(info, "no feasible node")
            return

        self.cluster.assume(pod, node_name)
        if self.plugin is not None:
            # Let the plugin decide whether this assume invalidates its
            # batch (plan-covered gang members are pre-accounted).
            # from_plan distinguishes a plan-seated pod from a scan
            # fallback that happened to land on a planned node — only the
            # former matches the batch's accounting.
            on_assume = getattr(self.plugin, "on_assume", None)
            if on_assume is not None:
                on_assume(pod, node_name, from_plan)
            else:
                self.plugin.mark_dirty()

        if self.plugin is None:
            self._bind(pod, node_name)
            return None

        code, timeout = self.plugin.permit(pod, node_name)
        if code == StatusCode.SUCCESS:
            DEFAULT_FLIGHT_RECORDER.record(
                _gang_key(info) or info.name,
                phase="permit",
                verdict="placed",
                pod=info.name,
                node=node_name,
                from_plan=from_plan,
            )
            self._bind(pod, node_name)
        elif code == StatusCode.WAIT:
            self.stats["permit_waits"] += 1
            DEFAULT_FLIGHT_RECORDER.record(
                _gang_key(info) or info.name,
                phase="permit",
                verdict="wait",
                pod=info.name,
                node=node_name,
                timeout_s=timeout,
            )
            wp = WaitingPod(pod, node_name, self._clock() + timeout)
            wp._info = info  # carried for requeue on reject/timeout
            self.waiting.park(wp)
        else:
            self.cluster.forget(pod.metadata.uid)
            self.plugin.mark_dirty()
            self._unschedulable(info, "permit denied")
            return None
        # plan-seated gang member admitted: tell the loop so queued
        # siblings drain through the same plan in this cycle
        return _gang_key(info) if from_plan else None

    def _select_node(self, pod: Pod) -> tuple:
        """Generic resource/selector/taint fit + plugin Filter, then highest
        plugin Score wins (kube-scheduler's filter/score phases). Returns
        ``(node_name_or_None, from_plan)``.

        Fast path: a plugin-suggested node (the gang's batch placement plan)
        is verified against that single node and taken — O(1) per pod
        instead of the O(nodes) scan."""
        require = dict(pod.resource_require())
        require["pods"] = require.get("pods", 0) + 1

        if self.plugin is not None:
            suggest = getattr(self.plugin, "suggested_node", None)
            hint = suggest(pod) if suggest is not None else None
            if hint is not None:
                node = self.cluster.get_node(hint)
                if (
                    node is not None
                    and not node.spec.unschedulable
                    and rmath.check_fit(pod, node)
                ):
                    left = rmath.single_node_left(
                        node, self.cluster.node_requested(hint), None
                    )
                    if rmath.resource_satisfied(left, require):
                        self._last_scan_feasible = 1
                        return hint, True
                # plan slot unusable (node gone/full): fall through to the
                # scan, which sees the live cluster
        best_name, best_score = None, None
        feasible = 0
        for node in self.cluster.list_nodes():
            if node.spec.unschedulable:
                continue
            if not rmath.check_fit(pod, node):
                continue
            left = rmath.single_node_left(
                node, self.cluster.node_requested(node.metadata.name), None
            )
            if not rmath.resource_satisfied(left, require):
                continue
            if self.plugin is not None:
                try:
                    self.plugin.filter(pod, node.metadata.name)
                except SchedulingError:
                    continue
            feasible += 1
            score = (
                self.plugin.score(pod, node.metadata.name)
                if self.plugin is not None
                else 0
            )
            if best_score is None or score > best_score:
                best_name, best_score = node.metadata.name, score
        self._last_scan_feasible = feasible
        return best_name, False

    def _policy_preempt(self, info: PodInfo, pod: Pod, err=None) -> bool:
        """Policy-tier preemption transaction for a denied gang
        (docs/policy.md "Preemption pass"): dry-run the vectorized victim
        plan, re-verify it host-side against LIVE cluster state, then
        commit — evict every victim gang whole and requeue it. Fires only
        on resource denials (a PodGroupNotFound or sticky-deny retry has
        nothing to preempt for). Returns True when victims were evicted."""
        if self.plugin is None or not hasattr(
            self.plugin, "preempt_victim_plan"
        ):
            return False
        if err is not None and not isinstance(err, ResourceNotEnoughError):
            return False
        try:
            with trace_mod.span("preempt_plan"):
                plan = self.plugin.preempt_victim_plan(pod)
        except Exception:  # noqa: BLE001 — planning must never kill a cycle
            return False
        if plan is None:
            return False
        gang = _gang_key(info) or info.name
        # dry-run verification: the device plan was computed against the
        # snapshot's leftover; between then and now binds/releases may
        # have landed. The commit half runs only if the freed capacity
        # still seats the gang under the control plane's own math.
        verify = getattr(self.plugin, "operation", None)
        planner = getattr(verify, "preempt_planner", None) if verify else None
        if planner is not None and not planner.verify(
            plan, pod, self.cluster
        ):
            DEFAULT_FLIGHT_RECORDER.record(
                gang,
                phase="preempt",
                verdict="denied",
                reason="victim plan failed live re-verification",
                victims=len(plan.gangs),
            )
            return False
        self._evict_gang_plan(plan, preemptor=gang)
        forget = getattr(self.plugin, "forget_denied", None)
        if forget is not None:
            # the denial this preemption answers is otherwise 20s-sticky;
            # the freed capacity should not idle for the TTL
            forget(gang)
        return True

    def _evict_gang_plan(self, plan, preemptor: str) -> None:
        """Commit half of the preemption transaction: evict each victim
        gang WHOLE (rejecting permit-parked members first so assumed
        capacity releases, then deleting bound members — k8s eviction
        semantics), reset its schedule state, and requeue it by
        recreating its members as fresh Pending pods (the in-process
        stand-in for the workload controller's recreate — exactly one
        re-queue per eviction)."""
        note_evicted = getattr(self.plugin, "note_gang_evicted", None)
        for victim_gang in plan.gangs:
            pods = plan.pods_by_gang.get(victim_gang, [])
            DEFAULT_FLIGHT_RECORDER.record(
                victim_gang,
                phase="preempt",
                verdict="evicted",
                preemptor=preemptor,
                members=len(pods),
            )
            for victim in pods:
                uid = victim.metadata.uid
                wp = self.waiting.get(uid)
                if wp is not None:
                    wp.reject("Preempted")
                try:
                    self.clientset.pods(victim.metadata.namespace).delete(
                        victim.metadata.name
                    )
                except NotFoundError:
                    self.cluster.forget(uid)
            DEFAULT_LEDGER.note_evicted(victim_gang, preemptor=preemptor)
            if note_evicted is not None:
                note_evicted(victim_gang)
            if self.requeue_evicted:
                self._respawn_gang(pods)
        # one increment per TRANSACTION (matching the host-scan path and
        # the series' help text); the victim-gang count rides the
        # preemptor's flight record below
        self._preemptions_total.inc(reason="priority-tier")
        DEFAULT_FLIGHT_RECORDER.record(
            preemptor,
            phase="preempt",
            verdict="placed-via-preemption",
            victims=len(plan.gangs),
            evicted_pods=plan.evicted_pods,
            pooled_after=plan.pooled_after,
        )
        if self.plugin is not None:
            self.plugin.mark_dirty()

    def _respawn_gang(self, pods: List[Pod]) -> None:
        """Recreate evicted members as fresh Pending pods (new UID, same
        name/spec, no node): the informer's ADDED event re-enqueues them,
        so the evicted gang re-enters the queue exactly once."""
        from ..api.types import new_uid

        for victim in pods:
            meta = victim.metadata
            # deepcopy, not a shallow field copy: the evicted object stays
            # referenced (cluster state, flight records) and must not
            # share mutable spec lists with the respawned pod
            fresh = victim.deepcopy()
            fresh.metadata.uid = new_uid("pod")
            fresh.spec.node_name = ""
            fresh.status = type(fresh.status)()
            try:
                self.clientset.pods(meta.namespace).create(fresh)
            except Exception:  # noqa: BLE001 — best-effort respawn
                DEFAULT_FLIGHT_RECORDER.record(
                    f"{meta.namespace}/{meta.name}",
                    phase="preempt",
                    verdict="error",
                    reason="respawn failed; gang waits for external "
                           "recreation",
                )

    def _try_preempt(self, pod: Pod) -> bool:
        """Victim search + eviction for an unschedulable pod — the role
        upstream kube-scheduler's PostFilter (preemption) plays for the
        reference, whose policy surface is the PreFilterExtensions hooks
        (reference core.go:203-260, batchscheduler.go:116-144).

        Per candidate node (skipping nodes whose free resources ALREADY
        satisfy the pod — those were rejected for non-resource reasons and
        eviction there frees nothing): dry-run removing strictly-lower-
        priority pods (tightest legality via the plugin's
        preempt_remove_pod policy — online/offline rules, Scheduled/Running
        gangs protected, no self-preemption), lowest priority first, until
        the pod would fit, then reprieve victims that turned out
        unnecessary (highest priority first). Then — kube-scheduler's
        pickOneNodeForPreemption precedence, not first-fit — pick the node
        with the lowest highest-victim priority, then the smallest victim
        priority sum, then the fewest victims, then node order. Evict only
        on the chosen node: a waiting (permitted-but-unbound) victim has
        its Permit wait rejected so its assumed capacity releases, and
        every victim is then deleted (k8s eviction semantics — its gang's
        remaining members retry from Permit/backoff and the controller
        demotes the gang). Returns True if victims were evicted."""
        if self.plugin is None:
            return False
        # vectorized policy plan first (docs/policy.md): whole-gang victim
        # sets for gang-scale needs; the host loop below remains the
        # single-pod fallback when the policy engine is off or has no plan
        if self._policy_preempt(PodInfo(pod=pod), pod):
            return True
        require = dict(pod.resource_require())
        require["pods"] = require.get("pods", 0) + 1

        best_victims: Optional[List[Pod]] = None
        best_key = None
        for node in self.cluster.list_nodes():
            if node.spec.unschedulable or not rmath.check_fit(pod, node):
                continue
            try:
                self.plugin.preempt_add_pod(pod, node.metadata.name)
            except SchedulingError:
                continue
            left = rmath.single_node_left(
                node, self.cluster.node_requested(node.metadata.name), None
            )
            if rmath.resource_satisfied(left, require):
                continue  # not resource-blocked here; eviction is waste
            victims: List[Pod] = []
            freed: dict = {}
            candidates = sorted(
                self.cluster.pods_on(node.metadata.name),
                key=lambda p: p.spec.priority,
            )
            satisfied = False
            for victim in candidates:
                if victim.spec.priority >= pod.spec.priority:
                    break  # sorted ascending: no lower-priority victims left
                try:
                    self.plugin.preempt_remove_pod(pod, victim)
                except SchedulingError:
                    continue  # policy forbids this victim
                victims.append(victim)
                vreq = dict(victim.resource_require())
                vreq["pods"] = vreq.get("pods", 0) + 1
                freed = rmath.add_resources(freed, vreq)
                if rmath.resource_satisfied(
                    rmath.add_resources(left, freed), require
                ):
                    satisfied = True
                    break
            if not satisfied:
                continue
            # reprieve pass (upstream semantics): the greedy lowest-first
            # sweep can include victims a later, bigger victim made
            # unnecessary — give back any (highest priority first) whose
            # removal still leaves the pod fitting
            for victim in sorted(
                victims, key=lambda p: p.spec.priority, reverse=True
            ):
                vreq = dict(victim.resource_require())
                vreq["pods"] = vreq.get("pods", 0) + 1
                without = rmath.add_resources(
                    freed, {k: -v for k, v in vreq.items()}
                )
                if rmath.resource_satisfied(
                    rmath.add_resources(left, without), require
                ):
                    victims.remove(victim)
                    freed = without
            key = (
                max(v.spec.priority for v in victims),
                sum(v.spec.priority for v in victims),
                len(victims),
            )
            if best_key is None or key < best_key:
                best_key, best_victims = key, list(victims)
        if best_victims is None:
            return False
        self._evict(best_victims)
        self._preemptions_total.inc(reason="host-scan")
        return True

    def _evict(self, victims: List[Pod]) -> None:
        for victim in victims:
            uid = victim.metadata.uid
            wp = self.waiting.get(uid)
            if wp is not None:
                # permitted-but-unbound gang member: fail its Permit wait
                # first so the bind worker releases its assumed capacity
                wp.reject("Preempted")
            # eviction is deletion (k8s semantics): without it a rejected
            # member instantly requeues and races the preemptor for the
            # capacity it just freed
            try:
                self.clientset.pods(victim.metadata.namespace).delete(
                    victim.metadata.name
                )
            except NotFoundError:
                self.cluster.forget(uid)

    def _unschedulable(self, info: PodInfo, reason: str) -> None:
        self.stats["unschedulable"] += 1
        # flight recorder: the blame record for a denied pod/gang — the
        # reason string IS the blame (PreFilter's SchedulingError message
        # carries the oracle's verdict: infeasible vs reserved vs denied-
        # recently; "no feasible node" carries the scan's feasible count)
        rec = {"pod": info.name}
        if reason == "no feasible node":
            rec["feasible_nodes"] = self._last_scan_feasible
        # coalesce: a parked gang's deny-backoff retries repeat the same
        # blame every ~0.2-2s — as distinct records they roll the
        # authoritative pre_filter decision out of the 32-deep ring
        DEFAULT_FLIGHT_RECORDER.record(
            _gang_key(info) or info.name,
            phase="cycle",
            verdict="denied",
            reason=reason,
            coalesce=True,
            **rec,
        )
        if info.gang:
            # lifecycle: the same blame, coalesced into the gang's
            # timeline (audit-id/trace-id stamped by the ledger)
            DEFAULT_LEDGER.note_deny(_gang_key(info), reason)
        self.queue.push_backoff(info)

    # -- binding cycle -----------------------------------------------------

    def _bind_worker(self) -> None:
        import queue as _q

        while not self._stop.is_set():
            try:
                wp, outcome, message = self.waiting.resolved.get(timeout=0.2)
            except _q.Empty:
                continue
            pod = wp.pod
            if outcome == ALLOW:
                try:
                    self._bind(pod, wp.node_name)
                except Exception:
                    # a worker must NEVER die: a transport error mid-bind
                    # (API server outage) requeues the pod — found by the
                    # gateway-restart e2e, where every in-flight bind
                    # killed its worker and the resolved queue went
                    # unconsumed forever. The assumed capacity is KEPT:
                    # the request may have applied server-side with only
                    # the response lost (forgetting would transiently
                    # overcommit the node), and the retry cycle either
                    # drops the entry on the bound-pod liveness check or
                    # re-assumes, both of which square the charge.
                    self._kept_assumes.add(pod.metadata.uid)
                    if self.plugin is not None:
                        self.plugin.mark_dirty()
                    self._requeue_waiting(wp, pod)
            else:
                self.stats["permit_rejects"] += 1
                self.cluster.forget(pod.metadata.uid)
                if self.plugin is not None:
                    self.plugin.mark_dirty()
                self._requeue_waiting(wp, pod)

    def _assume_owned(self, uid: str) -> bool:
        """True when a live owner currently holds this uid's assume — a
        permit-parked WaitingPod or a flush-buffered gang seat — in which
        case the ghost-release at pop time must not touch the charge (the
        marker it is acting on was raced by a re-admission)."""
        if self.waiting.get(uid) is not None:
            return True
        with self._flush_lock:
            for _, _, assigned in self._gang_buffer:
                for _, p, _ in assigned:
                    if p.metadata.uid == uid:
                        return True
        return False

    def _requeue_waiting(self, wp, pod: Pod) -> None:
        info = getattr(wp, "_info", None) or PodInfo(pod=pod)
        self.queue.push_backoff(info)

    def _bind(self, pod: Pod, node_name: str) -> None:
        # the batched verb with one pair, not the per-pod PATCH: over the
        # HTTP gateway it carries the generation's bind epoch, so a bind a
        # restart severed cannot land after a newer generation served
        # _unbound_in_store's read (the gateway fences nothing else)
        bound = self.clientset.pods(pod.metadata.namespace).bind_many(
            [(pod.metadata.name, node_name)]
        )
        if pod.metadata.name not in bound:
            # missing from the store (the reference's NotFound)
            self.cluster.forget(pod.metadata.uid)
            return
        self.cluster.finish_binding(pod.metadata.uid)
        self.stats["binds"] += 1
        self.stats["scheduled"] += 1
        self._binds_total.inc()
        group, in_gang = pod_group_name(pod)
        if in_gang:
            # per-pod binding cycle (permit-quorum gangs): member binds
            # coalesce into one bind streak; the ledger observes TTP on
            # the streak's FIRST member only
            DEFAULT_LEDGER.note_bind(
                f"{pod.metadata.namespace}/{group}", members=1
            )
        if self.plugin is not None:
            pod.spec.node_name = node_name
            # post_bind owns batch invalidation (per gang completion, not
            # per pod — plan-covered member binds are pre-accounted)
            self.plugin.post_bind(pod, node_name)
