"""ScheduleOperation: the gang-scheduling semantics behind the framework's
extension points.

The port of ``batch_scheduler_tpu/core/operation.py``: prefilter
feasibility, per-node fit, permit accounting, queue ordering, postbind
status transitions, preemption legality and the policy engine's victim
plan, and the deny/permit fast-path caches (reference
pkg/scheduler/core/core.go:49-434) — with the hot loops swapped for the
batch oracle when ``scorer="oracle"`` (this package's ``OracleScorer`` on
``device``, or a scorer instance such as ``service.RemoteScorer``, whose
batch runs on the sidecar) and the reference-parity host path when
``scorer="serial"``. Its evidence is the reference's: a coalesced
``pre_filter`` flight record per oracle denial (blame and feasible-node
count), a ``policy`` record per placed gang of a policy batch (the
per-term blame on the snapshot's host columns), the operation's
``PendingGangTracker`` (the health model's pending signal) and the
lifecycle ledger's permit and delete events. The scheduler's own entry
points ride on top: the queue key (``sort_key``), the plan hint
(``suggested_node``), the whole-gang transaction's bulk bind commit
(``post_bind_gangs``), the assume credit (``on_assume``), and the status
patches through ``pg_client`` when one is given.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
import warnings
from typing import Callable, Dict, Optional, Protocol, Tuple

from ..api.types import Pod, PodGroup, PodGroupPhase
from ..cache.pg_cache import PGStatusCache, PodGroupMatchStatus, PodNodePair
from ..ops.capacity import set_active_sampler
from ..policy.engine import PolicyConfig, PolicyEngine
from ..policy.preempt import PreemptionPlanner
from ..utils import errors as errs
from ..utils.health import PendingGangTracker, set_active_pending
from ..utils.labels import get_wait_seconds, pod_group_name
from ..utils.lifecycle import DEFAULT_LEDGER
from ..utils.metrics import DEFAULT_REGISTRY
from ..utils.trace import DEFAULT_FLIGHT_RECORDER
from ..utils.ttl_cache import TTLCache
from . import resources as rmath
from .explain import Observatory, set_active_observatory
from .oracle_scorer import OracleScorer

__all__ = [
    "ScheduleOperation",
    "PermitOutcome",
    "ClusterStateProvider",
    "MAX_SCORE",
    "deny_reserved_reason",
    "deny_infeasible_reason",
    "deny_degraded_reason",
]


def deny_reserved_reason(full_name: str) -> str:
    """Feasible alone, but earlier gangs consume the space in this batch."""
    return f"{full_name}: cluster capacity reserved for earlier gangs"


def deny_infeasible_reason(full_name: str, min_member: int) -> str:
    """Provably cannot fit even alone (per-node-capacity feasibility)."""
    return f"{full_name}: cluster cannot fit gang ({min_member} members)"


def deny_degraded_reason(full_name: str, min_member: int) -> str:
    """The conservative fallback batch's only denial (docs/resilience.md)."""
    return (
        f"{full_name}: provably infeasible "
        f"({min_member} members; degraded oracle)"
    )


class _RevStr:
    """String wrapper ordering REVERSE-lexicographically — the Compare
    chain's ``name1 > name2`` tiebreak (reference core.go:404) embedded in
    a sort-key tuple."""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def __lt__(self, other: "_RevStr") -> bool:
        return self.s > other.s

    def __eq__(self, other) -> bool:
        return isinstance(other, _RevStr) and self.s == other.s


# Score stub ceiling (reference core.go:46).
MAX_SCORE = 2**31 - 1

# Deny/permit fast-path cache tuning (reference core.go:71-72,188,424).
DENY_TTL = 20.0
DENY_CACHE_DEFAULT_TTL = 30.0
DENY_CACHE_JANITOR = 3.0
PERMITTED_TTL = 2.0
PERMITTED_CACHE_DEFAULT_TTL = 3.0


class ClusterStateProvider(Protocol):
    """The slice of cluster state the scorers need (the reference reads this
    from the framework's SnapshotSharedLister, core.go:437,567)."""

    def list_nodes(self) -> list: ...

    def node_requested(self, node_name: str) -> Dict[str, int]: ...


@dataclass
class PermitOutcome:
    """Result triple of Permit (reference core.go:268-309 returns
    (ready, groupName, error))."""

    ready: bool
    pg_name: str
    error: Optional[Exception] = None


class ScheduleOperation:
    def __init__(
        self,
        status_cache: PGStatusCache,
        cluster: ClusterStateProvider,
        pg_client=None,
        max_schedule_seconds: Optional[float] = None,
        pg_lister: Optional[Callable[[str, str], Optional[PodGroup]]] = None,
        scorer="oracle",
        clock: Callable[[], float] = time.monotonic,
        min_batch_interval: float = 0.0,
        background_refresh: bool = False,
        dispatch_ahead: bool = False,
        compile_warmer: bool = False,
        device="cuda",
        audit_log=None,
        identity_audit_every: int = 0,
        policy: Optional[PolicyConfig] = None,
    ):
        self.status_cache = status_cache
        self.cluster = cluster
        # the PodGroup client the status transitions patch through (None:
        # local state only, as the hand-driven paths run)
        self.pg_client = pg_client
        self.max_schedule_seconds = max_schedule_seconds
        self.pg_lister = pg_lister
        if isinstance(scorer, str) and scorer not in ("oracle", "serial"):
            raise ValueError(
                f"unknown scorer {scorer!r} (use 'oracle', 'serial', or an "
                "OracleScorer-like instance, e.g. service.RemoteScorer)"
            )
        # The policy engine: ``policy`` is a PolicyConfig, or None to read
        # BST_POLICY from the environment (unset or empty = off: every path
        # below runs the pre-policy code). The engine scores batches through
        # the oracle's policy scan; the preemption planner (the "preempt"
        # term) runs plan_victims on ``device``.
        if policy is None:
            policy = PolicyConfig.from_env()
        self.policy = PolicyEngine(policy) if policy.enabled else None
        self.preempt_planner = (
            PreemptionPlanner(policy, device=device)
            if self.policy is not None and policy.preemption
            else None
        )
        if isinstance(scorer, str):
            self.scorer_kind = scorer
            self.oracle = (
                OracleScorer(
                    device=device,
                    audit_log=audit_log,
                    identity_audit_every=identity_audit_every,
                    policy_engine=self.policy,
                    min_batch_interval=min_batch_interval,
                    background_refresh=background_refresh,
                    dispatch_ahead=dispatch_ahead,
                    compile_warmer=compile_warmer,
                )
                if scorer == "oracle"
                else None
            )
        else:
            # a scorer instance (service.RemoteScorer, its batch on the
            # sidecar)
            self.scorer_kind = "oracle"
            self.oracle = scorer
            # requested batching is applied to the instance (only when
            # asked, so an instance configured directly keeps its own):
            # do not share one scorer across operations that disagree
            if min_batch_interval:
                scorer.min_batch_interval = min_batch_interval
            for flag, asked in (("background_refresh", background_refresh),
                                ("dispatch_ahead", dispatch_ahead)):
                if not asked:
                    continue
                if getattr(scorer, f"supports_{flag}", True):
                    setattr(scorer, flag, True)
                else:
                    warnings.warn(
                        f"{flag} requested but {type(scorer).__name__} does "
                        "not support it (a single-connection transport would "
                        "stall row reads behind the off-cycle batch); running "
                        "with blocking refresh"
                    )
            if audit_log is not None or identity_audit_every:
                # the audit records are made client-side from the padded
                # snapshot the wire carried; the batch's AUDIT_ID frame
                # correlates the sidecar's own record
                scorer.configure_audit(audit_log, identity_audit_every)
            if self.policy is not None:
                # the sidecar runs base (policy-unaware) batches: stamp
                # this side's fingerprint so the POLICY_INFO frame rides
                # the wire and a mismatched peer is counted, never silent
                scorer.policy_fingerprint = self.policy.config.fingerprint()[
                    "fingerprint"
                ]
        self.last_denied_pg = TTLCache(DENY_CACHE_DEFAULT_TTL, DENY_CACHE_JANITOR, clock=clock)
        self.last_permitted_pod = TTLCache(PERMITTED_CACHE_DEFAULT_TTL, DENY_CACHE_JANITOR, clock=clock)
        self._lock = threading.RLock()
        # sort_key's per-group creation-timestamp cache: immutable for a
        # group's lifetime, and dropped with the group (the status-cache
        # delete hook), so a recreated group re-reads its own stamp
        self._creation_cache: Dict[Tuple[str, str], float] = {}
        self._creation_tombstones: Dict[Tuple[str, str], float] = {}
        self._clock = clock
        # Cross-call max-progress group state used by the serial Filter path
        # (reference core.go:58-59,118-127).
        self.max_finished_pg: str = ""
        self.max_pg_status: Optional[PodGroupMatchStatus] = None
        # pending-gang aging (utils.health): per-operation so gangs from
        # a torn-down harness never age into a later harness's health
        # verdict; registered as the process's active tracker
        self.pending_tracker = PendingGangTracker()
        set_active_pending(self.pending_tracker)
        # the explain/what-if observatory (core.explain), process-wide for
        # /debug/explain and /debug/whatif; a non-oracle operation registers
        # None, so a torn-down oracle operation's observatory never answers
        set_active_observatory(
            Observatory(self, device=device)
            if self.scorer_kind == "oracle" and self.oracle is not None
            else None
        )
        # same isolation rule for the gang lifecycle ledger
        # (utils.lifecycle): a fresh operation starts a fresh story
        DEFAULT_LEDGER.reset()
        # same isolation rule for the capacity observatory: a non-oracle
        # operation clears a predecessor scorer's sampler (an OracleScorer
        # registers its own at construction)
        if self.scorer_kind != "oracle" or self.oracle is None:
            set_active_sampler(None)
        status_cache.on_delete(self._forget_creation)

    # ------------------------------------------------------------------
    # scorer lifecycle
    # ------------------------------------------------------------------

    def mark_dirty(self, group: Optional[str] = None) -> None:
        """Invalidate the oracle batch (cluster or gang state changed).

        ``group`` attributes the invalidation to ONE gang's demand row so
        the scorer's event-fold refresh stays O(churn) (ops.events): the
        named row is re-read at the next pack instead of the whole
        cluster. ``None`` is a blind mark — the next refresh falls back
        to the full scan, which is always correct."""
        if self.oracle is not None:
            self.oracle.mark_dirty(group)

    def _gang_event(self, full_name: str) -> None:
        """Note a gang-row change WITHOUT invalidating the batch — the
        plan-covered permit/bind paths pre-account their capacity
        (credit_expected_change), so the batch stays servable; but the
        next refresh, whenever something else triggers it, must re-read
        this gang's progress row rather than fold it as unchanged."""
        if self.oracle is not None:
            self.oracle.note_group_event(full_name)

    def _oracle_fresh(self, group: Optional[str] = None) -> OracleScorer:
        self.oracle.ensure_fresh(self.cluster, self.status_cache, group)
        return self.oracle

    # ------------------------------------------------------------------
    # PreFilter (reference core.go:88-167)
    # ------------------------------------------------------------------

    def pre_filter(self, pod: Pod) -> None:
        """Raises a SchedulingError to reject the pod for this cycle."""
        pg_name, ok = pod_group_name(pod)
        if not ok:
            return  # non-group pods pass straight through (core.go:89-92)
        full_name = f"{pod.metadata.namespace}/{pg_name}"

        if self.last_permitted_pod.contains(pod.metadata.uid):
            return  # fast-pass: just permitted (core.go:95-98)

        pgs = self.status_cache.get(full_name)
        if pgs is None:
            raise errs.PodGroupNotFoundError(f"pod group not found: {full_name}")

        if self.last_denied_pg.contains(full_name):
            raise errs.DeniedError(
                f"pod group {full_name} denied recently, backing off"
            )

        self._fill_occupied(pgs, pod)

        if self.scorer_kind == "oracle":
            self._pre_filter_oracle(full_name, pgs)
        else:
            self._pre_filter_serial(full_name, pgs, pod)

    def _pre_filter_oracle(self, full_name: str, pgs: PodGroupMatchStatus) -> None:
        if pgs.scheduled:
            return  # gang already released; let its members through
        oracle = self._oracle_fresh(full_name)
        self.max_finished_pg = oracle.max_group()
        if oracle.placed(full_name):
            self._stamp_plan(full_name, pgs, oracle)
            return
        if oracle.degraded:
            # conservative fallback (the sidecar is unreachable and a
            # RemoteScorer serves the local-CPU batch): no placement plan
            # exists, so nothing is admitted speculatively — but the
            # deny-by-default rule below would starve every gang for the
            # outage. Deny ONLY the provably infeasible (independent
            # feasibility is exact in the fallback batch); the rest go
            # through the per-pod fit checks against live cluster state.
            feasible = oracle.gang_feasible(full_name)
            DEFAULT_REGISTRY.counter(
                "bst_oracle_fallback_decisions_total",
                "PreFilter decisions made on the conservative CPU fallback",
            ).inc(decision="pass" if feasible else "deny")
            if feasible:
                return
            self.add_to_deny_cache(full_name)
            reason = deny_degraded_reason(
                full_name, pgs.pod_group.spec.min_member
            )
            self._record_denial(full_name, reason, oracle)
            raise errs.ResourceNotEnoughError(reason)
        self.add_to_deny_cache(full_name)
        if oracle.gang_feasible(full_name):
            # Feasible alone, but higher-priority gangs consume the space in
            # this batch — the exact form of the reference's 0.7 reserve
            # heuristic (core.go:157-165).
            reason = deny_reserved_reason(full_name)
            self._record_denial(full_name, reason, oracle)
            raise errs.ResourceNotEnoughError(reason)
        reason = deny_infeasible_reason(
            full_name, pgs.pod_group.spec.min_member
        )
        self._record_denial(full_name, reason, oracle)
        raise errs.ResourceNotEnoughError(reason)

    def _record_denial(
        self, full_name: str, reason: str, oracle: OracleScorer
    ) -> None:
        """One pre_filter flight record per oracle denial: the blame
        string PLUS the capacity-row feasible-node count (one capacity row
        read from the batch, on the denial path only). Evidence only,
        never the decision path; the deny-cache fast path does NOT
        re-record, so the original blame stays the gang's last pre_filter
        record through the backoff."""
        try:
            fields = {"batch": oracle.batches_run}
            count = oracle.feasible_node_count(full_name)
            if count is not None:
                fields["feasible_nodes"] = count
            DEFAULT_FLIGHT_RECORDER.record(
                full_name,
                phase="pre_filter",
                verdict="denied",
                reason=reason,
                coalesce=True,  # one record per distinct blame, not per retry
                **fields,
            )
        except Exception:  # noqa: BLE001 — evidence, never the decision
            pass

    def _pre_filter_serial(
        self, full_name: str, pgs: PodGroupMatchStatus, pod: Pod
    ) -> None:
        statuses = self.status_cache.snapshot()
        max_name, max_status, _ = rmath.find_max_group_serial(statuses)
        self.max_finished_pg = max_name
        self.max_pg_status = max_status
        if not max_name or max_status is None or max_status.pod_group is None:
            return

        nodes = self.cluster.list_nodes()
        node_req = {
            n.metadata.name: self.cluster.node_requested(n.metadata.name)
            for n in nodes
        }

        matched = len(max_status.matched_pod_nodes.items())
        if matched == 0:
            # First gang in flight becomes the max group (core.go:136-147).
            max_status = pgs
            prealloc = rmath.pre_allocated_resource(max_status, matched)
            if not rmath.cluster_satisfies(
                nodes, node_req, max_status.pod, prealloc, (1, 1)
            ):
                self.add_to_deny_cache(full_name)
                raise errs.ResourceNotEnoughError("cluster resource not enough")
            return

        if self.max_finished_pg == full_name:
            return  # the max-progress gang itself always passes (core.go:150-155)

        prealloc = rmath.pre_allocated_resource(max_status, matched)
        prealloc = rmath.add_resources(prealloc, pod.resource_require())
        if not rmath.cluster_satisfies(
            nodes, node_req, max_status.pod, prealloc, (7, 10)
        ):
            self.add_to_deny_cache(full_name)
            raise errs.ResourceNotEnoughError("cluster resource not enough")

    # ------------------------------------------------------------------
    # Gang-granular admission: the batch's whole-gang placement becomes a
    # per-gang plan that member pods ride without re-batching
    # ------------------------------------------------------------------

    @staticmethod
    def _matched_per_node(pgs: PodGroupMatchStatus) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for pair in pgs.matched_pod_nodes.items().values():
            counts[pair.node] = counts.get(pair.node, 0) + 1
        return counts

    def _stamp_plan(
        self, full_name: str, pgs: PodGroupMatchStatus, oracle: OracleScorer
    ) -> None:
        """Stamp (or refresh) the gang's placement plan from the current
        batch. Idempotent per batch: the plan covers the members that were
        *remaining* when the batch ran, and the matched-per-node base lets
        slot consumption be derived from live matched counts."""
        seq = oracle.batches_run
        if pgs.plan_batch_seq == seq:
            return
        pgs.plan_base_matched = self._matched_per_node(pgs)
        pgs.placement_plan = oracle.assignment(full_name)
        pgs.plan_batch_seq = seq
        if self.policy is not None and pgs.placement_plan:
            # per-term score contributions at the chosen seats — the
            # flight recorder's policy blame: why THESE nodes, in the
            # terms' own units. Computed on the snapshot's HOST policy
            # columns (no device read per gang). Evidence only, never the
            # decision path.
            try:
                snap = oracle.snapshot
                if snap is not None and snap.policy_cols is not None:
                    g = snap.group_index(full_name)
                    idx = [
                        snap.node_index(n)
                        for n in pgs.placement_plan
                        if snap.node_index(n) is not None
                    ]
                    terms = self.policy.explain(snap.policy_cols, g, idx)
                    if terms:
                        DEFAULT_FLIGHT_RECORDER.record(
                            full_name,
                            phase="policy",
                            verdict="info",
                            batch=seq,
                            nodes=len(idx),
                            terms=terms,
                        )
            except Exception:  # noqa: BLE001 — blame is evidence only
                pass

    def suggested_node(self, pod: Pod) -> Optional[str]:
        """The plan's next open slot for this pod's gang, or None (the
        caller falls back to the full node scan). Served entirely from the
        stamped plan on the host: no batch query, no re-batch."""
        if self.scorer_kind != "oracle":
            return None
        pg_name, ok = pod_group_name(pod)
        if not ok:
            return None
        pgs = self.status_cache.get(f"{pod.metadata.namespace}/{pg_name}")
        if pgs is None or not pgs.placement_plan:
            return None
        current = self._matched_per_node(pgs)
        base = pgs.plan_base_matched
        for node, planned in pgs.placement_plan.items():
            if planned > current.get(node, 0) - base.get(node, 0):
                return node
        return None

    def gang_plan(self, pod: Pod):
        """Whole-gang fast-lane eligibility. Returns ``(slots, needed)`` —
        the current batch's placement plan ``{node: member_count}`` and the
        member quorum — when this pod's gang can be admitted as ONE
        transaction: oracle mode, a plan stamped by the live batch, and a
        completely fresh gang. Anything else returns None and the caller
        takes the per-pod path."""
        if self.scorer_kind != "oracle" or self.oracle is None:
            return None
        pg_name, ok = pod_group_name(pod)
        if not ok:
            return None
        full_name = f"{pod.metadata.namespace}/{pg_name}"
        pgs = self.status_cache.get(full_name)
        if (
            pgs is None
            or pgs.scheduled
            or not pgs.placement_plan
            or pgs.plan_batch_seq != self.oracle.batches_run
            or pgs.pod_group.status.scheduled
            or pgs.matched_pod_nodes.items()
        ):
            return None
        needed = pgs.pod_group.spec.min_member
        if sum(pgs.placement_plan.values()) < needed:
            return None
        return dict(pgs.placement_plan), needed

    def permit_gang(self, full_name: str, members) -> bool:
        """Bulk Permit for a whole-gang transaction: one phase transition
        and one released-flag flip instead of per-member TTL bookkeeping.

        ``members`` are (pod, node_name) pairs the caller already assumed.
        May raise OccupiedError; returns False when the gang vanished
        mid-flight. Either way the caller rolls back its assumes."""
        pgs = self.status_cache.get(full_name)
        if pgs is None:
            return False
        for pod, _ in members:
            self._fill_occupied(pgs, pod)
        with self._lock:
            pg = pgs.pod_group
            if pg.status.phase == PodGroupPhase.PENDING:
                pg.status.phase = PodGroupPhase.PRE_SCHEDULING
            pgs.scheduled = True
        # every one of these assumes is capacity the batch pre-accounted
        # through the gang's plan
        if self.oracle is not None:
            self.oracle.credit_expected_change(len(members))
        # the gang's progress row (phase, released flag) moved outside the
        # evented cluster mutators — note it for the next event fold
        self._gang_event(full_name)
        self.pending_tracker.note_placed(full_name)
        DEFAULT_LEDGER.note_permit(full_name)
        return True

    def post_bind_gang(self, full_name: str, bound: int) -> None:
        """One status transition for ``bound`` members bound as a unit
        (the per-gang form of ``bound`` post_bind calls); a thin wrapper
        over :meth:`post_bind_gangs`."""
        self.post_bind_gangs([(full_name, bound)])

    def post_bind_gangs(self, items) -> None:
        """Flush form of :meth:`post_bind_gang` for gangs bound together
        (the scheduler's cross-gang commit buffer): ONE lock pass, ONE
        bulk status patch per namespace, ONE batch invalidation.
        ``items``: (full_name, bound_count) pairs. Local state commits
        first and the patch is best-effort: the binds are already durable,
        and the controller re-derives a missed phase from live member
        pods (reference controller.go:201-222)."""
        patches_by_ns: Dict[str, list] = {}
        completed_any = False
        with self._lock:
            for full_name, bound in items:
                if bound <= 0:
                    continue
                pgs = self.status_cache.get(full_name)
                if pgs is None:
                    continue
                pg = pgs.pod_group
                pgs.binds_committed += bound
                new_scheduled = max(pg.status.scheduled, pgs.binds_committed)
                completed = new_scheduled >= pg.spec.min_member
                new_phase = (
                    PodGroupPhase.SCHEDULED
                    if completed
                    else PodGroupPhase.SCHEDULING
                )
                new_start = pg.status.schedule_start_time or time.time()
                # patch on a scheduled-count advance too, not just a phase
                # change: two partial flushes both landing in SCHEDULING
                # must still move the API server's count
                if self.pg_client is not None and (
                    new_phase != pg.status.phase
                    or new_scheduled > pg.status.scheduled
                ):
                    patches_by_ns.setdefault(
                        pg.metadata.namespace, []
                    ).append(
                        (
                            pg.metadata.name,
                            {
                                "status": {
                                    "phase": new_phase.value,
                                    "scheduled": new_scheduled,
                                    "schedule_start_time": new_start,
                                }
                            },
                        )
                    )
                pg.status.phase = new_phase
                pg.status.schedule_start_time = new_start
                pg.status.scheduled = new_scheduled
                pgs.placement_plan = None
                completed_any = completed_any or completed
        for ns, patches in patches_by_ns.items():
            try:
                self.pg_client.podgroups(ns).patch_many(patches)
            except Exception:  # noqa: BLE001 — the controller reconciles
                pass
        # every touched gang's progress row moved: name them all for the
        # next event fold, then invalidate once per flush (not per gang)
        # when any gang completed
        touched = [full_name for full_name, bound in items if bound > 0]
        for full_name in touched:
            self._gang_event(full_name)
        if completed_any:
            self.mark_dirty(group=touched[0] if touched else None)

    def on_assume(
        self, pod: Pod, node_name: str, from_plan: bool = False
    ) -> None:
        """Called after the framework assumes a pod onto a node. A gang
        member SEATED THROUGH the plan (``from_plan``) whose plan the
        CURRENT batch stamped is exactly the capacity charge that batch
        already accounted: credit the version bump instead of
        invalidating. Everything else (non-gang pods, planless gangs, scan
        fallbacks, a superseded batch's plan) dirties the batch."""
        pg_name, ok = pod_group_name(pod)
        full_name = f"{pod.metadata.namespace}/{pg_name}" if ok else None
        if (
            self.scorer_kind == "oracle"
            and self.oracle is not None
            and from_plan
            and ok
        ):
            pgs = self.status_cache.get(full_name)
            if (
                pgs is not None
                and pgs.placement_plan is not None
                and node_name in pgs.placement_plan
                and pgs.plan_batch_seq == self.oracle.batches_run
            ):
                self.oracle.credit_expected_change(1)
                return
        # the node-row change itself is evented by the cluster mutator
        # (ClusterState.assume); a known gang name keeps the invalidation
        # attributed, so the next refresh can still fold
        self.mark_dirty(group=full_name)

    # ------------------------------------------------------------------
    # Filter (reference core.go:170-191,514-564)
    # ------------------------------------------------------------------

    def filter(self, pod: Pod, node_name: str) -> None:
        pg_name, ok = pod_group_name(pod)
        if not ok:
            return
        full_name = f"{pod.metadata.namespace}/{pg_name}"
        pgs = self.status_cache.get(full_name)
        if pgs is None:
            raise errs.PodGroupNotFoundError(f"pod group not found: {full_name}")
        try:
            if self.scorer_kind == "oracle":
                self._filter_oracle(full_name, node_name)
            else:
                self._filter_serial(full_name, pod, node_name)
        except errs.SchedulingError:
            self.add_to_deny_cache(full_name)
            raise
        self.last_permitted_pod.set(pod.metadata.uid, "", PERMITTED_TTL)

    def _filter_oracle(self, full_name: str, node_name: str) -> None:
        oracle = self._oracle_fresh(full_name)
        if oracle.node_capacity(full_name, node_name) > 0:
            return
        raise errs.ResourceNotEnoughError(
            f"{full_name}: node {node_name} cannot fit a member"
        )

    def _filter_serial(self, full_name: str, pod: Pod, node_name: str) -> None:
        # case1: the max-progress group itself always passes (core.go:531-535)
        if self.max_finished_pg == full_name:
            return
        max_status = self.max_pg_status
        if max_status is None or not max_status.pod_group.spec.min_resources:
            return  # nothing to reserve against (core.go:542-544)
        max_single = dict(max_status.pod_group.spec.min_resources)

        node = next(
            (
                n
                for n in self.cluster.list_nodes()
                if n.metadata.name == node_name
            ),
            None,
        )
        if node is None:
            raise errs.SchedulingError("node snapshot not initialized")
        left = rmath.single_node_left(
            node, self.cluster.node_requested(node_name), None, (1, 1)
        )

        # case2: node fits this pod plus one member of the max group
        combined = rmath.add_resources(pod.resource_require(), max_single)
        if rmath.resource_satisfied(left, combined):
            return
        # case3: node can't host the max group's member anyway — don't hold
        # this node hostage for it (core.go:557-561)
        if not rmath.resource_satisfied(left, max_single):
            return
        raise errs.ResourceNotEnoughError(
            f"node {node_name} reserved for max group {self.max_finished_pg}"
        )

    # ------------------------------------------------------------------
    # Preemption (reference core.go:194-260)
    # ------------------------------------------------------------------

    def preempt_add_pod(self, pod_to_add: Pod, node_name: str) -> None:
        return None

    def preempt_victim_plan(self, pod: Pod):
        """Dry-run a victim plan for a denied gang pod (policy.preempt): the
        tier-eligible victim gangs whose whole-gang eviction frees enough
        capacity, minimal by construction. Returns a VictimPlan or None
        (policy preemption off, the pod not a gang member or of tier 0,
        nothing evictable, or infeasible even with full eviction, or a
        victim the preempt hook forbids). The commit half is the
        framework's: verify the plan against the live cluster
        (``preempt_planner.verify``), evict every victim gang whole,
        ``note_gang_evicted`` each, ``forget_denied`` the preemptor, mark
        the batch dirty."""
        if self.preempt_planner is None:
            return None
        pg_name, ok = pod_group_name(pod)
        if not ok or pod.spec.priority <= 0:
            return None  # tier-0 gangs never preempt (nothing is lower)
        full_name = f"{pod.metadata.namespace}/{pg_name}"
        pgs = self.status_cache.get(full_name)
        if pgs is None:
            return None
        pg = pgs.pod_group
        need = max(
            pg.spec.min_member - pg.status.scheduled - len(pgs.matched_pod_nodes.items()),
            0,
        )
        plan = self.preempt_planner.plan(pod, self.cluster, self.status_cache, full_name, need)
        self.policy.note_plan(plan is not None)
        if plan is None:
            return None
        # legality gate: every victim must pass the preempt hook on its own;
        # one forbidden victim voids the plan, which is minimal only as a
        # unit
        for victim in plan.victims():
            try:
                self.preempt_remove_pod(pod, victim)
            except errs.SchedulingError:
                return None
        return plan

    def note_gang_evicted(self, full_name: str) -> None:
        """Reset a victim gang's local schedule state after a policy
        eviction: its members were deleted (and are recreated Pending), so
        the gang re-enters the queue as a fresh unit — phase back to
        PENDING, scheduled count zeroed, plan dropped — and its demand row
        is marked dirty. The status patch through ``pg_client`` is
        best-effort (the controller re-derives the phase from live member
        pods). The pending tracker's ``note_evicted`` re-arms the gang's
        pending clock at its ORIGINAL first denial, so pending age
        includes the preemption churn.

        The reset and its patch run under the gang's ``count_lock``, one
        step against the controller's sync, and the patch's resource
        version fences the controller's older views (``evicted_rv``): a
        sync that read the group while the deleted members still counted
        would otherwise write their progress back over the reset."""
        pgs = self.status_cache.get(full_name)
        if pgs is None:
            return
        with pgs.count_lock:
            with self._lock:
                pg = pgs.pod_group
                pg.status.phase = PodGroupPhase.PENDING
                pg.status.scheduled = 0
                pg.status.schedule_start_time = None
                pgs.binds_committed = 0
                pgs.scheduled = False
                pgs.placement_plan = None
                for uid in list(pgs.matched_pod_nodes.items()):
                    pgs.matched_pod_nodes.delete(uid)
                ns, name = pg.metadata.namespace, pg.metadata.name
            if self.pg_client is not None:
                try:
                    updated = self.pg_client.podgroups(ns).patch(
                        name,
                        {
                            "status": {
                                "phase": PodGroupPhase.PENDING.value,
                                "scheduled": 0,
                                "schedule_start_time": None,
                            }
                        },
                    )
                    pgs.evicted_rv = updated.metadata.resource_version
                except Exception:  # noqa: BLE001 — the controller reconciles
                    pass
        self.pending_tracker.note_evicted(full_name)
        # the member deletions rode the evented cluster mutators; the
        # gang-row reset above is the only out-of-band change: name it
        self.mark_dirty(group=full_name)

    def forget_denied(self, full_name: str) -> None:
        """Drop a gang's deny-cache entry (a preemption freed the capacity
        the denial was about; the 20 s stickiness would otherwise idle the
        freed capacity for its whole TTL)."""
        self.last_denied_pg.delete(full_name)

    def preempt_remove_pod(self, pod_to_schedule: Pod, pod_to_remove: Pod) -> None:
        """Raises SchedulingError when the preemption is forbidden.

        Phase rules (reference core.go:198-260): online preempts online
        freely; offline may never preempt online; nobody preempts members
        of Scheduled/Running gangs; a gang never preempts itself
        ("offline" = carries the group label).

        With the policy engine's "preempt" term the phase rule becomes
        PRIORITY TIERS (``_preempt_remove_tiered``): a victim is legal iff
        its priority class is strictly below the preemptor's, members of
        released (Scheduled/Running) gangs included unless
        ``protect_running``. The offline-may-not-preempt-online and
        no-self-preemption rules stay."""
        if self.policy is not None and self.policy.preemption:
            self._preempt_remove_tiered(pod_to_schedule, pod_to_remove)
            return
        remove_group, remove_offline = pod_group_name(pod_to_remove)
        schedule_group, schedule_offline = pod_group_name(pod_to_schedule)

        if not schedule_offline and not remove_offline:
            return

        if schedule_offline and not remove_offline:
            raise errs.SchedulingError(
                f"offline pod {pod_to_schedule.metadata.name} may not preempt "
                f"online pod {pod_to_remove.metadata.name}"
            )

        def check_victim() -> Tuple[str, Optional[Exception]]:
            full = f"{pod_to_remove.metadata.namespace}/{remove_group}"
            pgs = self.status_cache.get(full)
            if pgs is None:
                return "", errs.PodGroupNotFoundError(f"pod group not found: {full}")
            phase = pgs.pod_group.status.phase
            if phase in (PodGroupPhase.SCHEDULED, PodGroupPhase.RUNNING):
                return "", errs.SchedulingError(
                    "members of Scheduled/Running pod groups may not be preempted"
                )
            return full, None

        victim_full, err = check_victim()

        if not schedule_offline and remove_offline:
            if err is not None:
                raise err
            return

        # offline preempts offline
        schedule_full = f"{pod_to_schedule.metadata.namespace}/{schedule_group}"
        if victim_full == schedule_full:
            raise errs.SchedulingError("pod group may not preempt its own members")
        if err is not None:
            raise err

    def _preempt_remove_tiered(self, pod_to_schedule: Pod, pod_to_remove: Pod) -> None:
        """Priority-tier legality (the policy engine's preemption term):
        strictly-lower tier only, no self-preemption, offline still may not
        preempt online, and the phase protection only under
        ``protect_running``."""
        remove_group, remove_offline = pod_group_name(pod_to_remove)
        schedule_group, schedule_offline = pod_group_name(pod_to_schedule)
        if schedule_offline and not remove_offline:
            raise errs.SchedulingError(
                f"offline pod {pod_to_schedule.metadata.name} may not "
                f"preempt online pod {pod_to_remove.metadata.name}"
            )
        if pod_to_remove.spec.priority >= pod_to_schedule.spec.priority:
            raise errs.SchedulingError(
                f"victim {pod_to_remove.metadata.name} (tier "
                f"{pod_to_remove.spec.priority}) is not strictly below "
                f"preemptor tier {pod_to_schedule.spec.priority}"
            )
        if remove_offline:
            victim_full = f"{pod_to_remove.metadata.namespace}/{remove_group}"
            if schedule_offline:
                schedule_full = f"{pod_to_schedule.metadata.namespace}/{schedule_group}"
                if victim_full == schedule_full:
                    raise errs.SchedulingError("pod group may not preempt its own members")
            if self.policy.config.protect_running:
                pgs = self.status_cache.get(victim_full)
                if pgs is not None and pgs.pod_group.status.phase in (
                    PodGroupPhase.SCHEDULED,
                    PodGroupPhase.RUNNING,
                ):
                    raise errs.SchedulingError(
                        "members of Scheduled/Running pod groups may not "
                        "be preempted (protect_running)"
                    )

    # ------------------------------------------------------------------
    # Score (reference stub core.go:263-265 — real ranks in oracle mode)
    # ------------------------------------------------------------------

    def score(self, pod: Pod, node_name: str) -> int:
        pg_name, ok = pod_group_name(pod)
        if not ok or self.scorer_kind != "oracle":
            return MAX_SCORE
        full_name = f"{pod.metadata.namespace}/{pg_name}"
        return self._oracle_fresh().node_score(full_name, node_name)

    # ------------------------------------------------------------------
    # Permit (reference core.go:268-309)
    # ------------------------------------------------------------------

    def permit(self, pod: Pod, node_name: str) -> PermitOutcome:
        pg_name, ok = pod_group_name(pod)
        if not ok:
            return PermitOutcome(True, pg_name, errs.NotMatchedError())
        full_name = f"{pod.metadata.namespace}/{pg_name}"
        pgs = self.status_cache.get(full_name)
        if pgs is None:
            return PermitOutcome(
                False, pg_name, errs.PodGroupNotFoundError(full_name)
            )
        pg = pgs.pod_group
        if pgs.scheduled and pg.status.scheduled >= pg.spec.min_member:
            # Quorum met AND released: members beyond the minimum schedule
            # like ordinary pods (the reference strands them in a Permit
            # wait its release signal ignores, batchscheduler.go:258-262).
            return PermitOutcome(True, pg_name, errs.NotMatchedError())
        if pg.status.phase == PodGroupPhase.PENDING:
            pg.status.phase = PodGroupPhase.PRE_SCHEDULING

        pod_key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        wait = get_wait_seconds(pg, self.max_schedule_seconds)
        pgs.matched_pod_nodes.set(
            pod.metadata.uid, PodNodePair(pod_key, node_name), wait
        )
        old_uid = pgs.pod_name_uids.get(pod_key)
        if old_uid is not None and old_uid != pod.metadata.uid:
            # the pod was re-created; drop the stale permit (core.go:293-296)
            pgs.matched_pod_nodes.delete(old_uid)
        pgs.pod_name_uids.set(pod_key, pod.metadata.uid, wait)
        if self.scorer_kind != "oracle" or pgs.placement_plan is None:
            # Plan-covered gangs skip the per-pod invalidation: the batch's
            # assignment already placed every remaining member.
            self.mark_dirty(group=full_name)
        else:
            # plan-covered: no invalidation, but the matched count moved —
            # the next fold must re-read this gang's progress row
            self._gang_event(full_name)

        matched = len(pgs.matched_pod_nodes.items())
        if matched >= pg.spec.min_member - pg.status.scheduled:
            pgs.scheduled = True
            self.pending_tracker.note_placed(full_name)
            DEFAULT_LEDGER.note_permit(full_name)
            return PermitOutcome(True, pg_name, None)
        return PermitOutcome(False, pg_name, errs.WaitingError())

    # ------------------------------------------------------------------
    # PostBind (reference core.go:312-362)
    # ------------------------------------------------------------------

    def post_bind(self, pod: Pod, node_name: str) -> None:
        pg_name, ok = pod_group_name(pod)
        if not ok:
            return
        full_name = f"{pod.metadata.namespace}/{pg_name}"
        with self._lock:
            pgs = self.status_cache.get(full_name)
            if pgs is None:
                return
            pg = pgs.pod_group
            # max-of-lower-bounds, not addition: commutes with the
            # controller's live member count (see pg_cache.binds_committed)
            pgs.binds_committed += 1
            new_scheduled = max(pg.status.scheduled, pgs.binds_committed)
            if new_scheduled >= pg.spec.min_member:
                new_phase = PodGroupPhase.SCHEDULED
                new_start = pg.status.schedule_start_time
            else:
                new_phase = PodGroupPhase.SCHEDULING
                new_start = pg.status.schedule_start_time or time.time()

            if new_phase != pg.status.phase and self.pg_client is not None:
                # once per phase transition (at most 2 a gang): a targeted
                # status merge patch of exactly the fields this transition
                # owns; a failed patch leaves local state unadvanced, so
                # the next bind retries the transition
                try:
                    updated = self.pg_client.podgroups(
                        pg.metadata.namespace
                    ).patch(
                        pg.metadata.name,
                        {
                            "status": {
                                "phase": new_phase.value,
                                "scheduled": new_scheduled,
                                "schedule_start_time": new_start,
                            }
                        },
                    )
                    pg.status.phase = updated.status.phase
                except Exception:  # noqa: BLE001
                    return
            else:
                pg.status.phase = new_phase
                pg.status.schedule_start_time = new_start
            pg.status.scheduled = new_scheduled
            completed = new_scheduled >= pg.spec.min_member
        # Plan-covered member binds are pre-accounted; re-batch once per
        # gang completion, not per pod.
        if (
            completed
            or self.scorer_kind != "oracle"
            or pgs.placement_plan is None
        ):
            self.mark_dirty(group=full_name)
        else:
            # plan-covered, quorum not yet met: binds_committed/scheduled
            # advanced — name the row for the next event fold
            self._gang_event(full_name)

    # ------------------------------------------------------------------
    # Queue ordering (reference core.go:368-411)
    # ------------------------------------------------------------------

    def compare(self, pod1: Pod, ts1: float, pod2: Pod, ts2: float) -> bool:
        """True iff pod1 should be scheduled before pod2: priority, then
        PodGroup creation time, then (reverse) group name, then pod queue
        timestamp — reference Compare semantics, including its
        reverse-lexicographic name tiebreak (core.go:404)."""
        prio1, prio2 = pod1.spec.priority, pod2.spec.priority
        name1, _ = pod_group_name(pod1)
        name2, _ = pod_group_name(pod2)

        if prio1 > prio2:
            return True
        if prio1 == prio2:
            if not name1 and not name2:
                return ts1 < ts2
            if not name1:
                return True
            if not name2:
                return False
        if self.pg_lister is None:
            return False
        pg1 = self.pg_lister(pod1.metadata.namespace, name1)
        pg2 = self.pg_lister(pod2.metadata.namespace, name2)
        if pg1 is None or pg2 is None:
            return False
        c1, c2 = pg1.metadata.creation_timestamp, pg2.metadata.creation_timestamp
        if prio1 == prio2 and c1 < c2:
            return True
        if prio1 == prio2 and c1 == c2 and name1 > name2:
            return True
        return prio1 == prio2 and c1 == c2 and name1 == name2 and ts1 < ts2

    # After a group's cache entry dies, its name is TOMBSTONED for this
    # long: sort_key keeps answering from the (possibly lagging) lister
    # but does NOT re-cache, so a recreated group cannot get pinned to its
    # predecessor's creation timestamp read off a stale informer doc.
    CREATION_TOMBSTONE_S = 5.0

    def _forget_creation(self, full_name: str) -> None:
        """The status cache dropped the gang: its creation stamp leaves
        the sort-key cache (tombstoned), it is no longer pending (its age
        never resolves into the placement histogram) and its lifecycle
        ends with a delete event."""
        ns, _, name = full_name.partition("/")
        self._creation_cache.pop((ns, name), None)
        self._creation_tombstones[(ns, name)] = (
            self._clock() + self.CREATION_TOMBSTONE_S
        )
        self.pending_tracker.forget(full_name)
        DEFAULT_LEDGER.note_delete(full_name)

    def sort_key(self, info) -> tuple:
        """Total-order queue key equivalent to :meth:`compare` (reference
        Compare, core.go:368-411): priority desc → non-gang before gang →
        group creation asc → group name REVERSE-lex → queue timestamp asc.
        Computed once per push from the entry's scalar fields.

        One documented deviation: a gang pod whose PodGroup the lister has
        not yet observed gets creation=+inf (sorts after known gangs of
        equal priority); the comparator form answers "incomparable" there.
        Both resolve the same way once the group is observed — such pods
        fail PreFilter with PodGroupNotFound until then."""
        if not info.gang:
            return (-info.priority, 0, 0.0, _RevStr(""), info.timestamp)
        cache_key = (info.namespace, info.gang)
        created = self._creation_cache.get(cache_key)
        if created is None:
            created = float("inf")
            if self.pg_lister is not None:
                pg = self.pg_lister(info.namespace, info.gang)
                if pg is not None:
                    created = pg.metadata.creation_timestamp
            tomb = self._creation_tombstones.get(cache_key)
            if tomb is not None and self._clock() < tomb:
                pass  # recently deleted: the lister may still be stale
            elif created != float("inf"):
                if tomb is not None:
                    del self._creation_tombstones[cache_key]
                self._creation_cache[cache_key] = created
        return (
            -info.priority,
            1,
            created,
            _RevStr(info.gang),
            info.timestamp,
        )

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def add_to_deny_cache(self, full_name: str) -> None:
        self.last_denied_pg.add(full_name, "", DENY_TTL)
        # pending-gang aging (utils.health): every denial extends the
        # gang's pending window and its deny streak; placement resolves it
        self.pending_tracker.note_deny(full_name)

    def get_pod_node_pairs(self, full_name: str) -> Optional[TTLCache]:
        pgs = self.status_cache.get(full_name)
        return pgs.matched_pod_nodes if pgs is not None else None

    def get_pod_name_uids(self, full_name: str) -> Optional[TTLCache]:
        pgs = self.status_cache.get(full_name)
        return pgs.pod_name_uids if pgs is not None else None

    def _fill_occupied(self, pgs: PodGroupMatchStatus, pod: Pod) -> None:
        """Owner-reference fencing: a PodGroup belongs to the first workload
        whose pods claim it (reference fillOccupiedObj, core.go:477-512)."""
        if pgs is None or pgs.pod_group is None:
            raise errs.SchedulingError("pod group match status is nil")
        refs = sorted(str(r) for r in pod.metadata.owner_references)
        if pgs.pod is None:
            pgs.pod = pod
            # The demand row only *changes* if the pod carries placement
            # constraints the spec didn't or fixes the member shape below.
            if (
                pod.spec.priority
                or pod.spec.node_selector
                or pod.spec.tolerations
                or pgs.pod_group.spec.min_resources is None
            ):
                self.mark_dirty(group=pgs.pod_group.full_name())
        if pgs.pod_group.spec.min_resources is None:
            pgs.pod_group.spec.min_resources = pod.resource_require()
            self.mark_dirty(group=pgs.pod_group.full_name())
        occupied = pgs.pod_group.status.occupied_by
        if not occupied:
            if refs:
                pgs.pod_group.status.occupied_by = ",".join(refs)
            return
        if not refs or ",".join(refs) != occupied:
            raise errs.OccupiedError(
                f"pod group {pgs.pod_group.full_name()} occupied by {occupied}"
            )
