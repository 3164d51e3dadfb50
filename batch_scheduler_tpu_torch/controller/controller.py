"""PodGroupController: the informer-driven phase-machine reconciler.

Behavioural port of the reference controller
(reference pkg/scheduler/controller/controller.go:48-335): creates the
per-group match-status cache entries (wiring TTL eviction to the gang-abort
callback), normalises ""->Pending, recovers crash state by listing member
pods, drives Pending -> PreScheduling -> Scheduling -> Scheduled -> Running
-> Finished/Failed from live member pod phases, and persists every status
delta as a merge patch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Callable, List, Optional

from ..api.types import (
    PodGroup,
    PodGroupPhase,
    PodGroupStatus,
    PodPhase,
    to_dict,
)
from ..cache.pg_cache import PGStatusCache, PodGroupMatchStatus
from ..client.apiserver import NotFoundError
from ..client.clientset import Clientset
from ..client.informers import SharedInformer
from ..utils.labels import POD_GROUP_LABEL, get_wait_seconds
from ..utils.patch import create_merge_patch
from ..utils.workqueue import RateLimitingQueue

__all__ = ["PodGroupController"]

# Re-enqueue guard: groups stuck past this horizon are left alone because
# their pods may have been garbage collected (reference controller.go:122-125).
GC_HORIZON_SECONDS = 48 * 3600.0


class PodGroupController:
    def __init__(
        self,
        client: Clientset,
        pg_informer: SharedInformer,
        pg_cache: PGStatusCache,
        reject_pod: Callable[[str], None],
        add_to_backoff: Callable[[str], None],
        rate_limiter_base: float = 1.0,
        rate_limiter_cap: float = 10.0,
        max_schedule_seconds: Optional[float] = None,
        resync_seconds: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        pod_informer=None,
    ):
        self.client = client
        # optional SharedInformer("Pod"): member-pod scans read uid/phase
        # from its raw store (label-indexed, no copies) instead of a
        # deep-copying API list per sync — the client-go lister pattern the
        # reference controller uses (controller.go:148-176)
        self._pod_informer = pod_informer
        self.pg_cache = pg_cache
        self.reject_pod = reject_pod
        self.add_to_backoff = add_to_backoff
        self.max_schedule_seconds = max_schedule_seconds
        self.resync_seconds = resync_seconds
        self._clock = clock
        self._limiter_args = (rate_limiter_base, rate_limiter_cap, clock)
        self.queue = RateLimitingQueue(*self._limiter_args)
        self._informer = pg_informer
        pg_informer.add_event_handler(
            on_add=self._pg_added_raw,
            on_update=self._pg_updated_raw,
            on_delete=self._pg_deleted_raw,
            raw=True,
        )
        self._stop = threading.Event()
        self._workers: List[threading.Thread] = []

    # -- informer handlers (reference controller.go:111-145) ---------------

    # raw-dict handlers: the watch stream delivers a handful of events per
    # gang (create + every status patch); the enqueue decision needs five
    # scalar fields, not a typed rehydration per event. The restart path
    # (run) feeds the same predicate from the informer's raw store, so the
    # GC/phase-skip rule exists exactly once.
    def _pg_added_raw(self, d: dict) -> None:
        status = d.get("status") or {}
        phase = status.get("phase") or ""
        if phase in (PodGroupPhase.FINISHED.value, PodGroupPhase.FAILED.value):
            return
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        if (
            status.get("scheduled", 0) == spec.get("min_member", 0)
            and status.get("running", 0) == 0
            and (status.get("schedule_start_time") or 0.0)
            - (meta.get("creation_timestamp") or 0.0)
            > GC_HORIZON_SECONDS
        ):
            return
        self.queue.add(
            f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        )

    def _pg_updated_raw(self, old: Optional[dict], new: dict) -> None:
        self._pg_added_raw(new)

    def _pg_deleted_raw(self, d: dict) -> None:
        meta = d.get("metadata") or {}
        self.pg_cache.delete(
            f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        )

    # -- run loop (reference controller.go:93-108) -------------------------

    def run(self, workers: int, stop_event: Optional[threading.Event] = None) -> None:
        self._stop = stop_event or threading.Event()
        if self.queue.is_shut_down():
            # restart after a lease loss: the old queue is dead; re-enqueue
            # every known group so reconciliation resumes cleanly
            self.queue = RateLimitingQueue(*self._limiter_args)
            for d in self._informer.list_raw():
                self._pg_added_raw(d)
        self._informer.wait_for_sync()
        for i in range(workers):
            t = threading.Thread(
                target=self._worker, name=f"pg-controller-{i}", daemon=True
            )
            t.start()
            self._workers.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()

    def _worker(self) -> None:
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            try:
                self._sync(key)
            except Exception:
                # a failing sync retries with backoff; never kill the worker
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)

    # -- sync (reference controller.go:148-176) ----------------------------

    def _sync(self, key: str) -> None:
        namespace, _, name = key.partition("/")
        # shared read-only typed view (one materialisation per store
        # update, not one per sync — the deep-copying ``get`` was the
        # controller workers' top cost at 10k-pod scale). _sync_handler
        # never mutates it: every write goes through replace() copies, and
        # the cache entry takes a private copy at init.
        pg = self._informer.get_typed(namespace, name)
        if pg is None:
            try:
                pg = self.client.podgroups(namespace).get(name)
            except NotFoundError:
                self.pg_cache.delete(key)
                return
        self._sync_handler(pg, key)

    # -- the phase machine (reference controller.go:179-311) ---------------

    def _sync_handler(self, pg: PodGroup, key: str) -> None:
        # terminal groups never resync: no cache resurrection, no pod lists,
        # no dead rows in the oracle batch
        if pg.status.phase in (PodGroupPhase.FINISHED, PodGroupPhase.FAILED):
            self.pg_cache.delete(key)
            return

        pgs = self.pg_cache.get(key)
        if pgs is None:
            pgs = self._init_match_status(pg, key)
            self.pg_cache.set(key, pgs)

        # count_lock makes this sync one step against a policy eviction's
        # reset of the gang (ScheduleOperation.note_gang_evicted), which
        # stamps evicted_rv with its status patch's resource version. A
        # view older than that predates the eviction: it counts the
        # deleted members and, folded in below, would restore the gang's
        # old progress over the reset for good (the respawned members then
        # pass Permit as if the gang were already released). Such a view
        # is skipped; the reset's own watch event syncs the gang again.
        # (A port-only fence: the reference has the race.)
        with pgs.count_lock:
            if pg.metadata.resource_version < pgs.evicted_rv:
                resync = True
            else:
                pgs.evicted_rv = 0
                resync = self._sync_status(pg, key, pgs)
        if resync:
            # periodic resync keeps pod-count-driven transitions flowing
            # (reference re-enqueues unconditionally, controller.go:310)
            self.queue.add_after(key, self.resync_seconds)

    def _sync_status(self, pg: PodGroup, key: str, pgs: PodGroupMatchStatus) -> bool:
        """The phase machine's body for one view ``pg`` of the group
        (count_lock held). Returns whether the group resyncs later."""
        # pgs.pod_group may alias pg (cache holds the informer object); diff
        # against an immutable snapshot so cache syncs don't mask the patch.
        # Only status is ever mutated here and its fields are all scalars,
        # so a shallow field copy is a true snapshot — the full-object
        # deepcopy this replaces was ~half the controller's sync cost.
        original = replace(pg.status)
        pg_copy = replace(pg, status=replace(pg.status))
        if pg_copy.status.phase == PodGroupPhase.EMPTY:
            pg_copy.status.phase = PodGroupPhase.PENDING
        elif (
            pg_copy.status.phase == PodGroupPhase.PENDING
            and pg_copy.status.schedule_start_time != 0
        ):
            # crash recovery: re-derive Scheduled from live member pods
            # (reference controller.go:201-222)
            pg_copy.status.scheduled = len(self._member_phases(pg_copy))
            if pg_copy.status.scheduled > 0:
                self._patch_if_changed(original, pg_copy)

        # Refresh the cached group's status from the API view — but never
        # regress locally-advanced scheduling progress: Permit/PostBind
        # advance phase and the scheduled counter in the cache first and
        # persist only on transitions (core semantics), and the gang release
        # gate reads the cache, so a clobber here could strand a complete
        # gang. (The reference clobbers, controller.go:225, and tolerates
        # the race by timing; we close it.) Controller-derived Running/
        # Failed/Finished always win.
        rank = {
            PodGroupPhase.EMPTY: 0,
            PodGroupPhase.PENDING: 1,
            PodGroupPhase.PRE_SCHEDULING: 2,
            PodGroupPhase.SCHEDULING: 3,
            PodGroupPhase.SCHEDULED: 4,
        }
        local = pgs.pod_group.status
        if (
            local.phase in rank
            and pg_copy.status.phase in rank
            and rank[local.phase] > rank[pg_copy.status.phase]
        ):
            pg_copy.status.phase = local.phase
        if local.scheduled > pg_copy.status.scheduled:
            pg_copy.status.scheduled = local.scheduled
        pgs.pod_group.status = pg_copy.status
        self.pg_cache.set(key, pgs)

        if (
            pg_copy.status.scheduled == pg_copy.spec.min_member
            and pg_copy.status.running == 0
            and pg_copy.status.schedule_start_time
            - pg_copy.metadata.creation_timestamp
            > GC_HORIZON_SECONDS
        ):
            return False

        if pg_copy.status.phase in (
            PodGroupPhase.SCHEDULED,
            PodGroupPhase.RUNNING,
            PodGroupPhase.SCHEDULING,
            # PRE_SCHEDULING is beyond the reference's gate
            # (controller.go:235: Scheduling+), but bound members CAN
            # exist here — a bind whose API response was lost, or a
            # scheduler crash between bind and PostBind, leaves the gang
            # pre-scheduling with live non-Pending members and an
            # undercounted Status.Scheduled. Without this row the permit
            # quorum (minMember - scheduled) stays unreachable and the
            # gang loops park -> TTL abort -> park forever (found by the
            # gateway-restart soak at seed run 4: 7 members parked
            # needing 9, with 3 bound-but-uncounted siblings).
            PodGroupPhase.PRE_SCHEDULING,
        ):
            members = self._member_phases(pg_copy)
            not_pending = 0
            running = 0
            for uid, phase in members:
                if phase == PodPhase.RUNNING.value:
                    running += 1
                elif phase == PodPhase.SUCCEEDED.value:
                    pgs.succeed[uid] = ""
                elif phase == PodPhase.FAILED.value:
                    pgs.failed[uid] = ""
                if phase != PodPhase.PENDING.value:
                    not_pending += 1
            pg_copy.status.failed = len(pgs.failed)
            pg_copy.status.succeeded = len(pgs.succeed)
            pg_copy.status.running = running
            if not_pending > pg_copy.status.scheduled:
                pg_copy.status.scheduled = not_pending

            # demote when members went missing (reference :276-279)
            if 0 != not_pending < pg_copy.spec.min_member:
                pg_copy.status.scheduled = not_pending
                pg_copy.status.phase = PodGroupPhase.SCHEDULING

            if pg_copy.status.succeeded + pg_copy.status.running >= pg.spec.min_member:
                pg_copy.status.phase = PodGroupPhase.RUNNING
            if (
                pg_copy.status.failed != 0
                and pg_copy.status.failed
                + pg_copy.status.running
                + pg_copy.status.succeeded
                >= pg.spec.min_member
            ):
                pg_copy.status.phase = PodGroupPhase.FAILED
            if pg_copy.status.succeeded >= pg.spec.min_member:
                pg_copy.status.phase = PodGroupPhase.FINISHED

        updated = self._patch_if_changed(original, pg_copy)
        terminal = False
        if updated is not None:
            if updated.status.phase in (PodGroupPhase.FINISHED, PodGroupPhase.FAILED):
                self.pg_cache.delete(key)
                terminal = True
            else:
                pgs.pod_group.status = updated.status
                # re-stored in place: the status change is heard by the
                # cache's on_update callbacks (the scorer's event fold)
                self.pg_cache.set(key, pgs)
            self.queue.forget(key)
        return not terminal

    # -- helpers -----------------------------------------------------------

    def _member_phases(self, pg: PodGroup) -> list:
        """(uid, phase-string) per member pod — the only fields the phase
        machine reads. Informer-backed when available (raw dicts, no copy);
        API list otherwise — including while the informer is still replaying
        its initial list (controller start / leader failover), when a
        partial store would under-count members and demote healthy gangs."""
        if self._pod_informer is not None and self._pod_informer.has_synced():
            return [
                (
                    (d.get("metadata") or {}).get("uid", ""),
                    (d.get("status") or {}).get("phase", PodPhase.PENDING.value),
                )
                for d in self._pod_informer.list_raw_by_label(
                    pg.metadata.namespace,
                    {POD_GROUP_LABEL: pg.metadata.name},
                )
            ]
        return [
            (p.metadata.uid, p.status.phase.value)
            for p in self.client.pods(pg.metadata.namespace).list(
                label_selector={POD_GROUP_LABEL: pg.metadata.name}
            )
        ]

    def _patch_if_changed(self, original_status: PodGroupStatus, pg_copy: PodGroup):
        """Status-only merge patch: the sync handler never mutates metadata
        or spec, so the diff (and the serialisation cost) is confined to the
        handful of scalar status fields."""
        status_patch = create_merge_patch(
            to_dict(original_status), to_dict(pg_copy.status)
        )
        if not status_patch:
            return None
        try:
            return self.client.podgroups(pg_copy.metadata.namespace).patch(
                pg_copy.metadata.name, {"status": status_patch}
            )
        except NotFoundError:
            return None

    def _init_match_status(self, pg: PodGroup, key: str) -> PodGroupMatchStatus:
        """Create the live gang bookkeeping entry; TTL expiry of the
        pod-name->UID cache aborts the whole gang
        (reference initPodGroupMatchStatus + OnEvicted,
        controller.go:314-335)."""
        ttl = get_wait_seconds(pg, self.max_schedule_seconds)
        # private copy: the cache entry's group is mutated in place by
        # Permit/PostBind/_fill_occupied (status fields, spec.min_resources)
        # and must never alias the informer's shared typed view
        pg = replace(pg, spec=replace(pg.spec), status=replace(pg.status))
        pgs = PodGroupMatchStatus(pg, match_ttl=ttl, clock=self._clock)

        def on_evicted(_key: str, _value) -> None:
            for pod_uid in list(pgs.matched_pod_nodes.items()):
                self.reject_pod(pod_uid)
                pgs.matched_pod_nodes.delete(pod_uid)
            pgs.pod_name_uids.flush()
            self.add_to_backoff(key)

        pgs.pod_name_uids.on_evicted(on_evicted)
        return pgs
