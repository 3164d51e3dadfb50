"""In-memory API server: the durable-state store and watch hub.

Plays the role the Kubernetes API server plays for the reference — the only
durable state in the system (reference keeps all persistent state in CRD
status patched over HTTPS; in-memory caches are rebuilt from informers,
SURVEY.md §5 "Checkpoint/resume"). Objects are stored as plain dicts keyed
by (kind, namespace, name); writers get JSON-merge-patch semantics; watchers
get ordered ADDED/MODIFIED/DELETED events over thread-safe queues.

The fake clientset for tests (reference pkg/generated/clientset/versioned/
fake) is this same store with no external transport — see client.fake.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api.serde import object_from_dict
from ..api.types import new_uid, to_dict
from ..utils.patch import apply_merge_patch, json_deepcopy

__all__ = ["APIServer", "WatchEvent", "NotFoundError", "ConflictError", "AlreadyExistsError"]


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(ValueError):
    pass


class ConflictError(ValueError):
    pass


class WatchEvent:
    __slots__ = ("type", "kind", "obj")

    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"

    def __init__(self, type_: str, kind: str, obj: dict):
        self.type = type_
        self.kind = kind
        self.obj = obj

    def object(self):
        """Rehydrate the typed API object (deep copy; safe to mutate)."""
        return object_from_dict(self.kind, json_deepcopy(self.obj))


class APIServer:
    def __init__(self, clock: Callable[[], float] = time.time):
        self._lock = threading.RLock()
        self._clock = clock
        # kind -> (namespace, name) -> dict
        self._store: Dict[str, Dict[Tuple[str, str], dict]] = {}  # guarded-by: _lock
        self._rv = 0  # guarded-by: _lock
        self._watchers: Dict[str, List[queue.Queue]] = {}  # guarded-by: _lock
        self._crds: Dict[str, dict] = {}  # guarded-by: _lock
        # label index: kind -> (label_key, label_value) -> object keys —
        # keeps selector lists (the controller's per-group member listing,
        # reference controller.go:235-241) O(matches), not O(all objects)
        self._label_idx: Dict[str, Dict[Tuple[str, str], Set[Tuple[str, str]]]] = {}  # guarded-by: _lock
        # bind fencing token: each gateway generation advances it at
        # startup (serve_gateway) and stamps its binds with the epoch it
        # was born under. A handler thread that outlives its gateway's
        # death (shutdown/server_close stop the accept loop and sever
        # sockets, but cannot kill a thread already past the read) would
        # otherwise apply its bind against this shared store AFTER a
        # restarted gateway served the scheduler a fresh liveness read —
        # the zombie-bind over-commit (test_fuzz_combo_selector_churn_
        # outage). Fenced binds are dropped, making "unbound on a read
        # through the NEW gateway" conclusive evidence the lost request
        # will never apply.
        self._bind_epoch = 0

    # -- helpers -----------------------------------------------------------

    def _kind_store(self, kind: str) -> Dict[Tuple[str, str], dict]:  # lock-held: _lock
        return self._store.setdefault(kind, {})

    @staticmethod
    def _labels_of(obj: dict) -> dict:
        return (obj.get("metadata") or {}).get("labels") or {}

    def _index_add(self, kind: str, key: Tuple[str, str], obj: dict) -> None:  # lock-held: _lock
        idx = self._label_idx.setdefault(kind, {})
        for kv in self._labels_of(obj).items():
            idx.setdefault(kv, set()).add(key)

    def _index_remove(self, kind: str, key: Tuple[str, str], obj: dict) -> None:  # lock-held: _lock
        idx = self._label_idx.get(kind, {})
        for kv in self._labels_of(obj).items():
            bucket = idx.get(kv)
            if bucket is not None:
                bucket.discard(key)

    def _notify(self, kind: str, event: WatchEvent) -> None:  # lock-held: _lock
        """Fan an event out to every watcher.

        ``event.obj`` is the STORED dict itself, shared by all watchers and
        informer stores — never a per-event copy. Safe because stored dicts
        are immutable once stored: every write verb replaces the store entry
        with a new document (patch copy-on-writes via apply_merge_patch and
        re-dicts metadata before stamping resource_version), and all raw
        readers (informer stores/peek_raw/list_raw_by_label, the HTTP
        gateway's serializer) are read-only by contract. GET/LIST responses
        at the API boundary still deep-copy."""
        for q in self._watchers.get(kind, []):
            q.put(event)

    def _notify_many(self, kind: str, events: List[WatchEvent]) -> None:  # lock-held: _lock
        """Batched fanout: ONE queue put per watcher for a whole chunk of
        events (same shared-stored-dict contract as _notify). The put/get
        machinery costs ~2µs a side, so per-object puts across a 30k-event
        flood were measurable GIL load on every writer thread. Consumers
        receive the list as one queue item; utils.drain.drain_queue
        flattens transparently, and direct q.get() readers (the HTTP
        gateway stream) normalise with `isinstance(item, list)`."""
        if not events:
            return
        for q in self._watchers.get(kind, []):
            q.put(events)

    @staticmethod
    def _as_dict(obj) -> dict:
        return obj if isinstance(obj, dict) else to_dict(obj)

    # -- CRD registration (reference batchscheduler.go:416-436) -----------

    def ensure_crd(self, name: str, spec: Optional[dict] = None) -> bool:
        """Idempotent CRD create; returns True if newly created."""
        with self._lock:
            if name in self._crds:
                return False
            self._crds[name] = spec or {}
            return True

    def crds(self) -> List[str]:
        with self._lock:
            return list(self._crds)

    # -- CRUD --------------------------------------------------------------

    def create(self, kind: str, obj) -> dict:
        d = json_deepcopy(self._as_dict(obj))
        meta = d.setdefault("metadata", {})
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        with self._lock:
            store = self._kind_store(kind)
            if key in store:
                raise AlreadyExistsError(f"{kind} {key[0]}/{key[1]} exists")
            self._rv += 1
            meta["resource_version"] = self._rv
            if not meta.get("creation_timestamp"):
                meta["creation_timestamp"] = self._clock()
            # the real API server always stamps a UID at admission; gang
            # accounting (MatchedPodNodes/PodNameUIDs) is keyed by it
            if not meta.get("uid"):
                meta["uid"] = new_uid(kind.lower())
            store[key] = d
            self._index_add(kind, key, d)
            self._notify(kind, WatchEvent(WatchEvent.ADDED, kind, d))
            return json_deepcopy(d)

    def create_many(
        self, kind: str, objs: List[dict], assume_fresh: bool = False
    ) -> int:
        """Bulk create: one lock pass, one ADDED event per object, and no
        per-object response copies (callers ingesting load — the sim
        harness feeding 10k pods — never read the responses; the per-call
        ``create`` pays two deep copies per object). Name conflicts
        present at call time raise before anything commits; the lock is
        then released between commit chunks (a 10k-object ingest must not
        block every concurrent patch/bind for its whole duration), so an
        object racing a concurrent ``create`` of the same name is skipped
        — the returned count is the number ACTUALLY created.

        ``assume_fresh``: skip the defensive deep copy when every dict was
        freshly built for this call and never retained by the caller (the
        sim harness's to_dict output) — the store takes ownership."""
        docs = []
        for obj in objs:
            d = self._as_dict(obj)
            if not assume_fresh:
                d = json_deepcopy(d)
            d.setdefault("metadata", {})
            docs.append(d)
        keys = [
            (
                d["metadata"].get("namespace", "default"),
                d["metadata"].get("name", ""),
            )
            for d in docs
        ]
        if len(set(keys)) != len(keys):
            raise AlreadyExistsError("duplicate names in create_many batch")
        with self._lock:
            store = self._kind_store(kind)
            for key in keys:
                if key in store:
                    raise AlreadyExistsError(f"{kind} {key[0]}/{key[1]} exists")
        chunk = 256
        created = 0
        for start in range(0, len(docs), chunk):
            with self._lock:
                store = self._kind_store(kind)
                events = []
                for d, key in zip(
                    docs[start : start + chunk], keys[start : start + chunk]
                ):
                    if key in store:  # raced a concurrent create: skip
                        continue
                    meta = d["metadata"]
                    self._rv += 1
                    meta["resource_version"] = self._rv
                    if not meta.get("creation_timestamp"):
                        meta["creation_timestamp"] = self._clock()
                    if not meta.get("uid"):
                        meta["uid"] = new_uid(kind.lower())
                    store[key] = d
                    self._index_add(kind, key, d)
                    events.append(WatchEvent(WatchEvent.ADDED, kind, d))
                    created += 1
                self._notify_many(kind, events)
        return created

    def patch_many(
        self, kind: str, namespace: str, patches: List[Tuple[str, dict]]
    ) -> List[str]:
        """Bulk merge patch: one lock pass, one patch + MODIFIED event per
        object, no response copies. Missing objects are skipped. Returns
        the names patched. (The sim kubelet drives thousands of
        Pending->Running transitions per run; per-call ``patch`` pays a
        response deep copy and a lock round trip each.)"""
        patched: List[str] = []
        chunk = 64  # bounded lock hold, like bind_pods
        for start in range(0, len(patches), chunk):
            with self._lock:
                store = self._kind_store(kind)
                events = []
                for name, patch in patches[start : start + chunk]:
                    key = (namespace, name)
                    old = store.get(key)
                    if old is None:
                        continue
                    merged = apply_merge_patch(old, patch)
                    self._rv += 1
                    merged["metadata"] = dict(merged.get("metadata") or {})
                    merged["metadata"]["resource_version"] = self._rv
                    self._index_remove(kind, key, old)
                    store[key] = merged
                    self._index_add(kind, key, merged)
                    events.append(WatchEvent(WatchEvent.MODIFIED, kind, merged))
                    patched.append(name)
                self._notify_many(kind, events)
        return patched

    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._lock:
            obj = self._kind_store(kind).get((namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return json_deepcopy(obj)

    def bound_pods_by_label(self, key: str) -> Dict[Tuple[str, str], int]:
        """(namespace, value of label ``key``) -> pods carrying it that are
        bound to a node: one pass over the stored pods, nothing copied (a
        poll of every gang's bound members, where ``list`` per gang would
        copy and decode each member)."""
        out: Dict[Tuple[str, str], int] = {}
        with self._lock:
            for (namespace, _), obj in self._kind_store("Pod").items():
                value = self._labels_of(obj).get(key)
                if value is not None and (obj.get("spec") or {}).get("node_name"):
                    out[(namespace, value)] = out.get((namespace, value), 0) + 1
        return out

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[dict]:
        with self._lock:
            store = self._kind_store(kind)
            if label_selector:
                # candidate set from the index on the first selector term,
                # verified against the rest — O(matches), not O(objects)
                idx = self._label_idx.get(kind, {})
                first, *rest = label_selector.items()
                keys = idx.get(first, set())
                out = []
                for key in keys:
                    obj = store.get(key)
                    if obj is None:
                        continue
                    if namespace is not None and key[0] != namespace:
                        continue
                    labels = self._labels_of(obj)
                    if any(labels.get(k) != v for k, v in rest):
                        continue
                    out.append(json_deepcopy(obj))
                return out
            return [
                json_deepcopy(obj)
                for (ns, _), obj in store.items()
                if namespace is None or ns == namespace
            ]

    def update(self, kind: str, obj) -> dict:
        """Replace an object. When the incoming object carries a nonzero
        ``metadata.resource_version``, it is an optimistic-concurrency
        precondition (Kubernetes update semantics): a mismatch with the
        stored version raises ConflictError — the compare-and-swap that
        makes API-server-backed leases race-free."""
        d = json_deepcopy(self._as_dict(obj))
        meta = d.setdefault("metadata", {})
        key = (meta.get("namespace", "default"), meta.get("name", ""))
        with self._lock:
            store = self._kind_store(kind)
            if key not in store:
                raise NotFoundError(f"{kind} {key[0]}/{key[1]} not found")
            expect = meta.get("resource_version")
            have = (store[key].get("metadata") or {}).get("resource_version")
            if expect and have and expect != have:
                raise ConflictError(
                    f"{kind} {key[0]}/{key[1]}: resource_version {expect} "
                    f"is stale (have {have})"
                )
            self._rv += 1
            meta["resource_version"] = self._rv
            self._index_remove(kind, key, store[key])
            store[key] = d
            self._index_add(kind, key, d)
            self._notify(kind, WatchEvent(WatchEvent.MODIFIED, kind, d))
            return json_deepcopy(d)

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        """RFC 7386 merge patch (the reference's only write verb for status,
        e.g. core.go:351, controller.go:300)."""
        with self._lock:
            store = self._kind_store(kind)
            key = (namespace, name)
            if key not in store:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            old = store[key]
            merged = apply_merge_patch(old, patch)
            self._rv += 1
            # apply_merge_patch shares untouched sub-trees with ``old``:
            # give merged its OWN metadata dict before stamping the new
            # resource_version, or the stamp would mutate the previous
            # object (and every shared watch event holding it) in place
            merged["metadata"] = dict(merged.get("metadata") or {})
            merged["metadata"]["resource_version"] = self._rv
            self._index_remove(kind, key, old)
            store[key] = merged
            self._index_add(kind, key, merged)
            self._notify(kind, WatchEvent(WatchEvent.MODIFIED, kind, merged))
            return json_deepcopy(merged)

    def advance_bind_epoch(self) -> int:
        """Advance the bind fencing token and return the new epoch (see
        ``_bind_epoch``). Called by each gateway generation at startup;
        binds stamped with an older epoch are dropped from then on."""
        with self._lock:
            self._bind_epoch += 1
            return self._bind_epoch

    def bind_pods(self, namespace: str, pairs: List[Tuple[str, str]],
                  epoch: int | None = None) -> List[str]:
        """Batched bind subresource: one lock pass, one merge patch + one
        MODIFIED event per pod. The whole-gang choreography binds a
        released gang as a unit (reference StartBatchSchedule releases a
        complete gang in one sweep, batchscheduler.go:254-344; here the
        bind itself is batched too). Missing pods are skipped — the caller
        forgets their assumed capacity. A bind patch touches only
        ``spec.node_name``, so the label index needs no maintenance.
        Returns the names actually bound.

        ``epoch`` (gateway binds) fences zombie writers: a request born
        under an epoch older than the store's current one applies NOTHING
        (checked per chunk, so a fence racing a long bind stops it at the
        next chunk boundary). In-process callers pass no epoch and are
        never fenced."""
        bound: List[str] = []
        chunk = 64  # bounded lock hold: a whole-flush bind (10s of pods)
        for start in range(0, len(pairs), chunk):
            with self._lock:
                if epoch is not None and epoch < self._bind_epoch:
                    # fenced: a newer gateway generation owns binding now
                    return bound
                store = self._kind_store("Pod")
                events = []
                for name, node_name in pairs[start : start + chunk]:
                    key = (namespace, name)
                    old = store.get(key)
                    if old is None:
                        continue
                    # hand-rolled single-field merge: same copy-on-write
                    # shape apply_merge_patch produces for this patch,
                    # without the generic merge walk (the bind storm is
                    # the hottest write path in the system)
                    merged = dict(old)
                    merged["spec"] = dict(old.get("spec") or {})
                    merged["spec"]["node_name"] = node_name
                    self._rv += 1
                    merged["metadata"] = dict(merged.get("metadata") or {})
                    merged["metadata"]["resource_version"] = self._rv
                    store[key] = merged
                    events.append(WatchEvent(WatchEvent.MODIFIED, "Pod", merged))
                    bound.append(name)
                self._notify_many("Pod", events)
        return bound

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            store = self._kind_store(kind)
            obj = store.pop((namespace, name), None)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            self._index_remove(kind, (namespace, name), obj)
            self._notify(kind, WatchEvent(WatchEvent.DELETED, kind, obj))

    def delete_collection(
        self, kind: str, namespace: Optional[str] = None
    ) -> int:
        with self._lock:
            store = self._kind_store(kind)
            keys = [k for k in store if namespace is None or k[0] == namespace]
            for k in keys:
                obj = store.pop(k)
                self._index_remove(kind, k, obj)
                self._notify(kind, WatchEvent(WatchEvent.DELETED, kind, obj))
            return len(keys)

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, *, replay: bool = True) -> "queue.Queue[WatchEvent]":
        """Subscribe to a kind's event stream. With ``replay``, current
        objects are delivered first as ADDED events (informer list+watch)."""
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        with self._lock:
            if replay:
                # stored dicts are immutable once stored (see _notify):
                # replayed events share them like live events do
                for obj in self._kind_store(kind).values():
                    q.put(WatchEvent(WatchEvent.ADDED, kind, obj))
            self._watchers.setdefault(kind, []).append(q)
        return q

    def stop_watch(self, kind: str, q: queue.Queue) -> None:
        with self._lock:
            watchers = self._watchers.get(kind, [])
            if q in watchers:
                watchers.remove(q)
