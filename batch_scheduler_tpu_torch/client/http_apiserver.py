"""HTTPAPIServer: point the control plane at a remote API server.

The port of ``batch_scheduler_tpu/client/http_apiserver.py``. It has the
interface of ``client.apiserver.APIServer`` (create / get / list / update /
patch / delete / delete_collection / bind_pods / watch / stop_watch /
ensure_crd) over Kubernetes-shaped HTTP: the dialect ``client.http_gateway``
serves, the JAX package's gateway too. ``Clientset`` and
``SharedInformerFactory`` take it unchanged, so the whole scheduler stack
(``sim.harness.SimCluster(api=HTTPAPIServer(...))``) runs against an
external endpoint, with the reference's client throttles (QPS 10 / burst
20, and an optional separate PodGroup bucket) at the same defaults.
"""

from __future__ import annotations

import http.client
import json
import queue
import socket
import threading
from typing import Dict, List, Optional
from urllib.parse import quote

from .apiserver import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    WatchEvent,
)
from ..utils.throttle import TokenBucket
from .http_gateway import CRD_PATH, KIND_ROUTES
from ..api.types import to_dict

__all__ = ["HTTPAPIServer"]


class HTTPAPIServer:
    """APIServer-interface client over HTTP (persistent per-thread
    request connections, client-go style; watches hold a streaming
    connection + reader thread per subscription)."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 10.0,
        qps: float = 10.0,
        burst: int = 20,
        pg_qps: Optional[float] = None,
        pg_burst: int = 20,
        batch_bind: bool = True,
    ):
        self.host = host
        self.port = port
        self.timeout = timeout
        # Client-side flow control at the reference's defaults (QPS=10 /
        # Burst=20, batchscheduler.go:391-392): every request verb takes a
        # token first, so the controller's resync across all groups cannot
        # stampede a real API server. Watch streams pace themselves via
        # the reflector's reconnect backoff instead. qps<=0 disables.
        #
        # ``pg_qps``/``pg_burst`` carve out a SEPARATE bucket for PodGroup
        # verbs, mirroring the reference deployment where the PG clientset
        # has its own rest.Config throttle (10/20) while the embedding
        # kube-scheduler's client runs at its own limits (50/100 defaults)
        # — one shared bucket would let pod traffic starve gang status
        # writes and vice versa.
        self._limiter = TokenBucket(qps, burst)
        # pg_burst applies only when pg_qps enables the separate bucket
        self._pg_limiter = (
            TokenBucket(pg_qps, pg_burst) if pg_qps is not None else None
        )
        # ``batch_bind=False`` forces per-pod PATCH binds (measurement
        # control: quantifies what the pods:bindmany verb buys at a fixed
        # client QPS — benchmarks/http_e2e.py)
        self._batch_bind = batch_bind
        # id(queue) -> {"conn", "resp", "thread", "stop"} (see watch())
        self._watches: Dict[int, dict] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # per-thread persistent connection for request/response verbs
        # (client-go keeps connections alive the same way); watches use
        # their own streaming connections
        self._local = threading.local()

    # -- request plumbing --------------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            conn.connect()
            # small request/response exchanges on a kept-alive connection
            # hit the Nagle/delayed-ACK stall (~40ms each) without this
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except OSError:
                pass

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        kind: Optional[str] = None,
        resend_safe: bool = False,
    ) -> dict:
        limiter = self._limiter
        if kind == "PodGroup" and self._pg_limiter is not None:
            limiter = self._pg_limiter
        limiter.acquire()
        payload = None if body is None else json.dumps(body)
        headers = {"Content-Type": "application/json"} if payload else {}
        # one reconnect retry: a kept-alive connection the server closed
        # between requests (restart, idle timeout) surfaces as a
        # connection-level error; a fresh connection disambiguates a real
        # outage from a stale socket. A failure AFTER the request bytes
        # went out may mean the server applied it with only the response
        # lost, so post-send retries are limited to verbs safe to
        # double-apply — a re-sent POST could turn a lost create response
        # into a spurious AlreadyExists. PATCH qualifies ONLY because
        # every patch through this client is an RFC 7386 merge patch
        # (absolute field values, idempotent); a future read-modify-write
        # or JSON-patch verb must come off this list. ``resend_safe``
        # marks a POST that qualifies the same way (``pods:bindmany``).
        idempotent = resend_safe or method in ("GET", "PUT", "PATCH", "DELETE")
        for attempt in (0, 1):
            conn = self._conn()
            sent = False
            try:
                conn.request(method, path, body=payload, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = json.loads(resp.read() or b"{}")
                break
            except (OSError, http.client.HTTPException, ValueError):
                self._drop_conn()
                if attempt or (sent and not idempotent):
                    raise
        if resp.status == 404:
            raise NotFoundError(data.get("message", path))
        if resp.status == 409:
            if data.get("reason") == "Conflict":
                raise ConflictError(data.get("message", path))
            raise AlreadyExistsError(data.get("message", path))
        if resp.status >= 400:
            raise RuntimeError(f"{method} {path}: {resp.status} {data}")
        return data

    @staticmethod
    def _collection_path(kind: str, namespace: Optional[str]) -> str:
        prefix, plural, namespaced = KIND_ROUTES[kind]
        if namespaced and namespace:
            return f"{prefix}/namespaces/{quote(namespace)}/{plural}"
        return f"{prefix}/{plural}"

    def _object_path(self, kind: str, namespace: str, name: str) -> str:
        return f"{self._collection_path(kind, namespace)}/{quote(name)}"

    @staticmethod
    def _as_dict(obj) -> dict:
        return obj if isinstance(obj, dict) else to_dict(obj)

    # -- APIServer interface ----------------------------------------------

    def ensure_crd(self, name: str, spec: Optional[dict] = None) -> bool:
        try:
            self._request(
                "POST", CRD_PATH, {"metadata": {"name": name}, "spec": spec or {}}
            )
            return True
        except AlreadyExistsError:
            return False

    def crds(self) -> List[str]:
        return self._request("GET", CRD_PATH)["items"]

    def create(self, kind: str, obj) -> dict:
        d = self._as_dict(obj)
        ns = (d.get("metadata") or {}).get("namespace", "default")
        return self._request("POST", self._collection_path(kind, ns), d, kind=kind)

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._request(
            "GET", self._object_path(kind, namespace, name), kind=kind
        )

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[dict]:
        path = self._collection_path(kind, namespace)
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
            path += f"?labelSelector={quote(sel)}"
        return self._request("GET", path, kind=kind)["items"]

    def update(self, kind: str, obj) -> dict:
        d = self._as_dict(obj)
        meta = d.get("metadata") or {}
        path = self._object_path(
            kind, meta.get("namespace", "default"), meta.get("name", "")
        )
        return self._request("PUT", path, d, kind=kind)

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        return self._request(
            "PATCH", self._object_path(kind, namespace, name), patch, kind=kind
        )

    def bind_pods(self, namespace: str, pairs) -> List[str]:
        """Batched bind over the wire: ONE request (one throttle token)
        for a whole released gang, via the gateway's ``pods:bindmany``
        custom verb — the cross-gang commit flush's per-gang API-pass
        amortization carried over HTTP (Clientset.bind_many dispatches
        here via the ``bind_pods`` duck type). Falls back to per-pod
        PATCH binds against a gateway without the route (404), keeping
        the bind_many contract: returns names bound, skips missing."""
        if self._batch_bind:
            path = self._collection_path("Pod", namespace) + ":bindmany"
            try:
                # resend_safe: a bind sets absolute values, as the merge
                # PATCH it replaces does, and a re-send reaches the live
                # gateway generation under its own epoch. Without the
                # re-send a restart makes every bind in flight an
                # ambiguous failure, which the scheduler settles only by
                # a read and a requeue
                return self._request(
                    "POST", path, {"binds": [[n, node] for n, node in pairs]},
                    resend_safe=True,
                )["bound"]
            except NotFoundError:
                # gateway without the batch verb: remember (capability
                # discovered once, client-go style) so later flushes skip
                # the deterministic 404 round trip + throttle token
                self._batch_bind = False
        bound = []
        for name, node in pairs:
            try:
                self.patch(
                    "Pod", namespace, name, {"spec": {"node_name": node}}
                )
            except NotFoundError:
                continue
            bound.append(name)
        return bound

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._request(
            "DELETE", self._object_path(kind, namespace, name), kind=kind
        )

    def delete_collection(self, kind: str, namespace: Optional[str] = None) -> int:
        return self._request(
            "DELETE", self._collection_path(kind, namespace), kind=kind
        ).get("deleted", 0)

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, *, replay: bool = True) -> "queue.Queue[WatchEvent]":
        """Open a streaming watch; events arrive on the returned queue
        (same contract as APIServer.watch).

        Reflector semantics (client-go's relist, reference informers
        factory.go:117-133 -> NewSharedIndexInformer): if the stream drops
        for any reason other than stop_watch — gateway restart, LB blip,
        half-open timeout — the reader reconnects with backoff and
        ``replay=1``. The gateway replays current state terminated by a
        BOOKMARK line; the reader forwards the replay (level-based
        consumers overwrite) and, at the BOOKMARK, synthesizes DELETED
        events for every object it had delivered that no longer exists —
        so informers converge instead of freezing on a stale cache."""
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        stop = threading.Event()
        entry = {"conn": None, "resp": None, "stop": stop}
        # last-delivered object per key: the source for synthesized DELETEDs
        known: Dict[tuple, dict] = {}

        def connect(replay_flag: bool):
            # Read timeout >> the gateway's 0.2s heartbeat: a half-open
            # connection (no FIN/RST — host power loss, NAT drop) surfaces
            # as socket.timeout instead of blocking readline forever
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=max(self.timeout, 5.0)
            )
            path = (
                self._collection_path(kind, None)
                + f"?watch=1&replay={'1' if replay_flag else '0'}"
            )
            conn.request("GET", path)
            resp = conn.getresponse()
            with self._lock:
                entry["conn"], entry["resp"] = conn, resp
            if stop.is_set():  # lost the race with stop_watch
                raise OSError("watch stopped")
            return resp

        def key_of(obj: dict) -> tuple:
            meta = obj.get("metadata") or {}
            return (meta.get("namespace", "default"), meta.get("name", ""))

        def consume(resp, resyncing: bool) -> None:
            """Forward events until the stream ends. ``resyncing``: treat
            the leading replay (up to the BOOKMARK) as a relist to diff
            against ``known`` — and, when the subscription was opened with
            ``replay=False``, use it for that bookkeeping WITHOUT
            forwarding (the caller opted out of replays)."""
            replay_seen: set = set()
            while not stop.is_set():
                line = resp.fp.readline()
                if not line or stop.is_set():
                    return
                line = line.strip()
                if not line:
                    continue  # heartbeat
                ev = json.loads(line)
                etype = ev.get("type")
                if etype == "BOOKMARK":
                    if resyncing:
                        for gone_key in set(known) - replay_seen:
                            q.put(
                                WatchEvent(
                                    WatchEvent.DELETED,
                                    kind,
                                    known.pop(gone_key),
                                )
                            )
                        resyncing = False
                    continue
                obj = ev["object"]
                k = key_of(obj)
                in_replay = resyncing
                if etype == WatchEvent.DELETED:
                    known.pop(k, None)
                else:
                    known[k] = obj
                    if resyncing:
                        replay_seen.add(k)
                if in_replay and not replay:
                    continue  # resync bookkeeping only; caller opted out
                q.put(WatchEvent(etype, kind, obj))

        def reader() -> None:
            backoff = 0.2
            first = True
            while not stop.is_set():
                established = False
                try:
                    # reconnects always replay: the relist is what resyncs
                    resp = connect(replay if first else True)
                    established = True
                    consume(resp, resyncing=not first)
                except (OSError, ValueError, http.client.HTTPException):
                    pass  # fall through to reconnect (or exit if stopped)
                if first:
                    first = False
                if stop.is_set():
                    return
                stop.wait(backoff)
                # a stream that actually established resets the backoff
                # (client-go behavior); repeated connect failures keep
                # growing it toward the cap
                backoff = 0.2 if established else min(backoff * 2, 5.0)

        t = threading.Thread(
            target=reader, name=f"http-watch-{kind}", daemon=True
        )
        t.start()
        entry["thread"] = t
        with self._lock:
            self._watches[id(q)] = entry
        return q

    @staticmethod
    def _close_entry(entry: dict) -> None:
        entry["stop"].set()
        # resp holds its own buffered socket file — closing the connection
        # alone leaves the reader consuming buffered events
        for field in ("resp", "conn"):
            c = entry.get(field)
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass

    def stop_watch(self, kind: str, q: queue.Queue) -> None:
        with self._lock:
            entry = self._watches.pop(id(q), None)
        if entry is None:
            return
        self._close_entry(entry)

    def close(self) -> None:
        with self._lock:
            entries = list(self._watches.values())
            self._watches.clear()
        for entry in entries:
            self._close_entry(entry)
        # persistent request connections are per-thread; only the calling
        # thread's can be closed here (the others close when their threads
        # exit), but that covers the common single-threaded-client case
        self._drop_conn()
