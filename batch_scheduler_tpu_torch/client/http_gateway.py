"""HTTP gateway: serve an APIServer over Kubernetes-shaped REST.

The port of ``batch_scheduler_tpu/client/http_gateway.py``: the same
routes, watch lines, error bodies and bind-epoch fence, so the JAX
package's ``HTTPAPIServer`` can talk to this gateway and this package's
``client.http_apiserver.HTTPAPIServer`` to the JAX package's gateway. Any
object with ``client.apiserver.APIServer``'s interface can be served on a
socket with k8s-style resource paths and the k8s watch protocol (streamed
``{"type": ..., "object": ...}`` JSON lines); KWOK-style simulated clusters
serve the same paths. Nothing here touches a device.

Routes:
  /api/v1/namespaces/{ns}/pods[/{name}]
  /api/v1/namespaces/{ns}/pods:bindmany  (POST: batched bind custom verb)
  /api/v1/nodes[/{name}]
  /apis/batch.scheduler.tpu/v1/namespaces/{ns}/podgroups[/{name}]
  /apis/apiextensions.k8s.io/v1/customresourcedefinitions
  collection GET with ?watch=1[&replay=1] streams watch events
  collection GET with ?labelSelector=k%3Dv,... filters server-side
"""

from __future__ import annotations

import json
import queue
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from .apiserver import AlreadyExistsError, APIServer, ConflictError, NotFoundError

__all__ = ["KIND_ROUTES", "CRD_PATH", "serve_gateway", "GatewayServer"]

# kind -> (api prefix, plural, namespaced)
KIND_ROUTES = {
    "Pod": ("/api/v1", "pods", True),
    "Node": ("/api/v1", "nodes", False),
    "PodGroup": ("/apis/batch.scheduler.tpu/v1", "podgroups", True),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
}
_PLURALS = {v[1]: k for k, v in KIND_ROUTES.items()}
CRD_PATH = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"


def _parse_resource(path: str) -> Optional[Tuple[str, Optional[str], Optional[str]]]:
    """path -> (kind, namespace or None, name or None), or None."""
    parts = [p for p in path.split("/") if p]
    # {prefix...}/namespaces/{ns}/{plural}[/{name}]
    if "namespaces" in parts:
        i = parts.index("namespaces")
        if len(parts) < i + 3:
            return None
        ns, plural = parts[i + 1], parts[i + 2]
        kind = _PLURALS.get(plural)
        if kind is None:
            return None
        name = parts[i + 3] if len(parts) > i + 3 else None
        return kind, ns, name
    # cluster-scoped or all-namespaces: {prefix...}/{plural}[/{name}]
    for j, part in enumerate(parts):
        kind = _PLURALS.get(part)
        if kind is not None:
            name = parts[j + 1] if len(parts) > j + 1 else None
            return kind, None, name
    return None


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: persistent connections for the request/response verbs
    # (client-go parity — one TCP handshake per client, not per request;
    # per-request connections flooded the kernel with TIME_WAIT sockets
    # at e2e scale). Responses carry Content-Length, so keep-alive works;
    # the watch stream opts out with Connection: close below.
    protocol_version = "HTTP/1.1"
    # persistent connections make the Nagle/delayed-ACK interaction
    # visible (~40ms per small request/response exchange): disable Nagle
    # like every production HTTP server does
    disable_nagle_algorithm = True
    api: APIServer = None  # set by serve_gateway subclass

    def log_message(self, *args) -> None:  # quiet
        pass

    def parse_request(self) -> bool:
        # per-request state on a persistent connection: the handler
        # instance is reused across keep-alive requests
        self._body_read = False
        return super().parse_request()

    # -- helpers -----------------------------------------------------------

    def _send_json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(
        self, code: int, message: str, reason: str = ""
    ) -> None:
        # keep-alive hygiene: an error response sent before the request
        # body was read leaves the body bytes in the stream, and the next
        # request on this persistent connection would parse them as its
        # request line — drain them first
        if not getattr(self, "_body_read", False):
            length = int(self.headers.get("Content-Length") or 0)
            if length > 0:
                self.rfile.read(length)
                self._body_read = True
        self._send_json(
            code,
            {"kind": "Status", "code": code, "message": message, "reason": reason},
        )

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        self._body_read = True
        data = self.rfile.read(length) if length else b""
        if len(data) < length:
            # the client's connection died mid-body (a restart severs it):
            # apply nothing. Read as an empty object, such a POST created
            # a nameless pod ``{}`` (a pod the scheduler then bound)
            raise ConnectionError(f"request body cut short: {len(data)} of {length} bytes")
        return json.loads(data or b"{}")

    def _selector(self, qs) -> Optional[dict]:
        raw = qs.get("labelSelector", [None])[0]
        if not raw:
            return None
        out = {}
        for term in unquote(raw).split(","):
            if "=" in term:
                k, v = term.split("=", 1)
                out[k] = v
        return out or None

    # -- verbs -------------------------------------------------------------

    def do_GET(self) -> None:
        url = urlparse(self.path)
        parsed = _parse_resource(url.path)
        if parsed is None:
            if url.path == CRD_PATH:
                self._send_json(200, {"items": self.api.crds()})
                return
            self._send_error_json(404, f"unknown path {url.path}")
            return
        kind, ns, name = parsed
        qs = parse_qs(url.query)
        try:
            if name is not None:
                self._send_json(200, self.api.get(kind, ns or "", name))
            elif qs.get("watch", ["0"])[0] in ("1", "true"):
                self._stream_watch(kind, ns, qs)
            else:
                items = self.api.list(kind, ns, self._selector(qs))
                self._send_json(200, {"items": items})
        except NotFoundError as e:
            self._send_error_json(404, str(e))

    def _stream_watch(self, kind: str, ns: Optional[str], qs) -> None:
        """k8s-dialect watch stream, scoped to the URL's namespace and
        labelSelector (a watch on /namespaces/ns/pods streams only ns).
        Replay is served from a LIST taken after subscribing
        (no missed-event window) and terminated by a BOOKMARK line, the
        reflector's resync point: a reconnecting client diffs the replayed
        state at the BOOKMARK against what it knew and synthesizes DELETED
        events for objects that vanished while it was away (client-go's
        relist, informers factory.go:117-133)."""
        replay = qs.get("replay", ["1"])[0] in ("1", "true")
        selector = self._selector(qs)

        def in_scope(obj: dict) -> bool:
            meta = obj.get("metadata") or {}
            if ns is not None and meta.get("namespace", "default") != ns:
                return False
            if selector:
                labels = meta.get("labels") or {}
                return all(labels.get(k) == v for k, v in selector.items())
            return True

        def key_of(obj: dict) -> tuple:
            meta = obj.get("metadata") or {}
            return (meta.get("namespace", "default"), meta.get("name", ""))

        # subscribe FIRST, then list: anything created between the two
        # shows up twice (replay + live ADDED) — level-based consumers
        # overwrite; nothing is missed
        events = self.api.watch(kind, replay=False)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "identity")
        # a watch stream has no length and ends only when a side closes:
        # it cannot ride a keep-alive connection
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        sent: set = set()  # keys this stream has delivered as in-scope
        try:
            if replay:
                for obj in self.api.list(kind, ns, selector):
                    sent.add(key_of(obj))
                    line = json.dumps({"type": "ADDED", "object": obj}) + "\n"
                    self.wfile.write(line.encode())
                self.wfile.write(b'{"type": "BOOKMARK"}\n')
                self.wfile.flush()
            while True:
                try:
                    item = events.get(timeout=0.2)
                except queue.Empty:
                    # heartbeat keeps half-open disconnects detectable
                    self.wfile.write(b"\n")
                    self.wfile.flush()
                    continue
                # the API server's bulk verbs fan out one LIST per chunk
                out = []
                for ev in item if isinstance(item, list) else (item,):
                    key = key_of(ev.obj)
                    etype = ev.type
                    if in_scope(ev.obj):
                        if etype == "DELETED":
                            sent.discard(key)
                        else:
                            # scope ENTRY (e.g. relabeled into the
                            # selector) must read as ADDED to a scoped
                            # watcher
                            if key not in sent:
                                etype = "ADDED"
                            sent.add(key)
                    elif key in sent:
                        # scope EXIT: to this watcher the object is gone —
                        # k8s scoped watches emit DELETED here, not
                        # silence
                        sent.discard(key)
                        etype = "DELETED"
                    else:
                        continue  # never in scope for this stream
                    out.append(
                        json.dumps({"type": etype, "object": ev.obj}) + "\n"
                    )
                if out:
                    # one write + flush per batch: fewer syscalls under
                    # the bind storm
                    self.wfile.write("".join(out).encode())
                    self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self.api.stop_watch(kind, events)

    def do_POST(self) -> None:
        url = urlparse(self.path)
        if url.path.endswith("/pods:bindmany"):
            # batched bind subresource: one request binds a whole released
            # gang (the k8s custom-verb path shape). Body
            # {"binds": [[name, node], ...]} -> {"bound": [names]}; missing
            # pods are skipped, matching APIServer.bind_pods. Without this
            # route the cross-gang commit flush's one-API-pass amortization
            # evaporates over the wire into per-pod PATCHes.
            parsed = _parse_resource(url.path[: -len(":bindmany")])
            if parsed is None or parsed[0] != "Pod":
                self._send_error_json(404, f"unknown path {url.path}")
                return
            ns = parsed[1] or "default"
            body = self._read_body()
            pairs = [(b[0], b[1]) for b in body.get("binds", [])]
            bind_pods = getattr(self.api, "bind_pods", None)
            if bind_pods is None:
                self._send_error_json(404, "bind batch unsupported")
                return
            # fencing: stamp the bind with this gateway generation's
            # epoch so a handler thread outliving a "restart" (severed
            # socket, thread already past the read) cannot apply a stale
            # bind against the shared backing store after a newer
            # gateway took over (the zombie-bind over-commit)
            epoch = getattr(self, "bind_epoch", None)
            if epoch is not None:
                self._send_json(
                    200, {"bound": bind_pods(ns, pairs, epoch=epoch)}
                )
            else:
                self._send_json(200, {"bound": bind_pods(ns, pairs)})
            return
        if url.path == CRD_PATH:
            body = self._read_body()
            created = self.api.ensure_crd(
                body.get("metadata", {}).get("name", ""), body.get("spec")
            )
            self._send_json(201 if created else 409, body)
            return
        parsed = _parse_resource(url.path)
        if parsed is None:
            self._send_error_json(404, f"unknown path {url.path}")
            return
        kind, ns, _ = parsed
        obj = self._read_body()
        if ns is not None:
            obj.setdefault("metadata", {}).setdefault("namespace", ns)
        try:
            self._send_json(201, self.api.create(kind, obj))
        except AlreadyExistsError as e:
            self._send_error_json(409, str(e), reason="AlreadyExists")

    def do_PUT(self) -> None:
        parsed = _parse_resource(urlparse(self.path).path)
        if parsed is None:
            self._send_error_json(404, "unknown path")
            return
        kind, _, _ = parsed
        try:
            self._send_json(200, self.api.update(kind, self._read_body()))
        except ConflictError as e:
            self._send_error_json(409, str(e), reason="Conflict")
        except NotFoundError as e:
            self._send_error_json(404, str(e))

    def do_PATCH(self) -> None:
        parsed = _parse_resource(urlparse(self.path).path)
        if parsed is None or parsed[2] is None:
            self._send_error_json(404, "unknown path")
            return
        kind, ns, name = parsed
        try:
            self._send_json(
                200, self.api.patch(kind, ns or "", name, self._read_body())
            )
        except NotFoundError as e:
            self._send_error_json(404, str(e))

    def do_DELETE(self) -> None:
        parsed = _parse_resource(urlparse(self.path).path)
        if parsed is None:
            self._send_error_json(404, "unknown path")
            return
        kind, ns, name = parsed
        try:
            if name is not None:
                self.api.delete(kind, ns or "", name)
                self._send_json(200, {"kind": "Status", "status": "Success"})
            else:
                n = self.api.delete_collection(kind, ns)
                self._send_json(200, {"kind": "Status", "deleted": n})
        except NotFoundError as e:
            self._send_error_json(404, str(e))


class GatewayServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    # With HTTP/1.1 keep-alive, shutdown()+server_close() only stop the
    # ACCEPT loop — daemon handler threads would keep serving persistent
    # connections straight through a "restart", silently defeating outage
    # tests (and leaking zombie handlers). Track live connections and
    # sever them at close, like a real server death would.
    def __init__(self, *args, **kwargs):
        # before super().__init__: a failed bind (busy port on a restart
        # attempt) makes the base class call self.server_close(), which
        # needs these — assigning after would turn the OSError into an
        # AttributeError
        self._live_conns: set = set()  # guarded-by: _conn_lock
        self._conn_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._live_conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._live_conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conn_lock:
            conns = list(self._live_conns)
            self._live_conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


def serve_gateway(
    api: APIServer, host: str = "127.0.0.1", port: int = 0
) -> GatewayServer:
    """Serve ``api`` on (host, port) in a background thread; returns the
    server (``server.server_address`` has the bound port; ``shutdown()`` +
    ``server_close()`` stops it).

    Each gateway generation advances the backing store's bind epoch at
    startup and stamps its binds with it: handler threads from a PREVIOUS
    generation (zombies a severed socket could not kill) are fenced out
    of the shared store, so a liveness read served by this generation is
    conclusive about lost binds (APIServer.bind_pods)."""
    handler = type(
        "BoundHandler", (_Handler,), {"api": api, "bind_epoch": None}
    )
    # bind the listening socket FIRST, then advance the fence: if the
    # port is still held (failed restart) the constructor raises before
    # the epoch moves, so the surviving previous generation keeps
    # binding — advancing first would silently fence a gateway that
    # never got replaced. Handlers only run once serve_forever starts,
    # after the epoch is stamped below.
    server = GatewayServer((host, port), handler)
    advance = getattr(api, "advance_bind_epoch", None)
    handler.bind_epoch = advance() if advance is not None else None
    threading.Thread(
        target=server.serve_forever, name="apiserver-gateway", daemon=True
    ).start()
    return server
