"""ChaosProxy: an in-process fault-injecting TCP proxy for the oracle wire.

The port of ``batch_scheduler_tpu/sim/chaos.py`` over this package's
``service/protocol.py`` frames (the same bytes). It sits between an oracle
client and a running ``OracleServer`` and injects the transport failures a
production sidecar link shows, on a probability schedule (or exactly
``limit`` times):

- ``reset``     : hard connection reset mid-exchange (SO_LINGER 0 => RST,
                  the kill -9 / LB-drain failure mode)
- ``hang``      : black-hole: the response frame is swallowed and the
                  connection goes silent (hung sidecar / dropped route);
                  bounded by ``hang_s`` so a run always terminates
- ``delay``     : the response frame arrives ``delay_s`` late (congested
                  or tunneled link)
- ``truncate``  : the frame header promises more payload than is sent
                  before the connection closes (peer died mid-write)
- ``garbage``   : bytes that are not a protocol frame at all (desynced or
                  hostile peer)

Faults are injected at FRAME granularity on the server->client direction
(the request made it out; the response suffers, which exercises the
client's read and recovery path). The client->server direction relays raw
bytes untouched by default; with ``c2s_frames=True`` it relays frames too
and supports two request-direction faults aimed at the wire-delta stream:

- ``drop_c2s`` : one request frame silently vanishes (lossy middlebox);
                 the connection stays up, the client's read times out
- ``dup_c2s``  : one request frame is delivered twice (retransmit bug);
                 the server sees the same delta again and must refuse it
                 on the generation check, never apply it twice

Beyond per-frame faults, the proxy has ENDPOINT-level primitives for
failover drills: ``kill_endpoint()`` RSTs every live connection and refuses
new ones (instance loss), ``partition_endpoint()`` black-holes both
directions while connections stay up (network partition),
``hang_endpoint()`` delivers requests but swallows every response
(accepting-but-dead), and ``restore_endpoint()`` brings the endpoint back.
The proxy touches no device: what it tests is the client's recovery and the
sidecar's answers behind it.
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Dict, Optional, Union

from ..service import protocol as proto

__all__ = ["ChaosProxy", "FAULT_KINDS", "C2S_FAULT_KINDS"]

# response-direction faults (the original classes; tests parametrize over
# exactly these — each implies a client-visible failure mode)
FAULT_KINDS = ("reset", "hang", "delay", "truncate", "garbage")
# request-direction faults (frame-granular c2s relay only); a draw on one
# pump only considers its own kinds, so arming a c2s fault never perturbs
# responses and vice versa
C2S_FAULT_KINDS = ("drop_c2s", "dup_c2s")
_ALL_KINDS = FAULT_KINDS + C2S_FAULT_KINDS


def _wake_and_close(s: socket.socket) -> None:
    """Close ``s`` so that a thread blocked in ``recv`` on it returns: a
    close from another thread does not wake it (Linux), a shutdown of the
    read side does. Only the read side, which sends nothing: the peer sees
    the close (a FIN, or an RST under SO_LINGER 0) as before."""
    try:
        s.shutdown(socket.SHUT_RD)
    except OSError:
        pass
    try:
        s.close()
    except OSError:
        pass


class ChaosProxy:
    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        host: str = "127.0.0.1",
        seed: int = 0,
        c2s_frames: bool = False,
    ):
        self._upstream = (upstream_host, upstream_port)
        # frame-granular client->server relay (needed for the drop_c2s /
        # dup_c2s faults); off by default — raw relay is cheaper and the
        # original five faults only touch the response direction
        self._c2s_frames = c2s_frames
        self._listener = socket.create_server((host, 0))
        self._listener.settimeout(0.2)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._rng = random.Random(seed)  # guarded-by: _lock
        # kind -> probability per response frame; drawn in FAULT_KINDS order
        self._faults: Dict[str, float] = {}  # guarded-by: _lock
        self._limit: Optional[int] = None  # guarded-by: _lock
        self.delay_s = 0.05
        self.hang_s = 30.0
        self.injected: Dict[str, int] = {k: 0 for k in _ALL_KINDS}  # guarded-by: _lock
        self._socks: list = [self._listener]  # guarded-by: _lock
        # endpoint-wide failure mode: None | "killed" | "partitioned" |
        # "hung" (the HA crash-drill primitives); guarded-by: _lock
        self._endpoint_mode: Optional[str] = None
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaos-accept", daemon=True
        )
        # every thread the proxy starts: stop() joins them all, so none is
        # left blocked in a socket call when the interpreter exits
        self._threads: list = [self._accept_thread]  # guarded-by: _lock
        self._accept_thread.start()

    @property
    def address(self):
        return self._listener.getsockname()[:2]

    # -- fault schedule ----------------------------------------------------

    def set_fault(
        self,
        kind: Union[str, Dict[str, float], None],
        probability: float = 1.0,
        limit: Optional[int] = None,
        delay_s: Optional[float] = None,
        hang_s: Optional[float] = None,
    ) -> None:
        """Arm the schedule: one ``kind`` with ``probability``, or a
        ``{kind: probability}`` mix. ``limit`` bounds TOTAL injections
        before auto-disarm (deterministic single-fault tests use
        ``probability=1.0, limit=1``); None = unlimited. ``None`` kind
        disarms."""
        with self._lock:
            if kind is None:
                self._faults = {}
            elif isinstance(kind, str):
                if kind not in _ALL_KINDS:
                    raise ValueError(f"unknown fault {kind!r} (use {_ALL_KINDS})")
                self._faults = {kind: probability}
            else:
                bad = set(kind) - set(_ALL_KINDS)
                if bad:
                    raise ValueError(f"unknown faults {bad} (use {_ALL_KINDS})")
                self._faults = dict(kind)
            self._limit = limit
            if delay_s is not None:
                self.delay_s = delay_s
            if hang_s is not None:
                self.hang_s = hang_s

    def clear_fault(self) -> None:
        self.set_fault(None)

    # -- endpoint-level primitives (HA crash drills) -------------------------

    def kill_endpoint(self) -> None:
        """Crash the whole endpoint: every live connection dies with an RST
        and new connections are refused the same way — the kill -9 /
        instance-loss failure mode the failover gate drills. The listener
        stays bound (the address doesn't vanish, the process behind it
        did); ``restore_endpoint()`` brings it back, clients must redial."""
        with self._lock:
            self._endpoint_mode = "killed"
            conns = [s for s in self._socks if s is not self._listener]
            self._socks = [self._listener]
        for s in conns:
            self._rst_close(s)

    def partition_endpoint(self) -> None:
        """Network partition: connections stay up but no bytes cross in
        either direction; new connections are accepted, then black-holed.
        Clients see read timeouts, never a clean close."""
        with self._lock:
            self._endpoint_mode = "partitioned"

    def hang_endpoint(self) -> None:
        """Hung endpoint: requests still reach the server but every
        response is swallowed — the accepting-but-dead mode the client's
        bounded half-open probe exists for."""
        with self._lock:
            self._endpoint_mode = "hung"

    def restore_endpoint(self) -> None:
        """Clear the endpoint failure mode (connections killed or
        black-holed meanwhile stay dead — clients redial)."""
        with self._lock:
            self._endpoint_mode = None

    def endpoint_mode(self) -> Optional[str]:
        with self._lock:
            return self._endpoint_mode

    @staticmethod
    def _rst_close(s: socket.socket) -> None:
        try:
            s.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
        except OSError:
            pass
        _wake_and_close(s)

    def injected_counts(self) -> Dict[str, int]:
        """Snapshot of per-kind injection counters: the relay threads
        increment ``.injected`` under the lock, so read it through here."""
        with self._lock:
            return dict(self.injected)

    def _draw(self, kinds=FAULT_KINDS) -> Optional[str]:
        with self._lock:
            if not self._faults or self._limit == 0:
                return None
            for kind in kinds:
                p = self._faults.get(kind, 0.0)
                if p > 0 and self._rng.random() < p:
                    self.injected[kind] += 1
                    if self._limit is not None:
                        self._limit -= 1
                    return kind
            return None

    # -- plumbing ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                mode = self._endpoint_mode
            if mode == "killed":
                self._rst_close(client)  # dead process: dial answered by RST
                continue
            if mode == "partitioned":
                with self._lock:
                    self._socks.append(client)
                continue  # accepted, never relayed: the black-hole
            try:
                upstream = socket.create_connection(self._upstream, timeout=5.0)
            except OSError:
                client.close()
                continue
            pumps = (
                threading.Thread(
                    target=(
                        self._pump_frames_c2s if self._c2s_frames
                        else self._pump_raw
                    ),
                    args=(client, upstream),
                    name="chaos-c2s", daemon=True,
                ),
                threading.Thread(
                    target=self._pump_frames, args=(upstream, client),
                    name="chaos-s2c", daemon=True,
                ),
            )
            with self._lock:
                self._socks += [client, upstream]
                self._threads = [t for t in self._threads if t.is_alive()]
                self._threads += pumps
            for t in pumps:
                t.start()

    @staticmethod
    def _close_pair(a: socket.socket, b: socket.socket) -> None:
        for s in (a, b):
            _wake_and_close(s)

    def _read_exact(self, sock: socket.socket, n: int) -> Optional[bytes]:
        chunks = []
        while n:
            try:
                chunk = sock.recv(min(n, 1 << 20))
            except OSError:
                return None
            if not chunk:
                return None
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _pump_raw(self, src: socket.socket, dst: socket.socket) -> None:
        """client -> server: relay untouched."""
        try:
            while not self._stop.is_set():
                try:
                    data = src.recv(1 << 16)
                except OSError:
                    break
                if not data:
                    break
                mode = self.endpoint_mode()
                if mode == "killed":
                    break
                if mode == "partitioned":
                    continue  # swallow: the partition eats the bytes
                dst.sendall(data)
        except OSError:
            pass
        finally:
            self._close_pair(src, dst)

    def _pump_frames_c2s(self, src: socket.socket, dst: socket.socket) -> None:
        """client -> server: relay at frame granularity, injecting the
        request-direction faults (drop/duplicate one frame, connection
        kept alive): the wire-delta stream's chaos."""
        try:
            while not self._stop.is_set():
                header = self._read_exact(src, proto._HEADER.size)
                if header is None:
                    break
                _, _, length = proto._HEADER.unpack(header)
                payload = b""
                if length:
                    payload = self._read_exact(src, length)
                    if payload is None:
                        break
                mode = self.endpoint_mode()
                if mode == "killed":
                    break
                if mode == "partitioned":
                    continue  # swallow: the partition eats the frame
                fault = self._draw(C2S_FAULT_KINDS)
                if fault == "drop_c2s":
                    continue  # the frame never arrives; the stream lives
                dst.sendall(header + payload)
                if fault == "dup_c2s":
                    dst.sendall(header + payload)
        except OSError:
            pass
        finally:
            self._close_pair(src, dst)

    def _pump_frames(self, src: socket.socket, dst: socket.socket) -> None:
        """server -> client: relay at frame granularity, injecting faults."""
        try:
            while not self._stop.is_set():
                header = self._read_exact(src, proto._HEADER.size)
                if header is None:
                    break
                _, _, length = proto._HEADER.unpack(header)
                payload = b""
                if length:
                    payload = self._read_exact(src, length)
                    if payload is None:
                        break
                mode = self.endpoint_mode()
                if mode == "killed":
                    break
                if mode in ("partitioned", "hung"):
                    continue  # response swallowed; keep draining upstream
                fault = self._draw()
                if fault is None:
                    dst.sendall(header + payload)
                elif fault == "delay":
                    self._stop.wait(self.delay_s)
                    dst.sendall(header + payload)
                elif fault == "reset":
                    # SO_LINGER 0: close sends RST, the client sees
                    # ECONNRESET instead of a clean EOF
                    dst.setsockopt(
                        socket.SOL_SOCKET,
                        socket.SO_LINGER,
                        struct.pack("ii", 1, 0),
                    )
                    break
                elif fault == "hang":
                    # black-hole: swallow the frame, go silent, then drop
                    self._stop.wait(self.hang_s)
                    break
                elif fault == "truncate":
                    dst.sendall(header + payload[: len(payload) // 2])
                    break
                elif fault == "garbage":
                    # draw under the lock: Random's state is shared with
                    # _draw across every relay thread
                    with self._lock:
                        junk = bytes(
                            self._rng.randrange(256) for _ in range(28)
                        )
                    dst.sendall(b"JUNK" + junk)
                    break
        except OSError:
            pass
        finally:
            self._close_pair(src, dst)

    def stop(self, timeout: float = 10.0) -> None:
        """Close every socket (``_wake_and_close``) and join every thread
        the proxy started: a relay thread left blocked would outlive the
        proxy as a daemon thread, and one that wakes while the interpreter
        finalizes aborts the process ("terminate called without an active
        exception")."""
        self._stop.set()
        me = threading.current_thread()
        # rounds until nothing is left: a connection the accept loop was
        # relaying when the stop began registers its sockets and threads
        # after the first round took the lists
        while True:
            with self._lock:
                socks, self._socks = self._socks, []
                threads, self._threads = self._threads, []
            if not socks and not threads:
                return
            for s in socks:
                _wake_and_close(s)
            for t in threads:
                if t is not me:
                    t.join(timeout)
