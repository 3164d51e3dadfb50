"""The oracle sidecar service: a TCP server that runs the port's batch on
its device and answers over the reference's wire protocol.

This is the deployment shape of the north star: the (Go) control plane keeps
its informers and gang choreography, and ships packed resource arrays to
this sidecar, which owns the card and answers with O(G) verdicts + compact
assignments. Stateless across batches (all durable state stays in the CRD
status) — per-connection, the last batch's [G,N] tensors are kept on the
device so row fetches don't resend the batch.

The port of ``batch_scheduler_tpu/service/server.py`` on one explicit
``device`` (``cuda`` unless the caller passes ``cpu``; without CUDA the
default raises). Every message the reference's single-device server
answers is answered here with the same bytes, the multi-tenant coalescer
(``service.coalescer``, ``coalesce=`` / ``BST_COALESCE``) and its BUSY
answer included, and a traced request's ``TRACE_INFO`` carries the
sidecar's capacity sample (``ops.capacity``). The spans a ``TRACE_INFO``
reply carries are built from the request's phase timings under the
client's trace id (no span is opened on the executor thread), and with
tracing on (utils.trace) they also land in this process's span ring.
``compile_warmer=True`` runs the bucket warmer (``ops.bucketing``) on the
shapes the sidecar serves, and ``warmth_snapshot`` / ``replicate_warmth``
hand its shapes to a standby. Left out: the profiler's memory telemetry
(the port builds its kernels once and compiles nothing per shape).

On a mesh (``scan_mesh=``, a ``parallel.ShardMesh`` on its rank 0, while
the other ranks run ``parallel.follow``) every batch runs over the mesh
(``ops.oracle.dispatch_batch``'s ``scan_mesh``): a full request's batch is
broadcast whole, and each connection's mirror is a mesh holder whose
keyframes and row scatters reach the followers, so a delta request moves
its churned rows and its O(G) tail. The executor thread issues all of it,
so a holder's broadcast never interleaves with a batch's collectives. The
coalescer and the bucket warmer are off there (a merged batch would
reshard; a warm batch would stall live ones), and ``drain`` /
``server_close`` stop the followers.

Deadline enforcement: a DEADLINE annotation frame bounds the next request;
request bodies run on a per-connection daemon worker so the handler can
answer a DEADLINE_ERROR frame the moment the budget elapses.

Device work is issued by a single-owner executor thread
(``DeviceExecutor``): connections unpack/pad concurrently (numpy only) and
enqueue packed batches; the executor overlaps the next batch's dispatch
with the current batch's device compute (in-flight window 2). With the
coalescer on, the batches of every connection first join its DRF merge
queue, whose one worker feeds the executor.
"""

from __future__ import annotations

import os
import queue
import socket
import socketserver
import sys
import threading
import time
import weakref
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..ops.bucketing import pad_oracle_batch
from ..ops.capacity import CapacitySampler, capacity_enabled
from ..ops.convert import device_stream, resolve_device
from ..ops.device_state import DeviceStateHolder
from ..ops.lanes import LANE_MAX
from ..ops.oracle import collect_batch, dispatch_batch, inflight_batches
from ..utils import audit as audit_mod
from ..utils import tenancy
from ..utils import trace as trace_mod
from ..utils.metrics import DEFAULT_REGISTRY, LONG_OP_BUCKETS
from . import protocol as proto
from .coalescer import (
    CoalesceJob,
    CoalesceSaturated,
    OracleCoalescer,
    coalesce_enabled,
)

__all__ = [
    "DeviceExecutor",
    "OracleServer",
    "serve_background",
    "active_servers",
]

# graceful drain: the work-bearing message types the drain gate refuses.
# Annotations and PING keep flowing — a draining sidecar is alive and says
# so; only execution is refused.
_DRAIN_GATED = (
    proto.MsgType.SCHEDULE_REQ,
    proto.MsgType.DELTA_SCHEDULE_REQ,
    proto.MsgType.ROW_REQ,
)
# retry-after hint carried in every DRAINING answer: long enough that a
# single-address client's hint-sleeps don't hammer the dying process,
# short enough that it observes the exit within its retry budget
_DRAIN_RETRY_AFTER_MS = 200

# batches the executor keeps in flight: one computing, one being fed
_WINDOW = 2

# live servers in this process
_LIVE_SERVERS: "weakref.WeakSet" = weakref.WeakSet()


def active_servers() -> list:
    """Every live OracleServer in this process (weakly held)."""
    return list(_LIVE_SERVERS)


def _drain_timeout_s() -> float:
    """BST_DRAIN_TIMEOUT_S: bound on how long ``drain()`` waits for the
    in-flight request window to empty before flushing and reporting
    (seconds, default 30; parse-guarded like every knob)."""
    raw = os.environ.get("BST_DRAIN_TIMEOUT_S")
    if raw is None:
        return 30.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 30.0


# ---------------------------------------------------------------------------
# sidecar-side capacity observatory (ops.capacity)
# ---------------------------------------------------------------------------
#
# One process-wide sampler shared by every connection: a TRACED schedule
# batch gets a budget-gated capacity sample whose compact form rides back
# to the client inside the TRACE_INFO telemetry dict, so a traced client
# sees the SIDECAR's utilization/fragmentation beside its own. The sidecar
# sees packed arrays, never names; a connection that announced its tenant
# (the TENANT wire annotation) attributes its batches' capacity shares to
# that label — the shares also feed the coalescer's DRF admission weights
# (_capacity_tenant_shares). Gated to traced requests, as in the
# reference: an untraced serving path never pays the analytics.

_server_capacity_lock = threading.Lock()
_server_capacity = None  # guarded-by: _server_capacity_lock


def _capacity_tenant_shares() -> dict:
    """{tenant: dominant share} from the sidecar sampler's last summary —
    the capacity observatory's live feed into the coalescer's DRF
    admission order (empty before the first sample / with capacity off)."""
    with _server_capacity_lock:
        sampler = _server_capacity
    if sampler is None:
        return {}
    last = sampler.last()
    if not last:
        return {}
    return {
        t["tenant"]: float(t["dominant_share"])
        for t in last.get("tenants", [])
    }


def _plan_rows(host: dict, g_bucket: int) -> dict:
    """The plan fields the capacity analytics read, at the padded batch's
    gang count: a mega group's demuxed host dict holds only the tenant's
    own ``g`` gangs, and the rows past them are unplaced pads (no seats).
    The reference hands the cut dict to its kernel, whose shapes then
    disagree and the sample errors."""
    placed = np.asarray(host["placed"])
    g = placed.shape[0]
    if g >= g_bucket:
        return host
    nodes = np.asarray(host["assignment_nodes"])
    counts = np.asarray(host["assignment_counts"])
    pad = g_bucket - g
    return {
        "placed": np.concatenate([placed, np.zeros(pad, placed.dtype)]),
        "assignment_nodes": np.concatenate(
            [nodes, np.zeros((pad, nodes.shape[1]), nodes.dtype)]),
        "assignment_counts": np.concatenate(
            [counts, np.zeros((pad, counts.shape[1]), counts.dtype)]),
    }


def _maybe_server_capacity(executor, batch_args, progress_args, host,
                           tenant=None, g=None) -> None:
    """One budget-gated sidecar capacity sample of a traced batch, run on
    the executor thread (the only thread that touches the device: the
    args may be a connection's resident mirror), its compact form added
    to ``host``'s telemetry for the TRACE_INFO frame. Telemetry only:
    nothing here fails the request."""
    global _server_capacity

    if not capacity_enabled():
        return
    with _server_capacity_lock:
        if _server_capacity is None:
            _server_capacity = CapacitySampler(label="server")
        sampler = _server_capacity
    try:
        kwargs = {}
        if tenant and g:
            # synthetic namespace-prefixed names: the per-batch tenant
            # mapping (utils.tenancy.batch_tenants) derives from gang
            # names the wire never carries — the announced label stands
            # in for all of them, so the whole batch attributes to the
            # connection's tenant instead of "other"
            kwargs["group_names"] = [f"{tenant}/wire-{i}" for i in range(g)]
        plan = _plan_rows(host, int(np.shape(batch_args[2])[0]))
        summary = executor.run(lambda: sampler.note_batch(
            batch_args, plan,
            scheduled=progress_args[1], matched=progress_args[2],
            device=executor.device, **kwargs,
        ))
    except Exception:  # noqa: BLE001 — telemetry only
        return
    tel = host.get("telemetry")
    if summary is None or not isinstance(tel, dict):
        return
    tel["capacity"] = {
        "fragmentation_index": summary["fragmentation_index"],
        "largest_placeable_gang": summary["largest_placeable_gang"],
        "utilization": {
            str(lane["lane"]): lane["utilization"]
            for lane in summary["lanes"] if lane["alloc"] > 0
        },
        "stranded_nodes": summary["stranded"]["nodes"],
        "pending_unplaceable_gangs": (
            summary["pending"]["unplaceable_gangs"]
        ),
    }


def _pad_request(req: proto.ScheduleRequest):
    """Bucket-pad an unpadded request via the SAME canonical padding as the
    in-process snapshot packer (ops.bucketing.pad_oracle_batch) so the wire
    path can never drift from the local path.

    The wire carries ``mask_rows`` rows (1 = broadcast fast path, G =
    per-group masks); a client that shipped a uniform [G,N] mask anyway is
    re-collapsed to the broadcast [1,N] row here so its batches reach the
    same paths as in-process batches (a smaller upload, and the telemetry's
    ``mask_mode`` says ``broadcast`` as it does there)."""
    n = req.alloc.shape[0]
    g = req.group_req.shape[0]
    mask = req.fit_mask
    if mask.shape[0] > 1 and bool((mask == mask[0:1]).all()):
        mask = mask[0:1]
    batch_args, progress_args = pad_oracle_batch(
        alloc=req.alloc,
        requested=req.requested,
        group_req=req.group_req,
        remaining=req.remaining,
        fit_mask=mask,
        group_valid=req.group_valid,
        order=req.order,
        min_member=req.min_member,
        scheduled=req.scheduled,
        matched=req.matched,
        ineligible=req.ineligible,
        creation_rank=req.creation_rank,
    )
    return batch_args, progress_args, (n, g)


def _pad_delta_request(d: proto.DeltaScheduleRequest):
    """Pad a rows-delta's O(G) tail via THE canonical pad_oracle_batch, so
    the wire delta path can never drift from the full-request padding.

    The real lane buffers are resident in the connection's mirror, so the
    [N,R]/[G,R] positions get ZERO-WIDTH placeholders — they carry the n/g
    extents the bucket sizes derive from without materialising full-size
    zero arrays per delta. The lane-domain check pad_oracle_batch would
    have run over full snapshots is applied to the CHURNED ROWS instead —
    the only lane values this frame carries — so an out-of-domain lane
    raises the same OverflowError (-> in-band ERROR) the full-snapshot wire
    path raises. Returns the padded ``(remaining, fit_mask, group_valid,
    order)`` tail + progress args."""
    for name, arr in (
        ("node_rows", d.node_rows), ("group_rows", d.group_rows)
    ):
        a = np.asarray(arr)
        if a.size and (np.abs(a.astype(np.int64)) > int(LANE_MAX)).any():
            raise OverflowError(
                f"delta {name} lanes exceed LANE_MAX (2**30): max abs "
                f"{int(np.abs(a.astype(np.int64)).max())}"
            )
    zeros_n = np.zeros((d.n, 0), np.int32)
    zeros_g = np.zeros((d.g, 0), np.int32)
    batch_args, progress_args = pad_oracle_batch(
        alloc=zeros_n,
        requested=zeros_n,
        group_req=zeros_g,
        remaining=d.remaining,
        fit_mask=d.fit_mask,
        group_valid=d.group_valid,
        order=d.order,
        min_member=d.min_member,
        scheduled=d.scheduled,
        matched=d.matched,
        ineligible=d.ineligible,
        creation_rank=d.creation_rank,
    )
    return batch_args[3:], progress_args


def _host_copy(a) -> np.ndarray:
    """A host numpy copy of one batch arg (a resident tensor or numpy):
    never a view, since the mirror's tensors change in place."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy().copy()
    return np.array(a)


class _ResyncNeeded:
    """Sentinel outcome of a delta request the mirror could not apply —
    answered with a DELTA_RESYNC frame so the client resends a keyframe."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason


_DEADLINE_HIT = object()

_EXEC_STOP = object()


class _ExecJob:
    """One unit of device work queued on the DeviceExecutor. ``wait``
    blocks until the executor completes it; an abandoned waiter (deadline
    hit on the connection worker) leaves the job to finish normally — its
    result is simply never delivered, so the device pipeline stays
    consistent no matter which side gave up."""

    __slots__ = ("kind", "args", "progress_args", "fn", "enqueued",
                 "queue_wait", "run_seconds", "tenant", "_done", "_result",
                 "_error")

    def __init__(self, kind, args=None, progress_args=None, fn=None,
                 tenant=None):
        self.kind = kind
        self.args = args
        self.progress_args = progress_args
        self.fn = fn
        # the tenant label the connection announced (the TENANT frame):
        # the sidecar sees packed arrays, never names, so the label is the
        # only tenant identity this process ever has
        self.tenant = tenant
        self.enqueued = time.perf_counter()
        self.queue_wait = 0.0
        self.run_seconds = 0.0
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def finish(self, result=None, error: Optional[BaseException] = None):
        self._result, self._error = result, error
        self._done.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("device executor job still running")
        if self._error is not None:
            raise self._error
        return self._result


class DeviceExecutor:
    """Single-owner device-executor thread: THE one thread that issues
    device work for the server — batches, the connections' mirror
    keyframes and row scatters, and row gathers.

    Streams: the thread enters its own stream (``stream``; None on the
    CPU) for its whole life, so every job's uploads, scatters, launches
    and copies are enqueued on one stream in the order the jobs were
    taken. There is no donation, as in the port's scorer: a batch reads a
    connection's resident mirror in place and ``apply_rows`` rewrites
    those tensors in place, and it is this one in-order stream that keeps
    a later scatter from overtaking the batch that read the rows. The
    connection threads do numpy work only (unpack, pad) and never touch a
    device tensor.

    Pipelining: a batch job is DISPATCHED (``ops.oracle.dispatch_batch``:
    enqueued, its blob's copy to pinned host memory started) and the
    executor immediately takes the next job, so the next batch's dispatch
    overlaps the current batch's device compute. Collection happens in
    dispatch order with an in-flight window of 2 (one computing, one being
    fed); ``collect_batch`` waits on the batch's event
    outside the interpreter lock, so the connection threads keep unpacking
    and padding meanwhile.

    DEADLINE semantics are preserved one level up: the per-connection
    worker abandons its wait when the client's budget elapses, and the
    executor still collects the abandoned batch — the device pipeline and
    every QUEUED batch stay intact. There is no fallback: on cuda the
    batch runs the scan kernel or the job fails with its error.
    """

    def __init__(self, device="cuda", scan_mesh=None):
        self.scan_mesh = scan_mesh
        self.device = scan_mesh.device if scan_mesh is not None else resolve_device(device)
        self.stream = device_stream(self.device)
        self._q: "queue.Queue" = queue.Queue()
        self._stopped = False
        self._depth = DEFAULT_REGISTRY.gauge(
            "bst_oracle_executor_queue_depth",
            "Batches/rows waiting in the sidecar device-executor queue",
        )
        self._thread = threading.Thread(
            target=self._loop, name="oracle-device-executor", daemon=True
        )
        self._thread.start()

    # -- submission ---------------------------------------------------------

    def _submit(self, job: _ExecJob) -> _ExecJob:
        # refuse after stop: a job enqueued behind the stop sentinel would
        # never be processed and its waiter would block forever (the loop
        # also fails any job that raced past this check — see _loop)
        if self._stopped:
            raise RuntimeError("device executor stopped")
        self._q.put(job)
        self._depth.set(float(self._q.qsize()))
        return job

    def submit_batch(self, batch_args, progress_args, tenant=None) -> _ExecJob:
        return self._submit(
            _ExecJob("batch", args=batch_args, progress_args=progress_args,
                     tenant=tenant)
        )

    def run_batch(self, batch_args, progress_args, tenant=None):
        """Blocking convenience: returns (host, device_result,
        queue_wait_s, run_s). The caller's thread (a per-connection worker)
        may be abandoned on deadline — see class docstring."""
        job = self.submit_batch(batch_args, progress_args, tenant=tenant)
        host, device_result = job.wait()
        return host, device_result, job.queue_wait, job.run_seconds

    def run(self, fn):
        """Execute a device closure (a mirror update, a row gather) on the
        executor thread, in queue order — the same total order as
        batches."""
        return self._submit(_ExecJob("call", fn=fn)).wait()

    def stop(self, timeout: float = 60.0) -> bool:
        self._stopped = True
        self._q.put(_EXEC_STOP)
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- the executor thread ------------------------------------------------

    def _collect_oldest(self, inflight: deque) -> None:
        job, pending = inflight.popleft()
        # the connection's announced tenant is this thread's batch-tenant
        # context while the batch is collected, cleared in the finally so
        # the next job never inherits it
        if job.tenant:
            tenancy.set_batch_tenant(job.tenant)
        try:
            result = collect_batch(pending)
        except BaseException as e:  # noqa: BLE001 — delivered to the waiter
            job.run_seconds = time.perf_counter() - job.enqueued - job.queue_wait
            job.finish(error=e)
            return
        finally:
            if job.tenant:
                tenancy.set_batch_tenant(None)
        job.run_seconds = time.perf_counter() - job.enqueued - job.queue_wait
        job.finish(result=result)

    def _loop(self) -> None:
        with torch.cuda.stream(self.stream):
            self._serve()

    def _serve(self) -> None:
        inflight: deque = deque()
        while True:
            if inflight:
                # drain the queue opportunistically; with nothing queued,
                # collecting the oldest in-flight batch IS the next job
                try:
                    job = self._q.get_nowait()
                except queue.Empty:
                    self._collect_oldest(inflight)
                    continue
            else:
                job = self._q.get()
            self._depth.set(float(self._q.qsize()))
            if job is _EXEC_STOP:
                while inflight:
                    self._collect_oldest(inflight)
                # fail anything that raced past the _stopped check into
                # the queue: blocked waiters get an error, never a hang
                while True:
                    try:
                        straggler = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if straggler is not _EXEC_STOP:
                        straggler.finish(
                            error=RuntimeError("device executor stopped")
                        )
            if job.kind == "batch":
                while len(inflight) >= _WINDOW:
                    self._collect_oldest(inflight)
                job.queue_wait = time.perf_counter() - job.enqueued
                try:
                    pending = dispatch_batch(
                        job.args, job.progress_args, device=self.device,
                        scan_mesh=self.scan_mesh,
                    )
                except BaseException as e:  # noqa: BLE001 — to the waiter
                    job.finish(error=e)
                    continue
                inflight.append((job, pending))
            else:
                # mirror updates and row gathers ride the same total order;
                # a gather's data dependency is an ALREADY-DISPATCHED batch
                # on this stream, so it completes without waiting out the
                # in-flight window
                job.queue_wait = time.perf_counter() - job.enqueued
                t0 = time.perf_counter()
                try:
                    result = job.fn()
                except BaseException as e:  # noqa: BLE001
                    job.finish(error=e)
                    continue
                job.run_seconds = time.perf_counter() - t0
                job.finish(result=result)


class _ConnWorker:
    """Per-connection daemon worker running request bodies, so the handler
    thread can enforce a client-announced deadline: it waits a bounded
    time and answers a DEADLINE_ERROR frame while the stalled computation
    keeps running here — its result is dropped at delivery, never applied
    to connection state. Jobs serialize per connection, so a request
    queued behind a stalled one spends its own budget waiting, which is
    the correct signal for a wedged device. Daemon thread: a hung job must
    never block server shutdown or interpreter exit."""

    def __init__(self):
        self._q = queue.SimpleQueue()
        threading.Thread(
            target=self._loop, name="oracle-conn-worker", daemon=True
        ).start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, slot, done = item
            try:
                slot[:] = [(True, fn())]
            except BaseException as e:  # noqa: BLE001 — re-raised at run()
                slot[:] = [(False, e)]
            done.set()

    def run(self, fn, budget_ms: Optional[int]):
        """Execute ``fn`` on the worker; block up to ``budget_ms`` (None =
        forever). Returns the result, re-raises fn's exception, or returns
        ``_DEADLINE_HIT`` when the budget elapsed first (fn keeps running;
        its outcome is discarded)."""
        slot: list = []
        done = threading.Event()
        self._q.put((fn, slot, done))
        timeout = None if budget_ms is None else max(int(budget_ms), 1) / 1000.0
        if not done.wait(timeout):
            return _DEADLINE_HIT
        ok, value = slot[0]
        if not ok:
            raise value
        return value

    def close(self) -> None:
        self._q.put(None)


class _Handler(socketserver.BaseRequestHandler):
    def _run(self, fn, budget_ms: Optional[int]):
        """Run one request body: inline while the connection has never
        armed a deadline (the common case — the native client never does —
        pays no worker thread and no queue hop), else on the lazily
        created per-connection worker so the budget is enforceable. Once a
        worker exists, ALL subsequent requests route through it, keeping
        them serialized behind any abandoned still-running job instead of
        racing it."""
        if budget_ms is None and self._worker is None:
            return fn()
        if self._worker is None:
            self._worker = _ConnWorker()
        return self._worker.run(fn, budget_ms)

    @staticmethod
    def _note_policy_skew(peer_fp: str) -> None:
        """A client announced its policy-config fingerprint (the
        POLICY_INFO annotation). The sidecar executes BASE batches — it
        has no policy engine unless one was enabled in this process — so
        any fingerprint it does not share means the client's policy scan
        and this server's base scan would produce different plans. Counted,
        never fatal: the client still gets its batch."""
        own = None
        try:
            from ..policy.engine import active_fingerprint

            fp = active_fingerprint()
            own = fp["fingerprint"] if fp else None
        except Exception:  # noqa: BLE001 — detection must never drop a batch
            pass
        if peer_fp != (own or ""):
            DEFAULT_REGISTRY.counter(
                "bst_policy_fingerprint_mismatch_total",
                "Schedule requests whose client announced a policy-config "
                "fingerprint this server does not share (the client-side "
                "policy scan and this sidecar's base scan would diverge)",
            ).inc()

    @staticmethod
    def _mk_span(name: str, ts_epoch: float, dur_s: float, trace_ctx, **args):
        """One Chrome-trace span dict for the TRACE_INFO reply, stamped
        with the CLIENT's trace/parent IDs so both sides of the wire
        stitch into a single timeline."""
        trace_id, parent_id = trace_ctx
        a = {"trace_id": trace_id, **args}
        if parent_id:
            a["parent_id"] = parent_id
        return {
            "name": name,
            "cat": "oracle",
            "ts": ts_epoch * 1e6,
            "dur": dur_s * 1e6,
            "args": a,
        }

    def _busy(self, e: CoalesceSaturated) -> None:
        proto.write_frame(
            self.request, proto.MsgType.BUSY,
            proto.pack_busy(e.retry_after_ms, str(e)),
        )

    def _deadline_error(self, what: str, budget_ms: int) -> None:
        proto.write_frame(
            self.request,
            proto.MsgType.DEADLINE_ERROR,
            f"{what} exceeded deadline of {budget_ms}ms".encode(),
        )

    def handle(self) -> None:
        deadline_ms: Optional[int] = None  # armed for the NEXT request
        trace_ctx: Optional[tuple] = None  # armed for the NEXT request
        audit_ctx: Optional[str] = None  # armed for the NEXT request
        policy_ctx: Optional[str] = None  # armed for the NEXT request
        self._worker: Optional[_ConnWorker] = None
        # the connection's announced tenant (TENANT annotation): armed like
        # every annotation, then kept STICKY — a scheduler's tenant
        # identity doesn't change per batch
        self._tenant: Optional[str] = None
        # per-connection batch state (handler instances are per-connection;
        # requests serialize through _run, so these need no lock)
        self._last_batch: Optional[dict] = None
        self._last_counts = (0, 0)
        self._batch_seq = 0
        # device-resident mirror of the client's packed state
        # (ops.device_state), fed by DELTA_SCHEDULE_REQ frames; dies with
        # the connection — a reconnecting client must keyframe, which the
        # DELTA_RESYNC answer forces
        self._mirror: Optional[DeviceStateHolder] = None
        self._mirror_counts = None
        self.server._track(self.request, True)
        self._batch_seconds = DEFAULT_REGISTRY.histogram(
            "bst_oracle_server_batch_seconds",
            "Sidecar-side wall-clock per schedule batch (unpack + pad + "
            "device)",
            buckets=LONG_OP_BUCKETS,
        )
        self._batches_total = DEFAULT_REGISTRY.counter(
            "bst_oracle_server_batches_total",
            "Schedule batches executed by the sidecar, by traced",
        )
        try:
            while True:
                try:
                    msg_type, payload = proto.read_frame(self.request)
                except (ConnectionError, OSError):
                    return
                except ValueError:
                    return  # not speaking our protocol: drop the connection
                admitted = False
                try:
                    if msg_type == proto.MsgType.DEADLINE:
                        deadline_ms = proto.unpack_deadline(payload)
                        continue  # annotation only; no reply
                    if msg_type == proto.MsgType.TRACE:
                        trace_ctx = proto.unpack_trace(payload)
                        continue  # annotation only; no reply
                    if msg_type == proto.MsgType.AUDIT_ID:
                        audit_ctx = proto.unpack_audit_id(payload)
                        continue  # annotation only; no reply
                    if msg_type == proto.MsgType.POLICY_INFO:
                        policy_ctx = proto.unpack_policy_info(payload)
                        continue  # annotation only; no reply
                    if msg_type == proto.MsgType.TENANT:
                        self._tenant = proto.unpack_tenant(payload)
                        continue  # annotation only; no reply
                    budget_ms, deadline_ms = deadline_ms, None
                    req_trace, trace_ctx = trace_ctx, None
                    req_audit, audit_ctx = audit_ctx, None
                    req_policy, policy_ctx = policy_ctx, None
                    if req_policy is not None:
                        self._note_policy_skew(req_policy)
                    if msg_type in _DRAIN_GATED:
                        # graceful-drain admission gate: once drain() flips
                        # the flag, work-bearing requests get a DRAINING
                        # answer + failover hint instead of execution,
                        # while requests admitted BEFORE the flip finish
                        # inside the window drain() waits out. PING stays
                        # answered below: liveness is truthful to the end.
                        if not self.server._admit_request():
                            proto.write_frame(
                                self.request, proto.MsgType.DRAINING,
                                proto.pack_draining(
                                    _DRAIN_RETRY_AFTER_MS,
                                    self.server.failover_hint,
                                ),
                            )
                            continue
                        admitted = True
                    if msg_type == proto.MsgType.PING:
                        # answered inline, never through the worker:
                        # liveness must stay observable even while a
                        # stalled batch occupies the worker (the client's
                        # half-open breaker probe depends on it)
                        proto.write_frame(self.request, proto.MsgType.PONG, b"")
                    elif msg_type == proto.MsgType.SCHEDULE_REQ:
                        # a full request supersedes any delta mirror: the
                        # client's cursor keyframes after a fallback, and a
                        # stale mirror would only pin device memory
                        self._release_mirror()
                        self._mirror_counts = None
                        try:
                            outcome = self._run(
                                lambda payload=payload: self._run_schedule_body(
                                    payload, traced=req_trace is not None
                                ),
                                budget_ms,
                            )
                        except CoalesceSaturated as e:
                            # admission control: the bounded coalescer queue
                            # is full — an in-band BUSY with the retry-after
                            # hint, never a dropped or hanging request
                            self._busy(e)
                            continue
                        if outcome is _DEADLINE_HIT:
                            self._deadline_error("schedule", budget_ms)
                            continue
                        self._finish_schedule(outcome, req_trace, req_audit)
                    elif msg_type == proto.MsgType.DELTA_SCHEDULE_REQ:
                        try:
                            outcome = self._run(
                                lambda payload=payload: self._run_delta_body(
                                    payload, traced=req_trace is not None
                                ),
                                budget_ms,
                            )
                        except CoalesceSaturated as e:
                            # _run_delta_body checks admission BEFORE
                            # touching the mirror, so the common refusal
                            # leaves the client's cursor valid for a plain
                            # retry. The rare race (the queue filled between
                            # the check and the submit, the mirror already
                            # advanced) still converges: the retried delta's
                            # base mismatches, the server answers
                            # DELTA_RESYNC, and the client keyframes.
                            self._busy(e)
                            continue
                        if outcome is _DEADLINE_HIT:
                            # the abandoned job may still advance the
                            # mirror generation; the client resets its
                            # cursor on any error and keyframes next, so
                            # no stale-row window opens
                            self._deadline_error("schedule", budget_ms)
                            continue
                        if isinstance(outcome, _ResyncNeeded):
                            DEFAULT_REGISTRY.counter(
                                "bst_device_delta_resyncs_total",
                                "Wire deltas the sidecar mirror refused "
                                "(generation gap / no state / shape "
                                "mismatch) — the client resends a keyframe",
                            ).inc()
                            proto.write_frame(
                                self.request,
                                proto.MsgType.DELTA_RESYNC,
                                proto.pack_delta_resync(outcome.reason),
                            )
                            continue
                        self._finish_schedule(outcome, req_trace, req_audit)
                    elif msg_type == proto.MsgType.ROW_REQ:
                        kind, gidx, req_seq = proto.unpack_row_request(payload)
                        if self._last_batch is None:
                            raise ValueError("row request before any batch")
                        if req_seq != self._batch_seq:
                            raise ValueError(
                                f"stale batch: row for seq {req_seq}, current {self._batch_seq}"
                            )
                        n, g = self._last_counts
                        if not 0 <= gidx < g:
                            raise ValueError(f"row index {gidx} out of range {g}")
                        batch = self._last_batch

                        def gather(batch=batch, kind=kind, gidx=gidx, n=n):
                            # issued by the executor thread, on its stream,
                            # after the batch that wrote the row
                            return batch[kind][gidx][:n].cpu().numpy().astype("<i4")

                        def run_row(batch=batch, kind=kind, gidx=gidx, gather=gather):
                            if hasattr(batch, "gather"):
                                # a coalesced batch: the row view owns the
                                # span slicing AND the executor hop
                                return batch.gather(kind, gidx)
                            return self.server.executor.run(gather)

                        outcome = self._run(run_row, budget_ms)
                        if outcome is _DEADLINE_HIT:
                            self._deadline_error("row fetch", budget_ms)
                            continue
                        proto.write_frame(
                            self.request, proto.MsgType.ROW_RESP, outcome.tobytes()
                        )
                    else:
                        raise ValueError(f"unknown message type {msg_type}")
                except Exception as e:  # protocol errors answer in-band
                    try:
                        proto.write_frame(
                            self.request, proto.MsgType.ERROR, str(e).encode()
                        )
                    except OSError:
                        return
                finally:
                    # every admitted request retires exactly once (the
                    # annotation/DEADLINE `continue`s above still pass
                    # through here) — drain() waits on this count
                    if admitted:
                        self.server._request_done()
        finally:
            self.server._track(self.request, False)
            if self._worker is not None:
                self._worker.close()
            self._release_mirror()

    def _release_mirror(self) -> None:
        """Drop the connection's mirror; a mesh mirror gives its slot up on
        the followers, on the executor thread (nothing to give up once the
        executor has stopped: so have the followers)."""
        mirror, self._mirror = self._mirror, None
        if mirror is None or mirror.mesh is None:
            return
        try:
            self.server.executor.run(mirror.release)
        except RuntimeError:
            pass

    def _run_schedule_body(self, payload: bytes, traced: bool = False):
        """One SCHEDULE_REQ: unpack and pad on this thread (numpy only),
        then the batch through the executor — or, with the coalescer on,
        through its DRF merge queue, whose demuxed result is bit-identical
        to the direct path's. Raises ``CoalesceSaturated`` when that queue
        is full. Returns the outcome tuple ``_finish_schedule`` takes."""
        # phase timings double as the TRACE_INFO span source and the server
        # metric observations — epoch stamps so client+server spans share a
        # clock domain in the stitched timeline
        ts0 = time.time()
        t0 = time.perf_counter()
        req = proto.unpack_schedule_request(payload)
        args, progress_args, (n, g) = _pad_request(req)
        executor = self.server.executor
        coal = self.server.coalescer
        t1 = time.perf_counter()
        if coal is not None:
            job = CoalesceJob(
                tenant=self._tenant or "", n=n, g=g,
                r=int(req.alloc.shape[1]),
                padded_args=args, progress_args=progress_args,
                raw_fn=lambda req=req: (
                    req.alloc, req.requested, req.group_req, req.remaining,
                    req.fit_mask, req.group_valid, req.order,
                    req.min_member, req.scheduled, req.matched,
                    req.ineligible, req.creation_rank,
                ),
                want_audit=self.server.audit_log is not None,
            )
            res = coal.schedule(job)
            host, batch = res.host, res.rows
            queue_wait, run_s = res.queue_wait, res.run_seconds
            audit_args = res.audit_args
            self._note_warmer(args, progress_args, host)
        else:
            # host-side padded args: the audit record must replay anywhere
            audit_args = (
                (args, progress_args) if self.server.audit_log is not None else None
            )
            host, batch, queue_wait, run_s = executor.run_batch(
                args, progress_args, tenant=self._tenant,
            )
            self._note_warmer(args, progress_args, host)
        if traced:
            # the sidecar's capacity sample for the traced client
            # (budget-gated; rides TRACE_INFO), attributed to the
            # announced wire tenant
            _maybe_server_capacity(
                executor, args, progress_args, host,
                tenant=self._tenant, g=g,
            )
        timings = {
            "ts0": ts0,
            "unpack_pad": t1 - t0,
            # span name kept for trace-schema stability: with the executor
            # this is QUEUE wait
            "lock_wait": queue_wait,
            "device": run_s,
        }
        return host, batch, (n, g), timings, audit_args

    def _note_warmer(self, args, progress_args, host) -> None:
        """The executor's served batch, noted by the bucket warmer (when
        the server runs one) with the host-side padded args it ran."""
        warmer = self.server.warmer
        if warmer is None:
            return
        try:
            warmer.note_batch(args, progress_args, host.get("telemetry") or {})
        except Exception:  # noqa: BLE001 — warm accounting never fatal
            pass

    def _finish_schedule(self, outcome, req_trace, req_audit) -> None:
        """Shared tail of the full and delta schedule paths: install the
        batch as connection state, record the sidecar-side audit evidence,
        emit metrics and the TRACE_INFO frame, and answer the SCHEDULE_RESP
        in the client's node space."""
        host, batch, (n, g), timings, audit_args = outcome
        self._last_batch = batch
        self._last_counts = (n, g)
        self._batch_seq += 1
        if audit_args is not None:
            # sidecar-side audit record, stamped with the CLIENT's audit ID
            # (the AUDIT_ID annotation) so both sides' records of this
            # batch join one evidence chain; enqueue only — the daemon
            # writer owns serialization and disk
            try:
                self.server.audit_log.record_batch(
                    batch_args=audit_args[0],
                    progress_args=audit_args[1],
                    result=host,
                    plan_digest=audit_mod.plan_digest(host),
                    audit_id=req_audit,
                    trace_id=req_trace[0] if req_trace else None,
                    telemetry=host.get("telemetry") or {},
                    extra={
                        "side": "server",
                        "batch_seq": self._batch_seq,
                        "n": n,
                        "g": g,
                    },
                )
            except Exception:  # noqa: BLE001 — evidence only
                pass
        total_s = timings["unpack_pad"] + timings["lock_wait"] + timings["device"]
        self._batch_seconds.observe(total_s)
        self._batches_total.inc(traced="yes" if req_trace else "no")
        if req_trace is not None:
            telemetry = dict(host.get("telemetry") or {})
            telemetry.update(
                device_seconds=round(timings["device"], 6),
                lock_wait_seconds=round(timings["lock_wait"], 6),
                unpack_pad_seconds=round(timings["unpack_pad"], 6),
                batch_seq=self._batch_seq,
                n=n,
                g=g,
                # pipelining evidence: batches in flight at answer time
                inflight_batches=inflight_batches(),
            )
            if telemetry.get("waves_per_batch"):
                telemetry["per_wave_device_seconds"] = round(
                    timings["device"] / telemetry["waves_per_batch"], 6
                )
            if req_audit is not None:
                telemetry["audit_id"] = req_audit
            if self.server.warmer is not None:
                # the warmer's counters ride back with the telemetry
                telemetry.update(self.server.warmer.stats())
            ts0 = timings["ts0"]
            spans = [
                self._mk_span("oracle.schedule", ts0, total_s, req_trace,
                              n=n, g=g),
                self._mk_span("oracle.unpack_pad", ts0,
                              timings["unpack_pad"], req_trace),
                self._mk_span("oracle.lock_wait", ts0 + timings["unpack_pad"],
                              timings["lock_wait"], req_trace),
                self._mk_span(
                    "oracle.device_batch",
                    ts0 + timings["unpack_pad"] + timings["lock_wait"],
                    timings["device"], req_trace,
                    compiled=telemetry.get("compiled"),
                ),
            ]
            if trace_mod.enabled():
                # the server-side local ring: the same spans land in this
                # process's /debug/trace too
                trace_mod.record_remote_spans(spans, pid="oracle-server")
            proto.write_frame(
                self.request,
                proto.MsgType.TRACE_INFO,
                proto.pack_trace_info(req_trace[0], spans, telemetry),
            )
        # Map assignment node indexes back into the CLIENT's node space
        # before packing: the batch ran in the bucket-padded node space,
        # whose first n indexes are the client's nodes and whose tail is
        # padding. Real takes only land on the first n (pad nodes are
        # masked), but the top-k backfills zero-count slots with arbitrary
        # indexes — zero those out so a client stamping a whole-gang plan
        # never sees an out-of-space index.
        a_nodes = np.asarray(host["assignment_nodes"])[:g]
        a_counts = np.asarray(host["assignment_counts"])[:g]
        in_space = a_nodes < n
        a_nodes = np.where(in_space, a_nodes, 0)
        a_counts = np.where(in_space, a_counts, 0)
        resp = proto.ScheduleResponse(
            gang_feasible=np.asarray(host["gang_feasible"])[:g],
            placed=np.asarray(host["placed"])[:g],
            progress=np.asarray(host["progress"])[:g],
            best=int(host["best"]),
            best_exists=bool(host["best_exists"]),
            assignment_nodes=a_nodes,
            assignment_counts=a_counts,
            batch_seq=self._batch_seq,
        )
        proto.write_frame(
            self.request,
            proto.MsgType.SCHEDULE_RESP,
            proto.pack_schedule_response(resp),
        )

    def _run_delta_body(self, payload: bytes, traced: bool = False):
        """One DELTA_SCHEDULE_REQ: bring the connection's resident mirror
        (ops.device_state.DeviceStateHolder) up to the client's generation
        — scatter-applying churned rows, or installing a full keyframe —
        then run the batch FROM the resident tensors. Mirror updates go
        through the executor like batches, so they are ordered on its
        stream after every batch that read the rows they rewrite. Returns
        the same outcome tuple as the full path so ``_finish_schedule`` is
        shared, or a ``_ResyncNeeded`` when the mirror cannot apply the
        delta (generation gap / no state / shape mismatch) — the client
        must resend a keyframe, never have stale rows scored silently.
        With the coalescer on, admission is checked BEFORE the mirror
        moves (a BUSY answer leaves the client's generation cursor valid)
        and the batch joins the merge queue."""
        ts0 = time.time()
        t0 = time.perf_counter()
        kind, base_gen, new_gen, body = proto.unpack_delta_schedule_request(
            payload
        )
        executor = self.server.executor
        coal = self.server.coalescer
        if coal is not None:
            coal.check_admission()
        if self._mirror is None:
            self._mirror = DeviceStateHolder(self.server.device, label="server",
                                             mesh=self.server.scan_mesh)
        holder = self._mirror
        want_audit = self.server.audit_log is not None
        audit_args = None
        if kind == proto.DELTA_KEYFRAME:
            args, progress_args, (n, g) = _pad_request(body)
            if want_audit:
                audit_args = (args, progress_args)
            device_args = executor.run(
                lambda: holder.keyframe(args, new_gen, "wire-keyframe")
            )
            self._mirror_counts = (n, g, int(body.alloc.shape[1]))
        else:
            n, g = body.n, body.g
            if self._mirror_counts != (n, g, body.r):
                return _ResyncNeeded(
                    f"shape mismatch: mirror {self._mirror_counts}, "
                    f"delta ({n}, {g}, {body.r})"
                )
            small_args, progress_args = _pad_delta_request(body)

            def apply():
                return holder.apply_rows(
                    base_gen,
                    new_gen,
                    (body.node_idx, body.node_rows),
                    (body.group_idx, body.group_rows),
                    small_args,
                )

            device_args = executor.run(apply)
            if device_args is None:
                return _ResyncNeeded(
                    f"generation gap: mirror at "
                    f"{holder.current_generation()}, delta base {base_gen}"
                )
            if want_audit:
                # the audit record must replay anywhere: read the
                # delta-applied buffers back to host copies, on the
                # executor (paid only when the sidecar records audits)
                audit_args = (
                    executor.run(lambda: tuple(_host_copy(a) for a in device_args)),
                    progress_args,
                )
        t1 = time.perf_counter()
        if coal is not None:
            # the mirror is synced; the batch itself joins the DRF merge
            # queue like a full request, reading the mirror in place
            def raw_fn(device_args=device_args, progress_args=progress_args,
                       n=n, g=g):
                al, rq, gr, rem, fm, gv, od = executor.run(
                    lambda: tuple(_host_copy(a) for a in device_args)
                )
                mm, sc, mt, inel, cr = (np.asarray(a) for a in progress_args)
                mask = fm[:1, :n] if fm.shape[0] == 1 else fm[:g, :n]
                return (
                    al[:n], rq[:n], gr[:g], rem[:g], mask, gv[:g],
                    od[:g], mm[:g], sc[:g], mt[:g], inel[:g], cr[:g],
                )

            job = CoalesceJob(
                tenant=self._tenant or "", n=n, g=g,
                r=self._mirror_counts[2],
                padded_args=device_args, progress_args=progress_args,
                raw_fn=raw_fn, want_audit=want_audit,
            )
            res = coal.schedule(job)
            host, batch = res.host, res.rows
            queue_wait, run_s = res.queue_wait, res.run_seconds
        else:
            host, batch, queue_wait, run_s = executor.run_batch(
                device_args, progress_args, tenant=self._tenant,
            )
        host["telemetry"]["device_state"] = {
            "generation": holder.current_generation(),
            "applied": "keyframe" if kind == proto.DELTA_KEYFRAME else "delta",
            "rows": int(
                len(body.node_idx) + len(body.group_idx)
            ) if kind == proto.DELTA_ROWS else 0,
        }
        if traced:
            # capacity over the MIRROR's resident tensors — the sidecar's
            # own view of the cluster it is scoring (rides TRACE_INFO),
            # attributed to the announced wire tenant
            _maybe_server_capacity(
                executor, device_args, progress_args, host,
                tenant=self._tenant, g=g,
            )
        timings = {
            "ts0": ts0,
            "unpack_pad": t1 - t0,
            "lock_wait": queue_wait,
            "device": run_s,
        }
        return host, batch, (n, g), timings, audit_args


class OracleServer(socketserver.ThreadingTCPServer):
    """The sidecar: one ``DeviceExecutor`` on ``device`` (``cuda`` unless
    the caller passes ``cpu``; without CUDA the default raises before the
    socket is bound) behind a threading TCP server, one handler thread per
    connection. ``audit_log`` (a ``utils.audit.AuditLog``) records every
    executed batch, correlated with the client's records by the AUDIT_ID
    annotation. ``coalesce`` puts the multi-tenant coalescer
    (``service.coalescer.OracleCoalescer``, its DRF order weighted by the
    sidecar's capacity shares) in front of the executor; None reads
    ``BST_COALESCE`` (default off). ``compile_warmer`` runs the bucket
    warmer on ``device`` (``ops.bucketing.maybe_compile_warmer``).
    ``scan_mesh`` (a ``parallel.ShardMesh`` on its rank 0; the other ranks
    run ``parallel.follow``) runs every batch over the mesh, on the mesh's
    device, without the coalescer or the warmer (the module docstring).
    ``server_close`` hangs up every open connection, as a stopped sidecar
    process would: its clients see the transport fail."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        audit_log=None,
        device="cuda",
        coalesce: Optional[bool] = None,
        compile_warmer: bool = False,
        scan_mesh=None,
    ):
        self.scan_mesh = scan_mesh
        self.device = scan_mesh.device if scan_mesh is not None else resolve_device(device)
        super().__init__((host, port), _Handler)
        self.audit_log = audit_log
        self.executor = DeviceExecutor(self.device, scan_mesh=scan_mesh)
        self.warmer = None
        if compile_warmer:
            from ..ops.bucketing import maybe_compile_warmer

            self.warmer = maybe_compile_warmer(self.device, scan_mesh)
        # the multi-tenant cross-client coalescer: a DRF-fair merge queue
        # in front of the executor; single-device only, as in the reference
        want_coalesce = (
            coalesce_enabled() if coalesce is None else bool(coalesce)
        )
        self.coalescer = None
        if want_coalesce and scan_mesh is None:
            self.coalescer = OracleCoalescer(self.executor, weights_fn=_capacity_tenant_shares)
        elif want_coalesce:
            print(
                "coalescer skipped: mesh server (shard placement happens "
                "per connection; merged batches would reshard)",
                file=sys.stderr,
            )
        # graceful drain: _admit_request/_request_done bracket every
        # work-bearing request so drain() can wait out the admitted
        # in-flight window before flushing; failover_hint rides in every
        # DRAINING answer so even clients configured with a single address
        # learn where the standby lives (BST_FAILOVER_HINT, or
        # drain(failover_hint=...))
        self._draining = False
        self._inflight_requests = 0
        self._inflight_lock = threading.Lock()
        self._drain_done = threading.Event()
        self._drain_report: dict = {}
        self.failover_hint = os.environ.get("BST_FAILOVER_HINT", "")
        self._draining_gauge = DEFAULT_REGISTRY.gauge(
            "bst_server_draining",
            "1 while the sidecar refuses new work with DRAINING answers, "
            "else 0",
        )
        self._gauge_addr = f"{host}:{self.server_address[1]}"
        self._draining_gauge.set(0, addr=self._gauge_addr)
        self._conns: set = set()  # guarded-by: _inflight_lock
        _LIVE_SERVERS.add(self)

    @property
    def address(self):
        return self.server_address

    def draining(self) -> bool:
        with self._inflight_lock:
            return self._draining

    def _admit_request(self) -> bool:
        """Admission bracket for one work-bearing request (the handler's
        drain gate). False once drain() flipped the flag — the handler
        answers DRAINING instead of executing."""
        with self._inflight_lock:
            if self._draining:
                return False
            self._inflight_requests += 1
            return True

    def _request_done(self) -> None:
        with self._inflight_lock:
            self._inflight_requests -= 1

    def _track(self, conn, open_: bool) -> None:
        with self._inflight_lock:
            if open_:
                self._conns.add(conn)
            else:
                self._conns.discard(conn)

    def drain(
        self,
        timeout: Optional[float] = None,
        failover_hint: Optional[str] = None,
    ) -> dict:
        """Graceful drain: stop admitting, finish the in-flight window,
        flush everything durable, report. Subsequent work requests get
        DRAINING + the failover hint; PING and annotations still flow.

        Flush order is producer-before-consumer: the executor drains (it
        collects every dispatched batch), then the audit log flushes.

        Idempotent: concurrent callers wait on the first drain and get its
        report. ``timeout`` bounds the in-flight wait only (default
        BST_DRAIN_TIMEOUT_S, 30 s). Does NOT close the listener — the
        caller decides when the refusing-but-alive phase ends.
        """
        if timeout is None:
            timeout = _drain_timeout_s()
        if failover_hint is not None:
            self.failover_hint = failover_hint
        with self._inflight_lock:
            first = not self._draining
            self._draining = True
        self._draining_gauge.set(1, addr=self._gauge_addr)
        if not first:
            self._drain_done.wait(max(1.0, float(timeout)) + 60.0)
            return dict(self._drain_report)
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(timeout))
        while True:
            with self._inflight_lock:
                inflight = self._inflight_requests
            if inflight <= 0 or time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        # producers before the executor: the warmer's thread must not be
        # inside a batch at teardown, and the coalescer feeds the executor
        # (a group dispatched after executor.stop would fail its waiters)
        if self.warmer is not None:
            self.warmer.stop(timeout=10.0)
        if self.coalescer is not None:
            self.coalescer.stop(timeout=10.0)
        self.executor.stop(timeout=10.0)
        self._stop_followers()
        audit_ok = True
        if self.audit_log is not None:
            try:
                self.audit_log.flush(timeout=30.0)
            except Exception:  # noqa: BLE001 — report, don't abort exit
                audit_ok = False
        self._drain_report = {
            "drained": inflight <= 0,
            "inflight_at_flush": inflight,
            "wait_s": round(time.monotonic() - t0, 3),
            "audit_flushed": audit_ok,
            "failover_hint": self.failover_hint,
        }
        self._drain_done.set()
        return dict(self._drain_report)

    def warmth_snapshot(self) -> list:
        """The bucket warmer's observed shape prototypes: the primary side
        of warmth replication to a standby ([] with no warmer)."""
        if self.warmer is None:
            return []
        return self.warmer.warmth_snapshot()

    def replicate_warmth(self, protos) -> int:
        """Feed another sidecar's observed shapes into this server's
        warmer, so a promotion finds them warm; returns how many
        prototypes were enqueued (0 with no warmer)."""
        if self.warmer is None or not protos:
            return 0
        return self.warmer.replicate(protos)

    def server_close(self) -> None:
        try:
            with self._inflight_lock:
                conns = list(self._conns)
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            if self.warmer is not None:
                self.warmer.stop(timeout=10.0)
            if self.coalescer is not None:
                self.coalescer.stop(timeout=10.0)
            self.executor.stop(timeout=10.0)
            self._stop_followers()
            if self.audit_log is not None:
                self.audit_log.stop(timeout=10.0)
        finally:
            super().server_close()

    def _stop_followers(self) -> None:
        """On a mesh, the stop header to the followers (once; the executor
        has stopped, so no batch is in its collectives)."""
        if self.scan_mesh is not None:
            from ..parallel.mesh import stop_followers

            stop_followers(self.scan_mesh)


def serve_background(
    host: str = "127.0.0.1", port: int = 0, audit_log=None, device="cuda",
    coalesce: Optional[bool] = None, compile_warmer: bool = False, scan_mesh=None,
) -> OracleServer:
    """Start an OracleServer on a daemon thread; returns it (``.address``
    has the bound port, ``.shutdown()`` stops it, ``.server_close()``
    releases the socket and stops the warmer, the coalescer, the
    executor and, on a mesh, the followers)."""
    server = OracleServer(host, port, audit_log=audit_log, device=device,
                          coalesce=coalesce, compile_warmer=compile_warmer,
                          scan_mesh=scan_mesh)
    t = threading.Thread(
        target=server.serve_forever, name="oracle-server", daemon=True
    )
    t.start()
    return server
