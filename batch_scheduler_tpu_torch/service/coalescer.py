"""Multi-tenant oracle coalescer: one sidecar, many schedulers.

The port of ``batch_scheduler_tpu/service/coalescer.py``. The paper's
oracle serves exactly one scheduler per sidecar; the north star's fleets
want K clusters (or shards of one huge cluster) each running a plugin, all
hitting one shared oracle. This module is the cross-client batching
subsystem in front of the ``DeviceExecutor``: pending schedule requests
from different connections are admitted in a DRF-fair order, merged into
groups, and executed so the device never idles between tenants — the
inference-server continuous-batching pattern (Orca) applied to scheduling
batches, with the datacenter-scheduling fairness half (Dominant Resource
Fairness, Ghodsi et al.) deciding who goes first.

Two merge lowerings, selected per group (``BST_COALESCE_MODE``):

- **span** — per-span re-dispatch: each tenant's already-padded batch is
  submitted to the executor back-to-back in admission order, so batch
  N+1's dispatch overlaps batch N's device compute (the executor's
  in-flight window). Bit-identity to a dedicated sidecar is trivial —
  it IS the dedicated dispatch, pipelined.
- **mega** — block-diagonal mega-batch: tenants' unpadded arrays
  concatenate along G *and* N (each tenant's gangs are fit-masked to its
  own node block), pad once, ONE device batch (one launch of the scan
  kernel). The serial scan is order-dependent through the carried [N,R]
  leftover, but the mega-batch is **block-diagonal over node state, never
  a shared leftover**: a tenant's gangs can only take (and only see
  capacity in) its own node rows, so each tenant's sub-scan runs against
  exactly the leftover its dedicated run would carry — per-tenant plans
  equal the dedicated sidecar's BY CONSTRUCTION, on both scan kernels. The
  demux slices each tenant's G span, maps assignment indices back by its
  node offset (ops.oracle.repack_assignment_span re-derives the dedicated
  compact row exactly, including the top-k zero-count backfill), and
  recomputes the per-tenant max-progress ``best`` from the tenant's own
  padded progress args (ops.oracle.find_max_group_host). The mega scan's
  cost is O(G_tot·N_tot·R), so ``auto`` mode uses it only below
  ``BST_COALESCE_MEGA_CELLS``, where per-batch fixed overhead dominates
  the extra cells.

**DRF admission order**: among tenants with pending work, the one with
the lowest dominant share dequeues first. The share has two live
components: the capacity observatory's per-tenant dominant-resource
share (what the tenant already holds of the cluster) fed through
``weights_fn``, plus the coalescer's own exponentially-decayed
serviced-work fraction (gangs×nodes dispatched; half-life
``BST_COALESCE_FAIR_HALFLIFE_S``) — so a whale flooding the queue
accumulates serviced share and a starved small tenant sorts ahead of it
within one merge group.

**Admission control**: the merge queue is bounded (``BST_COALESCE_DEPTH``
jobs). A submit over the bound raises :class:`CoalesceSaturated` and the
server answers an in-band ``BUSY`` frame with a retry-after hint derived
from the live service rate — the resilient client waits it out and
retries, never a silent hang.

Device rule (the port's server): only the executor thread touches a device
tensor. A job's padded args may be the device-resident mirror of a delta
connection; the mega lowering's ``raw_fn`` and the row views' gathers
read device tensors through ``executor.run``. The port has no buffer
donation, so nothing here pins or passes it. A mega group that fails
falls back to the span lowering (both run the scan kernel on the card);
each such group is counted (``mega_failures`` in ``stats()``,
``bst_coalesce_mega_failures_total``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..ops.bucketing import pad_oracle_batch
from ..ops.oracle import batch_top_k, find_max_group_host, repack_assignment_span
from ..utils.metrics import DEFAULT_REGISTRY

__all__ = [
    "CoalesceJob",
    "CoalesceResult",
    "CoalesceSaturated",
    "OracleCoalescer",
    "build_mega_batch",
    "coalesce_enabled",
    "coalesce_depth",
    "coalesce_mode",
    "coalesce_span_max",
    "coalesce_mega_cells",
    "coalesce_fair_halflife",
]


# ---------------------------------------------------------------------------
# env knobs (all parse-guarded — the BST_SCAN_WAVE idiom)
# ---------------------------------------------------------------------------

_env_warned = [False]


def coalesce_enabled() -> bool:
    """Parse-guarded BST_COALESCE read: default OFF (the single-scheduler
    deployment stays byte-identical); ``1``/``on`` enables the coalescer
    in front of the sidecar executor; unrecognised values warn once and
    keep the default."""
    raw = os.environ.get("BST_COALESCE", "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return False
    if raw in ("1", "on", "true", "yes"):
        return True
    if not _env_warned[0]:
        _env_warned[0] = True
        print(
            f"ignoring unrecognised BST_COALESCE={raw!r}; coalescing stays "
            "off",
            file=sys.stderr,
        )
    return False


def _int_knob(name: str, default: int, lo: int, hi: int) -> int:
    raw = os.environ.get(name, "").strip()
    if raw:
        try:
            return min(max(int(raw), lo), hi)
        except ValueError:
            pass
    return default


def coalesce_depth() -> int:
    """BST_COALESCE_DEPTH: bounded admission-queue depth (pending jobs
    across all tenants) before submits answer BUSY."""
    return _int_knob("BST_COALESCE_DEPTH", 64, 1, 4096)


def coalesce_span_max() -> int:
    """BST_COALESCE_SPAN_MAX: max tenant spans merged into one group."""
    return _int_knob("BST_COALESCE_SPAN_MAX", 8, 1, 64)


def coalesce_mega_cells() -> int:
    """BST_COALESCE_MEGA_CELLS: auto mode builds a block-diagonal
    mega-batch only while the merged G_tot*N_tot stays under this (the
    mega scan pays O(G_tot*N_tot*R); past this bound the per-span
    pipeline wins — the bench-coalesce measurement)."""
    return _int_knob("BST_COALESCE_MEGA_CELLS", 1 << 21, 1 << 10, 1 << 30)


def coalesce_mode() -> str:
    """BST_COALESCE_MODE: ``span`` | ``mega`` | ``auto`` (default)."""
    raw = os.environ.get("BST_COALESCE_MODE", "").strip().lower()
    if raw in ("span", "mega", "auto"):
        return raw
    return "auto"


def coalesce_fair_halflife() -> float:
    """BST_COALESCE_FAIR_HALFLIFE_S: decay half-life of the serviced-work
    share the DRF order consumes (seconds)."""
    raw = os.environ.get("BST_COALESCE_FAIR_HALFLIFE_S", "").strip()
    if raw:
        try:
            return min(max(float(raw), 0.1), 3600.0)
        except ValueError:
            pass
    return 10.0


# ---------------------------------------------------------------------------
# jobs and results
# ---------------------------------------------------------------------------


class CoalesceSaturated(RuntimeError):
    """The bounded admission queue is full — answered in-band as a BUSY
    frame (service.protocol), never a silent hang."""

    def __init__(self, retry_after_ms: int):
        super().__init__(
            f"coalescer queue saturated; retry after {retry_after_ms}ms"
        )
        self.retry_after_ms = int(retry_after_ms)


class CoalesceResult:
    """One tenant's demuxed outcome: the per-tenant O(G) host dict (equal
    to a dedicated sidecar's), a row view for ROW_REQ gathers in the
    tenant's own node space, the tenant's dedicated-equivalent padded
    audit args (when requested), and the timing split."""

    __slots__ = ("host", "rows", "queue_wait", "run_seconds", "audit_args")

    def __init__(self, host, rows, queue_wait, run_seconds, audit_args=None):
        self.host = host
        self.rows = rows
        self.queue_wait = queue_wait
        self.run_seconds = run_seconds
        self.audit_args = audit_args


class _RowView:
    """Lazy (G,N)-row gathers for one tenant span. ``gather`` issues the
    device read through the executor queue (the same total-order rule row
    requests always followed) and slices the row back into the tenant's
    node space."""

    __slots__ = ("_executor", "_device", "_goff", "_noff", "_n")

    def __init__(self, executor, device_result, goff: int, noff: int, n: int):
        self._executor = executor
        self._device = device_result
        self._goff = goff
        self._noff = noff
        self._n = n

    def gather(self, kind: str, gidx: int) -> np.ndarray:
        device = self._device
        goff, noff, n = self._goff, self._noff, self._n

        def _g():
            # on the executor thread, on its stream, after the batch that
            # wrote the row
            row = device[kind][goff + gidx][noff:noff + n]
            return row.cpu().numpy().astype("<i4")

        return self._executor.run(_g)


class CoalesceJob:
    """One pending tenant batch. ``padded_args``/``progress_args`` are the
    tenant's OWN canonically padded batch (host numpy for full requests;
    the device-resident mirror's tensors for wire deltas), ready for
    per-span dispatch. ``raw_fn`` lazily materialises the unpadded host
    arrays the mega merge concatenates (for mirror batches this is a
    device readback through the executor, paid only when a mega group
    actually forms)."""

    __slots__ = ("tenant", "wire_tenant", "n", "g", "r", "padded_args",
                 "progress_args", "raw_fn", "want_audit",
                 "enqueued", "_done", "_result", "_error")

    def __init__(self, tenant: str, n: int, g: int, r: int, padded_args,
                 progress_args, raw_fn: Callable[[], tuple],
                 want_audit: bool = False):
        # the DRF queue key: unannounced clients share the "other"
        # fairness bucket (the capacity observatory's overflow label, so
        # its weights apply); wire_tenant keeps the raw announcement for
        # scan-counter attribution — an unannounced client must label
        # "-" exactly as it does on the direct (non-coalescing) path
        self.tenant = tenant or "other"
        self.wire_tenant = tenant or None
        self.n = int(n)
        self.g = int(g)
        self.r = int(r)
        self.padded_args = padded_args
        self.progress_args = progress_args
        self.raw_fn = raw_fn
        self.want_audit = want_audit
        self.enqueued = time.perf_counter()
        self._done = threading.Event()
        self._result: Optional[CoalesceResult] = None
        self._error: Optional[BaseException] = None

    def finish(self, result=None, error: Optional[BaseException] = None):
        self._result, self._error = result, error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> CoalesceResult:
        if not self._done.wait(timeout):
            raise TimeoutError("coalesced batch still running")
        if self._error is not None:
            raise self._error
        return self._result

    def audit_copy(self):
        """The tenant's padded host args for the audit record. A mirror
        batch's args are device tensors, which only the executor thread
        may read: its caller makes its own host copies, and this answers
        None."""
        if not self.want_audit or any(
            not isinstance(a, np.ndarray) for a in self.padded_args
        ):
            return None
        return (
            tuple(np.asarray(a) for a in self.padded_args),
            tuple(np.asarray(a) for a in self.progress_args),
        )


# ---------------------------------------------------------------------------
# the block-diagonal merge (pure host side)
# ---------------------------------------------------------------------------


def build_mega_batch(raws):
    """Pure host-side block-diagonal merge of K tenants' raw (unpadded)
    oracle arrays — the mega lowering's concatenation + pad, factored out
    of the worker so the merge can be checked without an executor.

    ``raws`` is a list of 12-tuples in ScheduleRequest field order
    (alloc, requested, group_req, remaining, fit_mask, group_valid,
    order, min_member, scheduled, matched, ineligible, creation_rank);
    each tenant's n/g derive from its own array shapes. Returns
    ``(batch_args, progress_args, noffs, goffs)`` — the padded mega
    batch plus each tenant's node/gang offset for the demux. The fit
    mask is the block-diagonal construction: tenant i's gangs see ONLY
    tenant i's node rows — everything else stays False, so its capacity
    there is zero and its sub-scan carries exactly the leftover a
    dedicated run would."""
    ns = [int(np.asarray(r[0]).shape[0]) for r in raws]
    gs = [int(np.asarray(r[2]).shape[0]) for r in raws]
    n_tot, g_tot = sum(ns), sum(gs)
    noffs, goffs = [], []
    noff = goff = 0
    for n, g in zip(ns, gs):
        noffs.append(noff)
        goffs.append(goff)
        noff += n
        goff += g
    (alloc, requested, group_req, remaining, group_valid, order,
     min_member, scheduled, matched, ineligible, creation_rank) = (
        [], [], [], [], [], [], [], [], [], [], []
    )
    fit_mask = np.zeros((g_tot, n_tot), dtype=bool)
    for i, raw in enumerate(raws):
        (r_alloc, r_req, r_greq, r_rem, r_mask, r_valid, r_order,
         r_minm, r_sched, r_match, r_inel, r_rank) = raw
        alloc.append(np.asarray(r_alloc))
        requested.append(np.asarray(r_req))
        group_req.append(np.asarray(r_greq))
        remaining.append(np.asarray(r_rem))
        group_valid.append(np.asarray(r_valid))
        order.append(np.asarray(r_order, dtype=np.int32) + goffs[i])
        min_member.append(np.asarray(r_minm))
        scheduled.append(np.asarray(r_sched))
        matched.append(np.asarray(r_match))
        ineligible.append(np.asarray(r_inel))
        creation_rank.append(np.asarray(r_rank))
        mask = np.asarray(r_mask, dtype=bool)
        if mask.shape[0] == 1:
            mask = np.broadcast_to(mask, (gs[i], ns[i]))
        fit_mask[
            goffs[i]:goffs[i] + gs[i], noffs[i]:noffs[i] + ns[i]
        ] = mask[:gs[i], :ns[i]]
    batch_args, progress_args = pad_oracle_batch(
        alloc=np.concatenate(alloc, axis=0),
        requested=np.concatenate(requested, axis=0),
        group_req=np.concatenate(group_req, axis=0),
        remaining=np.concatenate(remaining, axis=0),
        fit_mask=fit_mask,
        group_valid=np.concatenate(group_valid, axis=0),
        order=np.concatenate(order, axis=0),
        min_member=np.concatenate(min_member, axis=0),
        scheduled=np.concatenate(scheduled, axis=0),
        matched=np.concatenate(matched, axis=0),
        ineligible=np.concatenate(ineligible, axis=0),
        creation_rank=np.concatenate(creation_rank, axis=0),
    )
    return batch_args, progress_args, noffs, goffs


# ---------------------------------------------------------------------------
# the coalescer
# ---------------------------------------------------------------------------


class OracleCoalescer:
    """Cross-client merge queue in front of a ``DeviceExecutor``.

    One worker thread owns group formation: it admits pending jobs in DRF
    order (see module docstring), merges up to ``span_max`` of them, and
    executes the group — per-span pipelined dispatches or one
    block-diagonal mega-batch — completing each job with its demuxed,
    dedicated-sidecar-identical result. Submission is bounded
    (:class:`CoalesceSaturated` -> BUSY).

    ``weights_fn`` supplies the capacity observatory's per-tenant
    dominant shares ({tenant: share in [0,1]}); None (or an empty answer)
    degrades to the serviced-work share alone.
    """

    def __init__(self, executor, weights_fn: Optional[Callable] = None,
                 depth: Optional[int] = None,
                 span_max: Optional[int] = None,
                 mode: Optional[str] = None,
                 mega_cells: Optional[int] = None,
                 registry=None):
        self._executor = executor
        self._weights_fn = weights_fn
        self.depth = depth if depth is not None else coalesce_depth()
        self.span_max = (
            span_max if span_max is not None else coalesce_span_max()
        )
        self.mode = mode if mode is not None else coalesce_mode()
        self.mega_cells = (
            mega_cells if mega_cells is not None else coalesce_mega_cells()
        )
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}  # guarded-by: _cv
        self._pending = 0  # guarded-by: _cv
        self._served: Dict[str, float] = {}  # guarded-by: _cv
        self._served_at = time.monotonic()  # guarded-by: _cv
        self._service_s = 0.05  # EWMA group service time; guarded-by: _cv
        self._stopped = False  # guarded-by: _cv
        self.groups_run = 0  # guarded-by: _cv
        self.mega_groups = 0  # guarded-by: _cv
        self.mega_failures = 0  # guarded-by: _cv
        reg = registry or DEFAULT_REGISTRY
        self._merged = reg.counter(
            "bst_coalesce_merged_batches_total",
            "Coalesced merge groups executed, by lowering (span = "
            "per-span pipelined re-dispatch; mega = one block-diagonal "
            "mega-batch)",
        )
        self._width = reg.histogram(
            "bst_coalesce_span_width",
            "Tenant spans per executed merge group (1 = nothing to merge "
            "with)",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64),
        )
        self._wait = reg.histogram(
            "bst_coalesce_queue_wait_seconds",
            "Per-request wait in the coalescer admission queue, by tenant "
            "(the DRF starvation bound's observable)",
        )
        self._busy = reg.counter(
            "bst_coalesce_busy_total",
            "Requests refused with BUSY because the bounded coalescer "
            "queue was saturated (the client retries after the hint)",
        )
        self._depth_gauge = reg.gauge(
            "bst_coalesce_queue_depth",
            "Jobs waiting in the coalescer admission queue",
        )
        self._mega_failed = reg.counter(
            "bst_coalesce_mega_failures_total",
            "Mega groups that failed and fell back to the span lowering",
        )
        self._thread = threading.Thread(
            target=self._loop, name="oracle-coalescer", daemon=True
        )
        self._thread.start()

    # -- submission ----------------------------------------------------------

    def _retry_after_ms_locked(self) -> int:  # lock-held: _cv
        # pending jobs drain span_max per group at the live group service
        # rate — tell the client roughly when a slot frees up
        groups_queued = max(self._pending // max(self.span_max, 1), 1)
        est = self._service_s * groups_queued
        return int(min(max(est * 1000.0, 25.0), 5000.0))

    def check_admission(self) -> None:
        """Raise :class:`CoalesceSaturated` if a submit right now would be
        refused. The delta wire path calls this BEFORE applying churned
        rows to its mirror, so a BUSY answer normally leaves the client's
        generation cursor valid for a plain retry (a fill-up between this
        check and the submit converges through DELTA_RESYNC -> keyframe)."""
        with self._cv:
            if self._stopped:
                raise RuntimeError("coalescer stopped")
            if self._pending >= self.depth:
                self._busy.inc()
                raise CoalesceSaturated(self._retry_after_ms_locked())

    def schedule(self, job: CoalesceJob) -> CoalesceResult:
        """Enqueue one tenant batch and block for its demuxed result.
        Raises :class:`CoalesceSaturated` (queue full — answer BUSY) or
        the batch's own execution error."""
        with self._cv:
            if self._stopped:
                raise RuntimeError("coalescer stopped")
            if self._pending >= self.depth:
                self._busy.inc()
                raise CoalesceSaturated(self._retry_after_ms_locked())
            self._queues.setdefault(job.tenant, deque()).append(job)
            self._pending += 1
            self._depth_gauge.set(float(self._pending))
            self._cv.notify()
        return job.wait()

    def stop(self, timeout: float = 30.0) -> bool:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout)
        # fail anything still queued: blocked waiters get an error, never
        # a hang (the executor-stop discipline)
        with self._cv:
            for q in self._queues.values():
                while q:
                    q.popleft().finish(
                        error=RuntimeError("coalescer stopped")
                    )
            self._pending = 0
        return not self._thread.is_alive()

    def stats(self) -> dict:
        with self._cv:
            return {
                "pending": self._pending,
                "groups_run": self.groups_run,
                "mega_groups": self.mega_groups,
                "mega_failures": self.mega_failures,
                "service_s_ewma": round(self._service_s, 6),
                "served_share": dict(self._served),
                "depth": self.depth,
                "span_max": self.span_max,
                "mode": self.mode,
            }

    # -- DRF admission order -------------------------------------------------

    def _decay_served_locked(self) -> None:  # lock-held: _cv
        now = time.monotonic()
        dt = now - self._served_at
        if dt <= 0:
            return
        factor = 0.5 ** (dt / coalesce_fair_halflife())
        for t in list(self._served):
            v = self._served[t] * factor
            if v < 1e-6:
                del self._served[t]
            else:
                self._served[t] = v
        self._served_at = now

    def _tenant_order_locked(self) -> List[str]:  # lock-held: _cv
        """Tenants with pending work, lowest dominant share first: the
        observatory's cluster share (weights_fn) plus this queue's
        decayed serviced-work fraction; ties break toward the oldest
        waiting head job (FIFO aging)."""
        self._decay_served_locked()
        weights: Dict[str, float] = {}
        if self._weights_fn is not None:
            try:
                weights = dict(self._weights_fn() or {})
            except Exception:  # noqa: BLE001 — fairness hint, never fatal
                weights = {}
        total = sum(self._served.values()) or 1.0
        out = []
        for tenant, q in self._queues.items():
            if not q:
                continue
            share = (
                self._served.get(tenant, 0.0) / total
                + float(weights.get(tenant, 0.0))
            )
            out.append((share, q[0].enqueued, tenant))
        out.sort()
        return [t for _, _, t in out]

    def _select_group_locked(self) -> List[CoalesceJob]:  # lock-held: _cv
        """Pop up to ``span_max`` jobs, round-robin over tenants in DRF
        order (one job per tenant per pass) — the pop order IS the
        deterministic admission order the mega concatenation uses."""
        order = self._tenant_order_locked()
        group: List[CoalesceJob] = []
        while len(group) < self.span_max:
            took = False
            for tenant in order:
                q = self._queues.get(tenant)
                if not q:
                    continue
                job = q.popleft()
                self._pending -= 1
                group.append(job)
                # charge the serviced work (scan cells ~ gangs x nodes)
                # at ADMISSION: the next selection already sees it
                self._served[tenant] = (
                    self._served.get(tenant, 0.0)
                    + float(job.g * max(job.n, 1))
                )
                took = True
                if len(group) >= self.span_max:
                    break
            if not took:
                break
        self._depth_gauge.set(float(self._pending))
        return group

    # -- the worker ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait(0.5)
                if self._stopped:
                    return
                group = self._select_group_locked()
            if not group:
                continue
            t0 = time.perf_counter()
            try:
                self._run_group(group)
            except BaseException as e:  # noqa: BLE001 — deliver, never die
                for job in group:
                    if not job._done.is_set():
                        job.finish(error=e)
            dt = time.perf_counter() - t0
            with self._cv:
                self.groups_run += 1
                self._service_s = 0.7 * self._service_s + 0.3 * dt

    def _run_group(self, group: List[CoalesceJob]) -> None:
        mode = self.mode
        use_mega = (
            len(group) > 1
            and mode != "span"
            and len({job.r for job in group}) == 1
            # audited jobs pin the span lowering: the audit record pairs
            # the tenant's padded args with the result arrays, and a
            # mega demux's arrays are sliced to the tenant's real span —
            # an offline replay of the padded args would stamp
            # padded-shape arrays and plan_digest (which hashes shapes)
            # could never match. Span IS the dedicated dispatch, so its
            # record replays bit-identically by construction.
            and not any(job.want_audit for job in group)
            and (
                mode == "mega"
                or sum(j.g for j in group) * sum(j.n for j in group)
                <= self.mega_cells
            )
        )
        if use_mega:
            try:
                self._run_mega(group)
                self._note_group("mega", group)
                return
            except Exception:  # noqa: BLE001 — mega is an optimisation:
                # any failure (pad overflow, shape trouble) falls back to
                # the per-span dispatch, which IS the dedicated path; it is
                # counted, so a fault on the card never hides behind it
                self._mega_failed.inc()
                with self._cv:
                    self.mega_failures += 1
                remaining = [j for j in group if not j._done.is_set()]
                if not remaining:
                    # every job already finished before the failure: the
                    # group still merged at its full width
                    self._note_group("mega", group)
                    return
                group = remaining
        self._run_span(group)
        self._note_group("span", group)

    def _note_group(self, mode: str, group: List[CoalesceJob]) -> None:
        self._merged.inc(mode=mode)
        self._width.observe(float(max(len(group), 1)))
        if mode == "mega":
            with self._cv:
                self.mega_groups += 1

    # -- span lowering: per-span pipelined re-dispatch -----------------------

    def _run_span(self, group: List[CoalesceJob]) -> None:
        submitted = []
        for job in group:
            try:
                ej = self._executor.submit_batch(
                    job.padded_args, job.progress_args,
                    tenant=job.wire_tenant,
                )
            except BaseException as e:  # noqa: BLE001
                job.finish(error=e)
                continue
            submitted.append((job, ej))
        for job, ej in submitted:
            try:
                host, batch = ej.wait()
            except BaseException as e:  # noqa: BLE001
                job.finish(error=e)
                continue
            wait_s = time.perf_counter() - job.enqueued - ej.run_seconds
            self._wait.observe(max(wait_s, 0.0), tenant=job.tenant)
            host = dict(host)
            tel = dict(host.get("telemetry") or {})
            tel["coalesce"] = {
                "mode": "span", "width": len(group), "tenant": job.tenant,
                # explicit per-request admission-queue wait: the gang
                # lifecycle ledger's sidecar_wait phase attribution
                # (rides TRACE_INFO back to the client's timeline)
                "queue_wait_seconds": round(max(wait_s, 0.0), 6),
            }
            host["telemetry"] = tel
            job.finish(
                result=CoalesceResult(
                    host=host,
                    rows=_RowView(self._executor, batch, 0, 0, job.n),
                    queue_wait=max(wait_s, 0.0),
                    run_seconds=ej.run_seconds,
                    audit_args=job.audit_copy(),
                )
            )

    # -- mega lowering: block-diagonal mega-batch ----------------------------

    def _run_mega(self, group: List[CoalesceJob]) -> None:
        raws = [job.raw_fn() for job in group]
        batch_args, progress_args, noffs, goffs = build_mega_batch(raws)
        # attribute the merged device batch to its widest span's tenant
        dominant = max(group, key=lambda j: j.g * max(j.n, 1)).wire_tenant
        host, batch, queue_wait, run_s = self._executor.run_batch(
            batch_args, progress_args, tenant=dominant,
        )
        mega_tel = dict(host.get("telemetry") or {})
        feas = np.asarray(host["gang_feasible"])
        placed = np.asarray(host["placed"])
        progress = np.asarray(host["progress"])
        a_nodes = np.asarray(host["assignment_nodes"])
        a_counts = np.asarray(host["assignment_counts"])
        for i, job in enumerate(group):
            g, n = job.g, job.n
            gs, ns = goffs[i], noffs[i]
            # the tenant's dedicated run would size its compact readback
            # from ITS padded shapes — re-derive identically
            # np.shape reads a device tensor's own shape; the remaining
            # column comes from the unpadded raw arrays (pad rows are zero)
            span_nb = int(np.shape(job.padded_args[0])[0])
            span_rem_max = int(np.asarray(raws[i][3]).max(initial=0))
            k = batch_top_k(span_nb, span_rem_max)
            t_nodes = np.zeros((g, k), dtype=np.int32)
            t_counts = np.zeros((g, k), dtype=np.int32)
            for gi in range(g):
                t_nodes[gi], t_counts[gi] = repack_assignment_span(
                    a_nodes[gs + gi], a_counts[gs + gi], ns, span_nb, k
                )
            best, exists, _prog = find_max_group_host(*job.progress_args)
            wait_s = time.perf_counter() - job.enqueued - run_s
            tel = dict(mega_tel)
            tel["coalesce"] = {
                "mode": "mega", "width": len(group), "tenant": job.tenant,
                "node_offset": ns, "gang_offset": gs,
                # per-request admission-queue wait (lifecycle sidecar_wait
                # attribution, the span path's contract)
                "queue_wait_seconds": round(max(wait_s, 0.0), 6),
            }
            host_t = {
                "gang_feasible": feas[gs:gs + g],
                "placed": placed[gs:gs + g],
                "progress": progress[gs:gs + g],
                "best": best,
                "best_exists": exists,
                "assignment_nodes": t_nodes,
                "assignment_counts": t_counts,
                "telemetry": tel,
            }
            self._wait.observe(max(wait_s, 0.0), tenant=job.tenant)
            job.finish(
                result=CoalesceResult(
                    host=host_t,
                    rows=_RowView(self._executor, batch, gs, ns, n),
                    queue_wait=max(wait_s, 0.0),
                    run_seconds=run_s,
                    audit_args=job.audit_copy(),
                )
            )
