"""Plugin factory: assembles the whole control plane around a framework
handle — the equivalent of the reference's ``New`` registration entry point
(reference pkg/scheduler/batch/batchscheduler.go:377-448 and
cmd/scheduler/main.go:28-36).

Wiring order mirrors the reference: clientset -> informers -> status cache
-> ScheduleOperation (with the ``scorer`` gate, the north star's
``--scorer=tpu`` flag) -> CRD auto-create -> ReconcileStatus thread ->
controller -> leader-gated controller runner.

The port of ``batch_scheduler_tpu/plugin/factory.py``. ``PluginConfig``
carries the port's ``device`` (``cuda`` by default: ``new_plugin_runtime``
raises on a machine without CUDA unless the config asks for ``cpu``),
which reaches the ``ScheduleOperation`` and its scorer, and
``oracle_compile_warmer`` its bucket warmer (``ops.bucketing``).
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..api import register
from ..cache.pg_cache import PGStatusCache
from ..client.apiserver import APIServer
from ..client.clientset import Clientset
from ..client.informers import SharedInformerFactory
from ..controller.controller import PodGroupController
from ..core.operation import ScheduleOperation
from ..ops.convert import resolve_device
from .batch_plugin import BatchSchedulingPlugin
from .gate import ALL_EXTENSION_POINTS, ExtensionPointGate
from .leader import InMemoryLease, try_run_controller

__all__ = ["PluginConfig", "PluginRuntime", "new_plugin_runtime"]


@dataclass
class PluginConfig:
    """Plugin args (reference Configuration, batchscheduler.go:71-75).
    ``max_schedule_minutes`` keeps the reference's minutes interpretation
    (batchscheduler.go:406)."""

    max_schedule_minutes: Optional[float] = None
    # "oracle" = the batched scorer on ``device`` (the --scorer=tpu gate);
    # "serial" = the reference-parity in-process path.
    scorer: str = "oracle"
    # where the oracle's batches run: "cuda" (the default; raises without
    # CUDA) or "cpu"
    device: str = "cuda"
    # Re-batch coalescing window for the oracle scorer (0 = re-batch on
    # every invalidation; >0 bounds batch rate under churn — denials are
    # already 20s-sticky so bounded staleness is inside existing semantics).
    min_batch_interval_seconds: float = 0.0
    # Re-batch on a daemon thread while serving the stale (but
    # known-complete) batch — takes the device round-trip off the
    # scheduling cycle's critical path (see OracleScorer.background_refresh).
    oracle_background_refresh: bool = False
    # Dispatch-ahead: speculatively pack + execute batch N+1 while the
    # control plane works against batch N; a later refresh publishes it
    # without a blocking device round-trip iff nothing changed since it
    # packed — bit-identical plans either way.
    oracle_dispatch_ahead: bool = False
    # Black-box flight data (utils.audit): an AuditLog instance recording
    # every published oracle batch — packed inputs + plan digest — to a
    # bounded on-disk ring for deterministic replay
    # (core.oracle_scorer.replay_audit_record). None = off.
    oracle_audit_log: Optional[object] = None
    # Sampled in-production identity audit: every Kth non-speculative
    # published batch re-verified bit-for-bit on the CPU rung
    # (utils.health.IdentityAuditor; mismatch => /debug/health breach).
    # 0 = off.
    oracle_identity_audit_every: int = 0
    # Policy engine config (policy.PolicyConfig): priority-tiered
    # preemption, affinity / spread scoring terms. None = read BST_POLICY
    # from the environment (empty = policies off, the exact pre-policy
    # paths).
    policy: Optional[object] = None
    controller_workers: int = 10
    leader_poll_seconds: float = 1.0
    lease_renew_seconds: float = 3.0
    # Extension points the plugin is enabled at (config-file surface,
    # reference batch_scheduler_config.json:7-36). Default: all — a superset
    # of the reference's shipped four (it omits filter/score; we keep score
    # on so node selection reads oracle ranks).
    enabled_points: frozenset = ALL_EXTENSION_POINTS
    controller_resync_seconds: float = 0.5
    identity: str = field(default_factory=socket.gethostname)
    # Bucket warmer (ops.bucketing.CompileWarmer): run one batch at each
    # (G, N) bucket shape adjacent to the live working set on a daemon
    # thread, so a bucket transition finds the kernel loaded and its plan
    # cached (ops.bucketing says what stays cold).
    oracle_compile_warmer: bool = False

    @property
    def max_schedule_seconds(self) -> Optional[float]:
        if self.max_schedule_minutes is None:
            return None
        return self.max_schedule_minutes * 60.0


class PluginRuntime:
    """Everything the factory assembled; owns background thread lifecycle."""

    def __init__(self, plugin, controller, lease, config, informers, operation):
        self.plugin = plugin
        self.controller = controller
        self.lease = lease
        self.config = config
        self.informers = informers
        self.operation = operation
        self._stop = threading.Event()
        self._leader_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.informers.start()
        self.plugin.start()
        # leader-election heartbeat: keep trying to hold (or take over) the
        # lease — the role upstream kube-scheduler's election loop plays for
        # the reference
        self._renew_thread = threading.Thread(
            target=self._renew_loop, name="lease-renew", daemon=True
        )
        self._renew_thread.start()
        self._leader_thread = threading.Thread(
            target=try_run_controller,
            args=(
                self.lease,
                self.config.identity,
                self.controller,
                self.config.controller_workers,
                self._stop,
                self.config.leader_poll_seconds,
            ),
            name="leader-gate",
            daemon=True,
        )
        self._leader_thread.start()

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.config.lease_renew_seconds):
            try:
                self.lease.acquire(self.config.identity)
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        self.plugin.stop()
        self.controller.stop()
        self.informers.stop()
        oracle = getattr(self.operation, "oracle", None)
        if oracle is not None:
            # let any in-flight background or speculative batch finish
            # (and a banked one be collected) before the process can go
            # away; a timed-out join means teardown would still race a
            # CUDA call, so keep waiting with escalating patience
            drain = getattr(oracle, "drain_background", None)
            if drain is not None:
                for timeout in (60.0, 120.0, 120.0):
                    if drain(timeout) is not False:
                        break


def new_plugin_runtime(
    api: APIServer,
    handle,
    config: Optional[PluginConfig] = None,
    lease=None,
    clock=None,
    informers: Optional[SharedInformerFactory] = None,
) -> PluginRuntime:
    """Build plugin + controller + leader gate over an API server and a
    framework handle. ``handle.cluster`` is the snapshot provider.

    Pass ``informers`` to share one factory (and thus ONE watch stream +
    typed rehydration per event per kind) with the embedding framework —
    a second factory doubles every pod event's dispatch cost."""
    config = config or PluginConfig()
    # the port's device rule: "cuda" raises here on a machine without it
    device = resolve_device(config.device)
    pg_client = Clientset(api)

    if informers is None:
        informers = SharedInformerFactory(api)
    pg_informer = informers.pod_groups()
    lister = informers.pod_group_lister()

    pg_cache = PGStatusCache()

    kwargs = {} if clock is None else {"clock": clock}
    operation = ScheduleOperation(
        status_cache=pg_cache,
        cluster=handle.cluster,
        pg_client=pg_client,
        max_schedule_seconds=config.max_schedule_seconds,
        # compare runs per heap comparison — use the informer's cached
        # typed view (read-only) instead of rebuilding objects per call
        pg_lister=pg_informer.get_typed,
        scorer=config.scorer,
        min_batch_interval=config.min_batch_interval_seconds,
        background_refresh=config.oracle_background_refresh,
        dispatch_ahead=config.oracle_dispatch_ahead,
        compile_warmer=config.oracle_compile_warmer,
        device=device,
        audit_log=config.oracle_audit_log,
        identity_audit_every=config.oracle_identity_audit_every,
        policy=config.policy,
        **kwargs,
    )

    plugin = BatchSchedulingPlugin(
        handle=handle,
        operation=operation,
        pg_client=pg_client,
        max_schedule_seconds=config.max_schedule_seconds,
    )
    if frozenset(config.enabled_points) != ALL_EXTENSION_POINTS:
        plugin = ExtensionPointGate(plugin, config.enabled_points)

    # CRD auto-create, ignoring AlreadyExists (reference :416-436)
    api.ensure_crd(
        register.CRD_NAME,
        {
            "group": register.GROUP_NAME,
            "version": register.VERSION,
            "kind": register.KIND_POD_GROUP,
            "plural": register.PLURAL_POD_GROUPS,
            "short_names": list(register.SHORT_NAMES),
            "scope": "Namespaced",
        },
    )

    controller = PodGroupController(
        client=pg_client,
        pg_informer=pg_informer,
        pod_informer=informers.informer("Pod"),
        pg_cache=pg_cache,
        reject_pod=plugin.reject_pod,
        add_to_backoff=operation.add_to_deny_cache,
        max_schedule_seconds=config.max_schedule_seconds,
        resync_seconds=config.controller_resync_seconds,
        **kwargs,
    )

    if lease is None:
        lease = InMemoryLease()
        lease.acquire(config.identity)  # single-replica default: we lead

    return PluginRuntime(plugin, controller, lease, config, informers, operation)
