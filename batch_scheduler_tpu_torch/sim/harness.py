"""SimCluster: the full framework wired over a simulated cluster.

Composes API server + informers + ClusterState + Scheduler + plugin runtime
(operation/controller/leader gate) + SimKubelet into one in-process system —
the test/bench harness standing in for a real Kubernetes deployment, sized
for anything from the README race demo to 10k pods / 5k nodes.

The port of ``batch_scheduler_tpu/sim/harness.py``: ``device`` ("cuda" by
default, raising without it; "cpu" in tests) reaches the oracle through
``PluginConfig``; the API server is the in-memory one (or any object with
its interface passed as ``api``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api.types import Node, Pod, PodGroup, PodGroupPhase, PodPhase, to_dict
from ..client.apiserver import APIServer
from ..client.clientset import Clientset
from ..client.informers import SharedInformerFactory
from ..framework.cluster import ClusterState
from ..framework.scheduler import Scheduler
from ..plugin.factory import PluginConfig, new_plugin_runtime
from ..utils.labels import POD_GROUP_LABEL
from .kubelet import SimKubelet

__all__ = ["SimCluster", "drive_multi_client", "wait_p95"]


def wait_p95(xs):
    """p95 by sorted index over a non-empty sample list: the one copy of
    the percentile convention the multi-client report uses."""
    xs = sorted(xs)
    return xs[min(int(len(xs) * 0.95), len(xs) - 1)]


def drive_multi_client(
    addr: str,
    clients: int = 8,
    batches: int = 8,
    nodes: int = 256,
    gangs: int = 32,
    concurrent: bool = True,
    seed: int = 0,
    deadline_ms: Optional[int] = None,
    tenant_batches: Optional[Dict[str, int]] = None,
    client_kwargs: Optional[Dict] = None,
    on_batch: Optional[Callable[[str, int], None]] = None,
):
    """Drive K scheduler clients' oracle request streams through ONE
    sidecar — the coalescer acceptance harness.

    Each client is a ResilientOracleClient with its own tenant label
    (``tenant-<i>``) replaying the deterministic
    ``sim.scenarios.tenant_oracle_stream`` for that tenant.
    ``concurrent=True`` runs every client on its own thread (the
    coalesced deployment); ``False`` runs them strictly one request at a
    time in round-robin (the "K dedicated sidecars, time-sliced over one
    device" equivalent — same total device work, no overlap). The same
    (clients, batches, nodes, gangs, seed) always replays the same
    streams, so per-tenant plan digests compare across deployments.

    ``tenant_batches`` overrides the per-tenant batch count (whale
    scenarios: {"tenant-0": 64} floods tenant 0 while the rest stay at
    ``batches``).

    ``addr`` may be a comma list (``"h1:p1,h2:p2"``) — each client then
    gets the whole warm-standby pool and promotes on DRAINING /
    breaker-open. ``client_kwargs`` forwards
    extra ResilientOracleClient options (the gate tightens
    retry/breaker budgets so a crash promotes within one call; callable
    values are invoked per client — pass a CircuitBreaker FACTORY, not a
    shared instance);
    ``on_batch(tenant, index)`` observes each completed request (the
    gate's mid-storm kill trigger).

    Returns ``{tenant: {"digests": [...], "waits": [...], "busy": int}}``
    plus a ``"_wall_s"`` entry with the run's wall-clock."""
    import numpy as np

    from ..service.client import ResilientOracleClient
    from ..utils import audit as audit_mod
    from ..utils.errors import OracleBusyError
    from .scenarios import tenant_oracle_stream

    def digest(resp) -> str:
        return audit_mod.plan_digest(
            {
                "gang_feasible": np.asarray(resp.gang_feasible),
                "placed": np.asarray(resp.placed),
                "progress": np.asarray(resp.progress),
                "best": int(resp.best),
                "best_exists": bool(resp.best_exists),
                "assignment_nodes": np.asarray(resp.assignment_nodes),
                "assignment_counts": np.asarray(resp.assignment_counts),
            }
        )

    labels = [f"tenant-{i}" for i in range(clients)]
    streams = {
        labels[i]: tenant_oracle_stream(
            i,
            (tenant_batches or {}).get(labels[i], batches),
            nodes=nodes,
            gangs=gangs,
            seed=seed,
        )
        for i in range(clients)
    }
    out: Dict[str, Dict] = {
        t: {"digests": [], "waits": [], "busy": 0} for t in labels
    }
    def _client_kwargs() -> Dict:
        # callable values are invoked PER CLIENT — a CircuitBreaker is
        # stateful, so the failover gate passes a factory rather than
        # sharing one instance across every tenant's connection
        return {
            k: (v() if callable(v) else v)
            for k, v in (client_kwargs or {}).items()
        }

    conns = {
        t: ResilientOracleClient(
            addr, deadline_ms=deadline_ms, name=t, **_client_kwargs()
        )
        for t in labels
    }

    def run_one(tenant: str, req, index: int = 0) -> None:
        t0 = time.perf_counter()
        try:
            resp = conns[tenant].schedule(req, tenant=tenant)
        except OracleBusyError:
            # retries exhausted while saturated: count it and move on —
            # the harness measures the bound, it does not crash on it
            out[tenant]["busy"] += 1
            return
        out[tenant]["waits"].append(time.perf_counter() - t0)
        out[tenant]["digests"].append(digest(resp))
        if on_batch is not None:
            on_batch(tenant, index)

    wall0 = time.perf_counter()
    if concurrent:
        import threading

        def run_tenant(tenant: str) -> None:
            for i, req in enumerate(streams[tenant]):
                run_one(tenant, req, i)

        threads = [
            threading.Thread(
                target=run_tenant, args=(t,), name=f"mc-{t}", daemon=True
            )
            for t in labels
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    else:
        # the time-sliced dedicated equivalent: one request in flight
        # EVER, round-robin across tenants (one device, K sidecars that
        # each get the device serially)
        cursors = {t: 0 for t in labels}
        live = set(labels)
        while live:
            for t in list(labels):
                if t not in live:
                    continue
                i = cursors[t]
                if i >= len(streams[t]):
                    live.discard(t)
                    continue
                run_one(t, streams[t][i], i)
                cursors[t] = i + 1
    wall = time.perf_counter() - wall0
    for conn in conns.values():
        conn.close()
    result: Dict = dict(out)
    result["_wall_s"] = wall
    return result


class SimCluster:
    def __init__(
        self,
        scorer: str = "oracle",
        max_schedule_minutes: Optional[float] = None,
        kubelet_start_delay: float = 0.02,
        kubelet_run_duration: Optional[float] = None,
        fail_pod: Optional[Callable[[str], bool]] = None,
        bind_workers: int = 8,
        backoff_base: float = 0.2,
        backoff_cap: float = 2.0,
        controller_resync_seconds: float = 0.1,
        enabled_points=None,
        min_batch_interval: float = 0.0,
        oracle_background_refresh: bool = False,
        oracle_dispatch_ahead: bool = False,
        oracle_compile_warmer: bool = False,
        audit_log=None,
        identity_audit_every: int = 0,
        policy=None,
        api=None,
        device="cuda",
    ):
        # ``api``: any APIServer-interface implementation (the whole stack
        # runs against it instead of the in-memory server; an HTTPAPIServer
        # runs it over a k8s-shaped endpoint)
        self.api = api if api is not None else APIServer()
        self.clientset = Clientset(self.api)
        self.cluster = ClusterState()

        kwargs = {} if enabled_points is None else {"enabled_points": frozenset(enabled_points)}
        config = PluginConfig(
            scorer=scorer,
            max_schedule_minutes=max_schedule_minutes,
            controller_resync_seconds=controller_resync_seconds,
            min_batch_interval_seconds=min_batch_interval,
            oracle_background_refresh=oracle_background_refresh,
            oracle_dispatch_ahead=oracle_dispatch_ahead,
            oracle_compile_warmer=oracle_compile_warmer,
            oracle_audit_log=audit_log,
            oracle_identity_audit_every=identity_audit_every,
            # policy engine config (policy.PolicyConfig); None reads
            # BST_POLICY from the environment
            policy=policy,
            device=device,
            **kwargs,
        )
        self.runtime = None

        # framework informers: nodes + pods feed ClusterState and the queue;
        # shared with the plugin runtime so each event dispatches once
        self._fwk_informers = SharedInformerFactory(self.api)

        def plugin_factory(handle):
            self.runtime = new_plugin_runtime(
                self.api, handle, config, informers=self._fwk_informers
            )
            return self.runtime.plugin
        self.scheduler = Scheduler(
            self.clientset,
            self.cluster,
            plugin_factory=plugin_factory,
            bind_workers=bind_workers,
            backoff_base=backoff_base,
            backoff_cap=backoff_cap,
            pod_informer=self._fwk_informers.informer("Pod"),
            device=device,
        )
        self.kubelet = SimKubelet(
            self.api,
            start_delay=kubelet_start_delay,
            run_duration=kubelet_run_duration,
            fail_pod=fail_pod,
        )

        self._fwk_informers.informer("Node").add_event_handler(
            on_add=self.cluster.add_node,
            on_update=lambda old, new: self.cluster.update_node(new),
            on_delete=lambda n: self.cluster.remove_node(n.metadata.name),
        )
        # all Pod events ride the raw fast path: ADDED seeds the queue with
        # a lazy entry (typed pod materialises on the scheduling thread),
        # bind commits and kubelet phase flips are ~3 MODIFIED events per
        # pod and never need typed rehydration (observe_pod_raw)
        self._fwk_informers.informer("Pod").add_event_handler(
            on_add=self._pod_added_raw,
            on_update=lambda old, new: self.cluster.observe_pod_raw(new),
            on_delete=self.cluster.remove_pod_raw,
            raw=True,
        )
        self._started = False

    def _pod_added_raw(self, d: dict) -> None:
        if (d.get("spec") or {}).get("node_name"):
            self.cluster.observe_pod_raw(d)
        else:
            self.scheduler.enqueue_raw(d)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._fwk_informers.start()
        self.runtime.start()
        self.kubelet.start()
        self._fwk_informers.wait_for_cache_sync()
        self.runtime.informers.wait_for_cache_sync()
        self._wait_for_status_cache()
        self.scheduler.start()

    def _wait_for_status_cache(self, timeout: float = 10.0) -> None:
        """Block until the leader-gated controller has synced every
        already-created PodGroup into the gang status cache — the analog of
        kube-scheduler's WaitForCacheSync barrier. Without it the first
        scheduling cycles race the controller's lease acquisition (~1s poll)
        and burn pod backoff attempts on PodGroupNotFound."""
        want = {
            f"{pg['metadata']['namespace']}/{pg['metadata']['name']}"
            for pg in self.api.list("PodGroup")
        }
        if not want:
            return
        cache = self.runtime.operation.status_cache
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(cache.get(name) is not None for name in want):
                return
            time.sleep(0.01)

    def stop(self) -> None:
        self.scheduler.stop()
        self.kubelet.stop()
        self.runtime.stop()
        self._fwk_informers.stop()

    # -- populate ----------------------------------------------------------

    def add_nodes(self, nodes: List[Node]) -> None:
        create_many = getattr(self.api, "create_many", None)
        if create_many is not None:
            docs = []
            for node in nodes:
                d = to_dict(node)
                d.setdefault("metadata", {})["namespace"] = ""  # cluster-scoped
                docs.append(d)
            create_many("Node", docs, assume_fresh=True)
            return
        for node in nodes:
            self.clientset.nodes().create(node)

    def create_group(self, pg: PodGroup) -> PodGroup:
        return self.clientset.podgroups(pg.metadata.namespace).create(pg)

    def create_pods(self, pods: List[Pod]) -> None:
        # bulk ingest when the API supports it: load generation must not
        # serialize on per-pod response copies it never reads
        create_many = getattr(self.api, "create_many", None)
        if create_many is not None:
            create_many(
                "Pod", [to_dict(pod) for pod in pods], assume_fresh=True
            )
            return
        for pod in pods:
            self.clientset.pods(pod.metadata.namespace).create(pod)

    def create_pod_docs(self, docs: List[dict]) -> None:
        """Raw-dict bulk ingest: the caller already serialized the
        documents (load-generator-side work — a real client ships JSON it
        built on its own clock). The store takes ownership
        (assume_fresh); the docs must not be retained by the caller."""
        create_many = getattr(self.api, "create_many", None)
        if create_many is not None:
            create_many("Pod", docs, assume_fresh=True)
            return
        # fallback (e.g. HTTP API without the bulk verb): rehydrate — the
        # typed clientset serializes dataclasses, not raw dicts
        from ..api.serde import pod_from_dict

        for d in docs:
            pod = pod_from_dict(d)
            self.clientset.pods(pod.metadata.namespace).create(pod)

    # -- observation -------------------------------------------------------

    def group(self, name: str, namespace: str = "default") -> PodGroup:
        return self.clientset.podgroups(namespace).get(name)

    def group_phase(self, name: str, namespace: str = "default") -> PodGroupPhase:
        return self.group(name, namespace).status.phase

    def member_pods(self, group: str, namespace: str = "default") -> List[Pod]:
        return self.clientset.pods(namespace).list(
            label_selector={POD_GROUP_LABEL: group}
        )

    def bound_member_counts(self) -> Dict[Tuple[str, str], int]:
        """(namespace, gang) -> its member pods bound to a node, for every
        gang at once (``len`` of ``member_pods`` with a node, per gang).
        The in-memory server answers in one pass over its store; any other
        ``APIServer``-interface object (an ``HTTPAPIServer``) with one LIST
        of the pods."""
        by_label = getattr(self.api, "bound_pods_by_label", None)
        if by_label is not None:
            return by_label(POD_GROUP_LABEL)
        out: Dict[Tuple[str, str], int] = {}
        for doc in self.api.list("Pod"):
            meta = doc.get("metadata") or {}
            value = (meta.get("labels") or {}).get(POD_GROUP_LABEL)
            if value is not None and (doc.get("spec") or {}).get("node_name"):
                key = (meta.get("namespace", "default"), value)
                out[key] = out.get(key, 0) + 1
        return out

    def member_phase_counts(self, group: str, namespace: str = "default") -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for pod in self.member_pods(group, namespace):
            phase = pod.status.phase.value if pod.spec.node_name else "Unscheduled"
            counts[phase] = counts.get(phase, 0) + 1
        return counts

    def decisions(self, group: Optional[str] = None) -> Dict[str, list]:
        """The gang decision flight recorder's records (utils.trace):
        why a gang was placed/denied/parked, with blame reasons and the
        device evidence — the harness-side view of /debug/decisions.
        ``group`` may be "name" (default namespace assumed) or
        "namespace/name"."""
        from ..utils.trace import DEFAULT_FLIGHT_RECORDER

        if group is not None and "/" not in group:
            group = f"default/{group}"
        return DEFAULT_FLIGHT_RECORDER.snapshot(group)

    def health(self) -> Dict:
        """The live SLO health model's verdict (utils.health) — the
        harness-side view of /debug/health, so tests and gates can assert
        ok/warn/breach without standing up the metrics endpoint."""
        from ..utils.health import DEFAULT_HEALTH

        return DEFAULT_HEALTH.evaluate()

    def explain(self, group: str) -> Dict:
        """Why is this gang pending (core.explain) — the harness-side
        view of /debug/explain. ``group`` may be "name" (default
        namespace assumed) or "namespace/name"."""
        from ..core.explain import active_observatory

        if "/" not in group:
            group = f"default/{group}"
        obs = active_observatory()
        if obs is None:
            return {"error": "no observatory (oracle mode required)"}
        return obs.explain(group)

    def capacity(self) -> Dict:
        """The capacity observatory's report (ops.capacity) — the
        harness-side view of /debug/capacity: last summary, downsampled
        series, sampler counters."""
        from ..ops.capacity import capacity_debug_view

        payload, _status = capacity_debug_view()
        return payload

    def whatif(self, counterfactual: Dict, rung: str = "steady") -> Dict:
        """Score one counterfactual against live cluster state on a
        forked device-state buffer (core.explain) — the harness-side view
        of /debug/whatif. ``counterfactual`` is the canonical dict form
        (e.g. ``{"kind": "drain", "node": "sim-node-0000"}``)."""
        from ..core.explain import active_observatory

        obs = active_observatory()
        if obs is None:
            return {"error": "no observatory (oracle mode required)"}
        return obs.whatif(dict(counterfactual), rung=rung)

    def wait_for(
        self,
        predicate: Callable[[], bool],
        timeout: float = 15.0,
        interval: float = 0.05,
    ) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(interval)
        return predicate()

    def wait_for_group_phase(
        self,
        name: str,
        phases,
        timeout: float = 15.0,
        namespace: str = "default",
    ) -> bool:
        if isinstance(phases, PodGroupPhase):
            phases = (phases,)
        return self.wait_for(
            lambda: self.group_phase(name, namespace) in phases, timeout
        )

    def wait_for_bound(self, group: str, count: int, timeout: float = 15.0) -> bool:
        return self.wait_for(
            lambda: sum(1 for p in self.member_pods(group) if p.spec.node_name)
            >= count,
            timeout,
        )
