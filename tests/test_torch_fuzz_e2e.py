"""The port's whole stack under transport faults and a control-plane outage,
on the CPU: ``tests/test_fuzz_e2e.py``'s chaos case (a remote oracle on the
port's sidecar behind ``sim.chaos.ChaosProxy``, with the resilient client
and the conservative local-CPU fallback) and its selector / churn / outage
composition over the port's HTTP gateway (its three seeds parametrised).
The generators are the reference's, seeded with numpy, and the invariants
are the reference's: no node over-committed (judged from the API server's
store), gang atomicity, feasibility honesty, liveness, zone placement.
Each invariant is exact."""

import time

import numpy as np
import pytest

from batch_scheduler_tpu_torch.api.quantity import parse_quantity
from batch_scheduler_tpu_torch.api.types import PodPhase
from batch_scheduler_tpu_torch.sim import (
    SimCluster,
    make_member_pods,
    make_sim_group,
    make_sim_node,
)


@pytest.fixture
def sim():
    clusters = []

    def build(**kwargs):
        c = SimCluster(device="cpu", **kwargs)
        clusters.append(c)
        return c

    yield build
    for c in clusters:
        c.stop()


def _assert_no_overcommit(cluster):
    nodes = {n.metadata.name: n for n in cluster.clientset.nodes().list()}
    used = {name: {} for name in nodes}
    for pod in cluster.clientset.pods().list():
        node = pod.spec.node_name
        if not node:
            continue
        if pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
            continue  # terminal pods release their requests
        assert node in nodes, f"pod {pod.metadata.name} bound to ghost {node}"
        u = used[node]
        for k, v in pod.resource_require().items():
            u[k] = u.get(k, 0) + v
        u["pods"] = u.get("pods", 0) + 1
    for name, u in used.items():
        alloc = nodes[name].status.allocatable
        for k, v in u.items():
            have = int(parse_quantity(alloc.get(k, 0)))
            assert v <= have, f"node {name} over-committed on {k}: {v} > {have}"


def _fuzz_scenario(sim, seed, **cluster_kwargs):
    """The reference's randomized scenario (same numpy draws)."""
    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(8, 24))
    node_cpus = rng.choice([4, 8, 16], size=n_nodes)
    nodes = [
        make_sim_node(f"fz-n{i:03d}",
                      {"cpu": str(int(c)), "memory": f"{int(c) * 4}Gi", "pods": "110"})
        for i, c in enumerate(node_cpus)
    ]
    total_cpu = int(node_cpus.sum())
    max_node_cpu = int(node_cpus.max())
    cluster_kwargs.setdefault("scorer", "oracle")
    cluster = sim(max_schedule_minutes=0.05, backoff_base=0.1, backoff_cap=0.5,
                  **cluster_kwargs)
    cluster.add_nodes(nodes)
    feasible, infeasible, pod_batches = [], [], []
    budget = total_cpu * 0.6
    n_gangs = int(rng.integers(10, 25))
    for g in range(n_gangs):
        members = int(rng.integers(2, 6))
        prio = int(rng.integers(0, 3))
        if rng.random() < 0.2:
            cpu = max_node_cpu + int(rng.integers(1, 4))
            name = f"fz-bad-{g:03d}"
            infeasible.append((name, members))
        else:
            cpu = int(rng.integers(1, 4))
            if budget - members * cpu < 0:
                continue
            budget -= members * cpu
            name = f"fz-ok-{g:03d}"
            feasible.append((name, members))
        cluster.create_group(
            make_sim_group(name, members, creation_ts=time.time() - (n_gangs - g) * 1e-3))
        pod_batches.append(make_member_pods(name, members, {"cpu": str(cpu)}, priority=prio))
    loose = make_member_pods("fz-loose", int(rng.integers(3, 8)), {"cpu": "1"})
    for p in loose:
        p.metadata.labels = {}
    pod_batches.append(loose)
    cluster.start()
    for i in rng.permutation(len(pod_batches)):
        cluster.create_pods(pod_batches[int(i)])
    return cluster, feasible, infeasible, len(loose)


def test_fuzz_full_framework_invariants_with_chaos_faults(sim):
    """The standing invariants with transport faults throughout: the
    oracle is the port's sidecar behind a chaos proxy drizzling delayed,
    reset, truncated and garbage frames, absorbed by the resilient client
    and the local-CPU fallback. The feasible set binds fully, gangs stay
    atomic, nothing over-commits, and the proxy really injected."""
    from batch_scheduler_tpu_torch.service import (
        RemoteScorer,
        ResilientOracleClient,
        serve_background,
    )
    from batch_scheduler_tpu_torch.sim.chaos import ChaosProxy
    from batch_scheduler_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy

    srv = serve_background(device="cpu")
    proxy = ChaosProxy(*srv.address, seed=909)
    proxy.set_fault({"delay": 0.15, "reset": 0.04, "truncate": 0.03, "garbage": 0.03},
                    delay_s=0.03, hang_s=1.0)
    client = ResilientOracleClient(
        *proxy.address, timeout=5.0,
        retry_policy=RetryPolicy(max_attempts=4, base_delay=0.02, max_delay=0.2),
        breaker=CircuitBreaker(failure_threshold=4, reset_timeout=0.3),
    )
    scorer = RemoteScorer(client, fallback="local-cpu")
    try:
        cluster, feasible, infeasible, n_loose = _fuzz_scenario(sim, 909, scorer=scorer)
        expected = sum(m for _, m in feasible) + n_loose
        assert cluster.wait_for(lambda: cluster.scheduler.stats["binds"] >= expected,
                                timeout=120.0, interval=0.2), (
            "feasible work never fully bound under chaos faults", expected,
            cluster.scheduler.stats, proxy.injected_counts())
        _assert_no_overcommit(cluster)
        for name, members in feasible:
            bound = [p for p in cluster.member_pods(name) if p.spec.node_name]
            assert len(bound) >= members, (name, len(bound), members)
        for name, members in infeasible:
            bound = [p for p in cluster.member_pods(name) if p.spec.node_name]
            assert bound == [], f"infeasible gang {name} bound {len(bound)} pods"
        assert sum(proxy.injected_counts().values()) > 0
    finally:
        scorer.close()
        proxy.stop()
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("seed", [613, 724, 835])
def test_fuzz_combo_selector_churn_outage(sim, seed):
    """Zone selectors, capacity churn, gang-TTL aborts and a mid-run
    gateway outage that severs every kept-alive connection, all over the
    port's HTTP stack (throttles off). The invariants are judged from the
    backing store: feasible gangs fully bound, infeasible ones never,
    no over-commit, zone-pinned members only inside their zone."""
    from batch_scheduler_tpu_torch.client import APIServer, HTTPAPIServer, serve_gateway

    rng = np.random.default_rng(seed)
    zones = ["za", "zb"]
    backing = APIServer()
    server = serve_gateway(backing)
    host, port = server.server_address[:2]
    api = HTTPAPIServer(host, port, qps=0)
    cluster = None
    try:
        n_nodes = int(rng.integers(8, 14))
        node_zone = [zones[int(rng.integers(0, len(zones)))] for _ in range(n_nodes)]
        zone_budget = {z: 0.0 for z in zones}
        nodes = []
        for i, z in enumerate(node_zone):
            cpu = int(rng.choice([4, 8]))
            zone_budget[z] += cpu * 0.6
            nodes.append(make_sim_node(
                f"cb-n{i:03d}", {"cpu": str(cpu), "memory": f"{cpu * 4}Gi", "pods": "110"},
                labels={"zone": z}))
        cluster = sim(scorer="oracle", api=api, max_schedule_minutes=0.05,
                      kubelet_run_duration=1.5, backoff_base=0.1, backoff_cap=0.5,
                      oracle_background_refresh=True, min_batch_interval=0.2)
        cluster.add_nodes(nodes)
        feasible, infeasible, pod_batches = [], [], []
        gang_zone = {}
        now = time.time()
        n_gangs = int(rng.integers(8, 14))
        for g in range(n_gangs):
            members = int(rng.integers(2, 5))
            cpu = int(rng.integers(1, 3))
            zone = zones[int(rng.integers(0, len(zones)))] if rng.random() < 0.6 else None
            if rng.random() < 0.2:
                name = f"cb-bad-{g:03d}"
                selector = {"zone": "nowhere"}
                infeasible.append((name, members))
            else:
                if zone is not None:
                    if zone_budget[zone] < members * cpu:
                        continue
                    zone_budget[zone] -= members * cpu
                else:
                    best = max(zone_budget, key=zone_budget.get)
                    if zone_budget[best] < members * cpu:
                        continue
                    zone_budget[best] -= members * cpu
                name = f"cb-ok-{g:03d}"
                selector = {"zone": zone} if zone else None
                feasible.append((name, members))
            if selector and "nowhere" not in selector.values():
                gang_zone[name] = selector["zone"]
            cluster.create_group(make_sim_group(name, members,
                                                creation_ts=now - (n_gangs - g) * 1e-3))
            pod_batches.append(make_member_pods(name, members, {"cpu": str(cpu)},
                                                node_selector=selector))
        assert feasible, "generator produced no feasible gangs"
        cluster.start()
        for i in rng.permutation(len(pod_batches)):
            cluster.create_pods(pod_batches[int(i)])

        expected = sum(m for _, m in feasible)
        assert cluster.wait_for(
            lambda: cluster.scheduler.stats["binds"] >= max(1, expected // 3),
            timeout=60.0, interval=0.05,
        ), ("stalled before the outage", cluster.scheduler.stats)
        server.shutdown()
        server.server_close()
        time.sleep(0.3)
        server = serve_gateway(backing, host, port)

        def feasible_bound_in_store() -> bool:
            bound = {d["metadata"]["name"] for d in backing.list("Pod")
                     if (d.get("spec") or {}).get("node_name")}
            return all(sum(1 for b in bound if b.startswith(f"{name}-")) >= members
                       for name, members in feasible)

        assert cluster.wait_for(feasible_bound_in_store, timeout=90.0, interval=0.25), (
            "feasible work never fully bound", cluster.scheduler.stats)
        _assert_no_overcommit(cluster)
        nodes_by_name = {n.metadata.name: n for n in nodes}
        bound_by_gang = {}
        for d in backing.list("Pod"):
            if not (d.get("spec") or {}).get("node_name"):
                continue
            gang = d["metadata"]["name"].rsplit("-", 1)[0]
            bound_by_gang.setdefault(gang, []).append(d)
        for name, _ in infeasible:
            assert name not in bound_by_gang, f"infeasible gang {name} bound pods"
        for name, members in feasible:
            assert len(bound_by_gang.get(name, [])) >= members, name
        for name, docs in bound_by_gang.items():
            zone = gang_zone.get(name)
            if zone is None:
                continue
            for d in docs:
                node = nodes_by_name[d["spec"]["node_name"]]
                assert node.metadata.labels.get("zone") == zone, (name, node.metadata.name)
        # the whole-gang poll works over the wire and agrees with the store
        counts = cluster.bound_member_counts()
        for name, docs in bound_by_gang.items():
            assert counts.get(("default", name), 0) >= 1, (name, counts)
    finally:
        if cluster is not None:
            try:
                cluster.stop()
            except Exception:  # noqa: BLE001 — teardown of a failed run
                pass
        api.close()
        server.shutdown()
        server.server_close()
