"""The port's chaos proxy (``sim/chaos.py``) and its resilient oracle link
against the JAX package's, on the CPU: ``tests/test_chaos_oracle.py``
mirrored against the port's sidecar (``serve_background(device="cpu")``).
Every fault class the proxy injects (reset, hang, delay, truncate,
garbage) is survived by ``ResilientOracleClient``; reconnects make old
batch rows stale; the breaker's lifecycle; both deadline cases; both
fallback modes; dropped and duplicated wire-delta frames; a kill
mid-delta-stream with failover; a drain during a coalesced mega batch;
failover racing a half-open probe. Every plan that comes back through the
proxy equals the JAX sidecar's for the same request, and the wire-delta
cases hold the remote scorer's plans equal to the JAX package's local
scorer on a twin cluster. Exact equality throughout.

The reference runs this suite under its process-wide lock checker and
leaves it installed; here the lock-checked storm runs in a child
interpreter (``test_lockchecked_storm_in_a_child``), so no later test
file on the worker runs instrumented."""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from batch_scheduler_tpu_torch.cache.pg_cache import PGStatusCache, PodGroupMatchStatus
from batch_scheduler_tpu_torch.core.operation import ScheduleOperation
from batch_scheduler_tpu_torch.service import (
    OracleClient,
    RemoteScorer,
    ResilientOracleClient,
    protocol as proto,
    serve_background,
)
from batch_scheduler_tpu_torch.sim.chaos import C2S_FAULT_KINDS, FAULT_KINDS, ChaosProxy
from batch_scheduler_tpu_torch.utils import errors as errs
from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY, Registry
from batch_scheduler_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def test_fault_kinds_are_the_references():
    from batch_scheduler_tpu.sim import chaos as ref

    assert FAULT_KINDS == ref.FAULT_KINDS
    assert C2S_FAULT_KINDS == ref.C2S_FAULT_KINDS


def _request(n=4, g=2, r=5, members=3, wire=proto):
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 8000
    alloc[:, 3] = 20
    group_req = np.zeros((g, r), np.int32)
    group_req[:, 0] = 1000
    group_req[:, 3] = 1
    return wire.ScheduleRequest(
        alloc=alloc,
        requested=np.zeros((n, r), np.int32),
        group_req=group_req,
        remaining=np.full(g, members, np.int32),
        fit_mask=np.ones((g, n), bool),
        group_valid=np.ones(g, bool),
        order=np.arange(g, dtype=np.int32),
        min_member=np.full(g, members, np.int32),
        scheduled=np.zeros(g, np.int32),
        matched=np.zeros(g, np.int32),
        ineligible=np.zeros(g, bool),
        creation_rank=np.arange(g, dtype=np.int32),
    )


def _plan(resp):
    return (np.asarray(resp.placed).tolist(), np.asarray(resp.gang_feasible).tolist(),
            np.asarray(resp.progress).tolist(), int(resp.best), bool(resp.best_exists),
            np.asarray(resp.assignment_nodes).tolist(),
            np.asarray(resp.assignment_counts).tolist())


@pytest.fixture(scope="module")
def reference_plan():
    """The JAX sidecar's answer to ``_request()``."""
    from batch_scheduler_tpu.service import OracleClient as JClient
    from batch_scheduler_tpu.service import protocol as jproto
    from batch_scheduler_tpu.service import serve_background as jserve

    srv = jserve()
    try:
        client = JClient(*srv.address)
        plan = _plan(client.schedule(_request(wire=jproto)))
        client.close()
    finally:
        srv.shutdown()
        srv.server_close()
    return plan


@pytest.fixture(scope="module")
def server():
    srv = serve_background(device="cpu")
    warm = OracleClient(*srv.address)
    warm.schedule(_request())
    warm.close()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def proxy(server):
    p = ChaosProxy(*server.address)
    yield p
    p.stop()


def _quick_client(proxy, registry, timeout=0.8, attempts=4, **breaker_kwargs):
    return ResilientOracleClient(
        *proxy.address,
        timeout=timeout,
        registry=registry,
        retry_policy=RetryPolicy(max_attempts=attempts, base_delay=0.01, max_delay=0.05),
        breaker=CircuitBreaker(
            failure_threshold=breaker_kwargs.pop("failure_threshold", 8),
            reset_timeout=breaker_kwargs.pop("reset_timeout", 0.3),
        ),
    )


# -- fault classes, individually ------------------------------------------


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_client_survives_each_fault_class(proxy, kind, reference_plan):
    """One injected fault of each class: the request still completes with
    the JAX sidecar's plan, the breaker stays closed, and no transport
    error escapes to the caller."""
    reg = Registry()
    client = _quick_client(proxy, reg)
    label = "%s:%s" % proxy.address
    assert _plan(client.schedule(_request())) == reference_plan

    proxy.set_fault(kind, probability=1.0, limit=1, delay_s=0.1)
    resp = client.schedule(_request())
    assert resp.placed.all()
    assert _plan(resp) == reference_plan
    injected = proxy.injected_counts()
    assert injected[kind] == 1, injected
    assert client.breaker.state == "closed"
    retries = reg.counter("bst_oracle_retries_total").value(op="schedule", client=label)
    if kind == "delay":
        assert retries == 0
        assert reg.counter("bst_oracle_transport_failures_total").value(
            op="schedule", client=label) == 0
    else:
        assert retries >= 1
    assert client.ping()
    client.close()


def test_reconnect_makes_old_batch_rows_stale(proxy):
    reg = Registry()
    client = _quick_client(proxy, reg)
    resp = client.schedule(_request())
    proxy.set_fault("reset", probability=1.0, limit=1)
    assert client.ping()  # consumes the reset; the client reconnects
    with pytest.raises(errs.StaleBatchError):
        client.row("capacity", 0, resp.batch_seq)
    client.close()


# -- circuit breaker lifecycle --------------------------------------------


def test_breaker_opens_fails_fast_and_recovers(proxy, reference_plan):
    reg = Registry()
    label = "%s:%s" % proxy.address
    client = ResilientOracleClient(
        *proxy.address, timeout=1.0, registry=reg,
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.01, max_delay=0.02),
        breaker=CircuitBreaker(failure_threshold=3, reset_timeout=0.3),
    )
    gauge = reg.gauge("bst_oracle_breaker_state")
    assert client.schedule(_request()).placed.all()
    assert gauge.value(client=label) == 0

    proxy.set_fault("reset", probability=1.0)
    for _ in range(2):
        with pytest.raises(errs.OracleTransportError):
            client.schedule(_request())
    assert client.breaker.state == "open"
    assert gauge.value(client=label) == 1

    failures = reg.counter("bst_oracle_transport_failures_total").value(
        op="schedule", client=label)
    t0 = time.perf_counter()
    with pytest.raises(errs.CircuitOpenError):
        client.schedule(_request())
    assert time.perf_counter() - t0 < 0.05
    assert reg.counter("bst_oracle_transport_failures_total").value(
        op="schedule", client=label) == failures

    time.sleep(0.35)
    with pytest.raises(errs.CircuitOpenError):
        client.schedule(_request())
    assert client.breaker.state == "open"

    proxy.clear_fault()
    time.sleep(0.35)
    assert _plan(client.schedule(_request())) == reference_plan
    assert client.breaker.state == "closed"
    assert gauge.value(client=label) == 0
    client.close()


# -- deadline propagation --------------------------------------------------


def test_deadline_error_within_two_x_budget(server, monkeypatch):
    import batch_scheduler_tpu_torch.service.server as server_mod

    reg = Registry()
    label = "%s:%s" % server.address
    client = ResilientOracleClient(
        *server.address, timeout=10.0, registry=reg,
        breaker=CircuitBreaker(failure_threshold=1, reset_timeout=60.0),
    )
    assert client.schedule(_request()).placed.all()
    real = server_mod.dispatch_batch

    def stalled(*args, **kwargs):
        time.sleep(1.5)
        return real(*args, **kwargs)

    monkeypatch.setattr(server_mod, "dispatch_batch", stalled)
    t0 = time.perf_counter()
    with pytest.raises(errs.OracleDeadlineError):
        client.schedule(_request(), deadline_ms=300)
    elapsed = time.perf_counter() - t0
    assert elapsed <= 0.6, f"deadline answer took {elapsed:.3f}s (> 2x 300ms)"
    assert client.breaker.state == "closed"
    assert reg.counter("bst_oracle_retries_total").value(op="schedule", client=label) == 0
    assert reg.counter("bst_oracle_deadline_errors_total").value(client=label) == 1
    monkeypatch.setattr(server_mod, "dispatch_batch", real)
    assert client.schedule(_request(), deadline_ms=30000).placed.all()
    client.close()


def test_deadline_generous_budget_is_a_noop(server, reference_plan):
    client = ResilientOracleClient(*server.address, timeout=10.0, registry=Registry(),
                                   deadline_ms=60000)
    resp = client.schedule(_request())
    assert _plan(resp) == reference_plan
    assert client.row("capacity", 0, resp.batch_seq).shape[0] >= 4
    client.close()


# -- conservative local-CPU fallback --------------------------------------


class _Cluster:
    """Static nodes plus bound pods (the reference helpers' FakeCluster)."""

    def __init__(self, pkg, nodes):
        import importlib

        self._snapshot = importlib.import_module(f"{pkg}.ops.snapshot")
        self.nodes = list(nodes)
        self.bound = {n.metadata.name: [] for n in self.nodes}

    def list_nodes(self):
        return list(self.nodes)

    def node_requested(self, node_name):
        return self._snapshot.node_requested_from_pods(self.bound.get(node_name, []))

    def bind(self, pod, node_name):
        pod.spec.node_name = node_name
        self.bound[node_name].append(pod)


def _status_for(pkg, pg, cache, rep_pod):
    import importlib

    types = importlib.import_module(f"{pkg}.api.types")
    pgc = importlib.import_module(f"{pkg}.cache.pg_cache")
    pgs = pgc.PodGroupMatchStatus(pg)
    if pg.status.phase == types.PodGroupPhase.EMPTY:
        pg.status.phase = types.PodGroupPhase.PENDING
    pgs.pod = rep_pod
    if pg.spec.min_resources is None:
        pg.spec.min_resources = rep_pod.resource_require()
    cache.set(pg.full_name(), pgs)
    return pgs


def _scen(pkg="batch_scheduler_tpu_torch"):
    import importlib

    return importlib.import_module(f"{pkg}.sim.scenarios")


def _gang_fixture():
    scen = _scen()
    cluster = _Cluster("batch_scheduler_tpu_torch", [
        scen.make_sim_node("n1", {"cpu": "8", "memory": "32Gi", "pods": "110"})])
    cache = PGStatusCache()
    ok = scen.make_member_pods("okgang", 2, {"cpu": "1"})
    _status_for("batch_scheduler_tpu_torch",
                scen.make_sim_group("okgang", 2, creation_ts=1.0), cache, ok[0])
    bad = scen.make_member_pods("badgang", 2, {"cpu": "64"})
    _status_for("batch_scheduler_tpu_torch",
                scen.make_sim_group("badgang", 2, creation_ts=2.0), cache, bad[0])
    return cluster, cache, ok, bad


def test_fallback_local_cpu_is_conservative_and_recovers(proxy):
    cluster, cache, ok_members, bad_members = _gang_fixture()
    client = ResilientOracleClient(
        *proxy.address, timeout=2.0, registry=Registry(),
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.01, max_delay=0.02),
        breaker=CircuitBreaker(failure_threshold=2, reset_timeout=0.4),
    )
    scorer = RemoteScorer(client, fallback="local-cpu")
    op = ScheduleOperation(cache, cluster, scorer=scorer, device="cpu")

    proxy.set_fault("reset", probability=1.0)
    decisions = DEFAULT_REGISTRY.counter("bst_oracle_fallback_decisions_total")
    passes0 = decisions.value(decision="pass")
    denies0 = decisions.value(decision="deny")

    op.pre_filter(ok_members[0])
    assert scorer.degraded
    assert op.gang_plan(ok_members[0]) is None
    assert not op.last_denied_pg.contains("default/okgang")
    with pytest.raises(errs.ResourceNotEnoughError):
        op.pre_filter(bad_members[0])
    assert decisions.value(decision="pass") == passes0 + 1
    assert decisions.value(decision="deny") == denies0 + 1
    op.filter(ok_members[0], "n1")
    assert op.score(ok_members[0], "n1") > 0

    proxy.clear_fault()
    time.sleep(0.45)
    op.pre_filter(ok_members[1])
    assert not scorer.degraded
    assert scorer.placed("default/okgang")
    assert op.gang_plan(ok_members[1]) is not None
    scorer.close()


def test_fallback_deny_mode_surfaces_transport_error(proxy):
    cluster, cache, ok_members, _ = _gang_fixture()
    client = ResilientOracleClient(
        *proxy.address, timeout=1.0, registry=Registry(),
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.01, max_delay=0.02),
        breaker=CircuitBreaker(failure_threshold=3, reset_timeout=0.3),
    )
    scorer = RemoteScorer(client)
    op = ScheduleOperation(cache, cluster, scorer=scorer, device="cpu")
    proxy.set_fault("reset", probability=1.0)
    with pytest.raises(errs.OracleTransportError):
        op.pre_filter(ok_members[0])
    assert not scorer.degraded
    scorer.close()


# -- wire-delta state under chaos -----------------------------------------


class _Twin:
    """The same small cluster in both packages: the port's world, which the
    remote scorer plans over, and the JAX package's, which the reference's
    local scorer plans over. ``bind`` lands a filler pod on both."""

    def __init__(self, n_nodes=6, n_gangs=4):
        from batch_scheduler_tpu.cache.pg_cache import PGStatusCache as JCache
        from batch_scheduler_tpu.core.oracle_scorer import OracleScorer as JScorer

        self.worlds = {}
        for pkg, cache_cls in (("batch_scheduler_tpu", JCache),
                               ("batch_scheduler_tpu_torch", PGStatusCache)):
            scen = _scen(pkg)
            cluster = _Cluster(pkg, [
                scen.make_sim_node(f"n{i}", {"cpu": "8", "memory": "32Gi", "pods": "110"})
                for i in range(n_nodes)])
            cache = cache_cls()
            for i in range(n_gangs):
                name = f"gang{i}"
                members = scen.make_member_pods(name, 3, {"cpu": "1"})
                _status_for(pkg, scen.make_sim_group(name, 3, creation_ts=float(i)),
                            cache, members[0])
            self.worlds[pkg] = (cluster, cache)
        self.gangs = [f"default/gang{i}" for i in range(n_gangs)]
        self.reference = JScorer(device_state=False)

    def bind(self, name, node):
        for pkg, (cluster, _) in self.worlds.items():
            pod = _scen(pkg).make_member_pods(name, 1, {"cpu": "2"})[0]
            pod.metadata.labels = {}
            cluster.bind(pod, node)

    def refresh_and_compare(self, remote):
        pairs = ((remote, self.worlds["batch_scheduler_tpu_torch"]),
                 (self.reference, self.worlds["batch_scheduler_tpu"]))
        for scorer, (cluster, cache) in pairs:
            scorer.mark_dirty()
            scorer.ensure_fresh(cluster, cache, group=self.gangs[0])
        for g in self.gangs:
            assert remote.placed(g) == self.reference.placed(g)
            assert remote.gang_feasible(g) == self.reference.gang_feasible(g)
            assert remote.assignment(g) == self.reference.assignment(g)


def test_wire_delta_survives_dropped_and_duplicated_frames(server):
    chaos = ChaosProxy(*server.address, c2s_frames=True)
    client = ResilientOracleClient(
        *chaos.address, timeout=2.0, registry=Registry(),
        retry_policy=RetryPolicy(max_attempts=4, base_delay=0.01, max_delay=0.05),
        breaker=CircuitBreaker(failure_threshold=16, reset_timeout=0.3),
    )
    remote = RemoteScorer(client, fallback="deny")
    assert remote._wire_delta_ok
    remote._wire_tenant_ok = False  # one frame per request: faults hit the delta
    twin = _Twin()
    kinds = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_batches_total")
    resyncs = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_resyncs_total")
    try:
        twin.refresh_and_compare(remote)
        twin.bind("warm-filler", "n0")
        deltas_before = kinds.value(kind="delta")
        twin.refresh_and_compare(remote)
        assert kinds.value(kind="delta") == deltas_before + 1

        resyncs_before = resyncs.value()
        keyframes_before = kinds.value(kind="keyframe")
        chaos.set_fault("drop_c2s", probability=1.0, limit=1)
        twin.bind("drop-filler", "n1")
        twin.refresh_and_compare(remote)
        assert chaos.injected_counts()["drop_c2s"] == 1
        assert resyncs.value() >= resyncs_before + 1
        assert kinds.value(kind="keyframe") >= keyframes_before + 1

        twin.bind("steady-filler", "n2")
        deltas_before = kinds.value(kind="delta")
        twin.refresh_and_compare(remote)
        assert kinds.value(kind="delta") == deltas_before + 1

        chaos.set_fault("dup_c2s", probability=1.0, limit=1)
        twin.bind("dup-filler", "n3")
        twin.refresh_and_compare(remote)
        assert chaos.injected_counts()["dup_c2s"] == 1
        twin.bind("post-dup-filler", "n4")
        twin.refresh_and_compare(remote)
        twin.bind("tail-filler", "n5")
        twin.refresh_and_compare(remote)
    finally:
        remote.close()
        chaos.stop()


# -- warm-standby failover drills -----------------------------------------


def _pooled(spec, registry, attempts=6, timeout=2.0, reset_timeout=5.0, name=None):
    return ResilientOracleClient(
        spec, timeout=timeout, registry=registry, name=name,
        retry_policy=RetryPolicy(max_attempts=attempts, base_delay=0.01, max_delay=0.05),
        breaker=CircuitBreaker(failure_threshold=2, reset_timeout=reset_timeout),
    )


def test_kill_mid_delta_stream_fails_over_and_resyncs(server):
    standby = serve_background(device="cpu")
    chaos = ChaosProxy(*server.address)
    reg = Registry()
    spec = "%s:%s,%s:%s" % (chaos.address + standby.address)
    client = _pooled(spec, reg)
    remote = RemoteScorer(client, fallback="deny")
    assert remote._wire_delta_ok
    twin = _Twin()
    resyncs = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_resyncs_total")
    kinds = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_batches_total")
    try:
        twin.refresh_and_compare(remote)
        twin.bind("pre-kill-filler", "n0")
        twin.refresh_and_compare(remote)
        primary_addr = client.active_address

        chaos.kill_endpoint()
        resyncs_before = resyncs.value()
        keyframes_before = kinds.value(kind="keyframe")
        twin.bind("kill-filler", "n1")
        twin.refresh_and_compare(remote)

        assert client.active_address != primary_addr
        assert client.active_address == standby.address
        assert resyncs.value() >= resyncs_before + 1
        assert kinds.value(kind="keyframe") >= keyframes_before + 1
        assert reg.counter("bst_oracle_failover_total").value(
            reason="crash", client=spec) >= 1

        twin.bind("post-kill-filler", "n2")
        deltas_before = kinds.value(kind="delta")
        twin.refresh_and_compare(remote)
        assert kinds.value(kind="delta") == deltas_before + 1
    finally:
        remote.close()
        chaos.stop()
        standby.shutdown()
        standby.server_close()


def test_draining_during_coalesced_mega_batch(reference_plan):
    from batch_scheduler_tpu_torch.service.client import active_failover_report

    primary = serve_background(device="cpu", coalesce=True)
    primary.coalescer.mode = "mega"
    standby = serve_background(device="cpu")
    spec = "%s:%s,%s:%s" % (primary.address + standby.address)
    reg = Registry()
    tenants = [f"ha-t{i}" for i in range(4)]
    clients = {t: _pooled(spec, reg, timeout=30.0, name=t) for t in tenants}
    results = {t: [] for t in tenants}
    errors = []
    barrier = threading.Barrier(len(tenants))
    drained = threading.Event()

    def run(tenant):
        try:
            for i in range(3):
                barrier.wait(timeout=30)
                if tenant == tenants[0] and i == 1 and not drained.is_set():
                    drained.set()
                    threading.Thread(target=lambda: primary.drain(timeout=15.0),
                                     daemon=True).start()
                resp = clients[tenant].schedule(_request(), tenant=tenant)
                results[tenant].append(_plan(resp))
        except Exception as e:  # noqa: BLE001 — collected, asserted empty
            errors.append((tenant, repr(e)))

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in tenants]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        assert errors == []
        for t in tenants:
            assert results[t] == [reference_plan] * 3
            assert clients[t].active_address == standby.address, t
        report = primary.drain()
        assert report["drained"] is True and report["audit_flushed"] is True
        rows = {c["client"]: c for c in active_failover_report()["clients"]}
        for t in tenants:
            assert "drain" in {p["reason"] for p in rows[t]["promotions"]}, (t, rows[t])
    finally:
        for c in clients.values():
            c.close()
        primary.shutdown()
        primary.server_close()
        standby.shutdown()
        standby.server_close()


def test_failover_races_half_open_probe(server, reference_plan):
    standby = serve_background(device="cpu")
    chaos_primary = ChaosProxy(*server.address)
    chaos_standby = ChaosProxy(*standby.address)
    client = _pooled("%s:%s,%s:%s" % (chaos_primary.address + chaos_standby.address),
                     Registry(), reset_timeout=0.3)
    primary_addr = tuple(chaos_primary.address)
    standby_addr = tuple(chaos_standby.address)
    try:
        assert _plan(client.schedule(_request())) == reference_plan
        assert client.active_address == primary_addr
        chaos_primary.kill_endpoint()
        assert _plan(client.schedule(_request())) == reference_plan
        assert client.active_address == standby_addr
        assert client._breakers[0].state == "open"
        chaos_primary.restore_endpoint()
        time.sleep(0.35)
        chaos_standby.kill_endpoint()
        assert _plan(client.schedule(_request())) == reference_plan
        assert client.active_address == primary_addr
        assert client._breakers[0].state == "closed"
        assert client._breakers[1].state == "open"
        hops = [(reason, to) for _ts, reason, to in client._promotions]
        assert hops == [("crash", 1), ("crash", 0)]
    finally:
        client.close()
        chaos_primary.stop()
        chaos_standby.stop()
        standby.shutdown()
        standby.server_close()


def test_stop_joins_every_relay_thread(server):
    """F4: ``stop`` wakes the relay threads blocked in ``recv`` (a close
    from another thread does not) and joins them, with an idle connection
    and one mid-hang open: no ``chaos`` thread is left to wake during the
    interpreter's teardown, where one aborted the process."""
    p = ChaosProxy(*server.address)
    idle = OracleClient(*p.address)
    assert _plan(idle.schedule(_request()))
    p.set_fault("hang", hang_s=30.0)
    hung = OracleClient(*p.address, timeout=0.3)
    with pytest.raises(Exception):
        hung.schedule(_request())
    threads = list(p._threads)
    assert len([t for t in threads if t.is_alive()]) >= 3  # accept + two relays a client
    t0 = time.perf_counter()
    p.stop()
    assert time.perf_counter() - t0 < 10.0
    assert [t.name for t in threads if t.is_alive()] == []
    idle.close()
    hung.close()


# -- the lock-checked storm, in a child -----------------------------------


def test_lockchecked_storm_in_a_child():
    """The reference's suite doubles as a race detector with its lock
    checker installed process-wide. The port's storm (every fault kind and
    the endpoint primitives through the proxy, concurrent clients, the
    fallback scorer) runs with ``BST_LOCKCHECK=1`` in a child interpreter,
    so the instrumentation dies with it; a violation fails the child. The
    child leaves by a normal interpreter exit, which must return 0."""
    body = textwrap.dedent("""
        import threading
        import numpy as np
        import batch_scheduler_tpu_torch
        from batch_scheduler_tpu_torch.analysis import lockcheck
        from batch_scheduler_tpu_torch.service import (
            ResilientOracleClient, protocol as proto, serve_background)
        from batch_scheduler_tpu_torch.sim.chaos import FAULT_KINDS, ChaosProxy
        from batch_scheduler_tpu_torch.utils.metrics import Registry
        from batch_scheduler_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy

        assert lockcheck._installed[0]
        assert ChaosProxy.__dict__.get("_lockcheck_instrumented")

        def request():
            n, g, r = 4, 2, 5
            alloc = np.zeros((n, r), np.int32); alloc[:, 0] = 8000; alloc[:, 3] = 20
            req = np.zeros((g, r), np.int32); req[:, 0] = 1000; req[:, 3] = 1
            return proto.ScheduleRequest(
                alloc=alloc, requested=np.zeros((n, r), np.int32), group_req=req,
                remaining=np.full(g, 3, np.int32), fit_mask=np.ones((g, n), bool),
                group_valid=np.ones(g, bool), order=np.arange(g, dtype=np.int32),
                min_member=np.full(g, 3, np.int32), scheduled=np.zeros(g, np.int32),
                matched=np.zeros(g, np.int32), ineligible=np.zeros(g, bool),
                creation_rank=np.arange(g, dtype=np.int32))

        srv = serve_background(device="cpu")
        proxy = ChaosProxy(*srv.address, seed=7)
        # each kind at 0.05: a faulted response ~23% of the time, and ten
        # attempts a request, so every request completes
        proxy.set_fault({k: 0.05 for k in FAULT_KINDS}, delay_s=0.02, hang_s=0.5)
        errors = []

        def storm(i):
            c = ResilientOracleClient(
                *proxy.address, timeout=0.8, registry=Registry(),
                retry_policy=RetryPolicy(max_attempts=10, base_delay=0.01,
                                         max_delay=0.05),
                breaker=CircuitBreaker(failure_threshold=50, reset_timeout=0.2))
            try:
                for _ in range(6):
                    assert c.schedule(request()).placed.all()
                    proxy.injected_counts()
            except Exception as e:
                errors.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=storm, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        proxy.hang_endpoint(); proxy.restore_endpoint()
        for t in threads:
            t.join(120)
        assert errors == [], errors
        assert sum(proxy.injected_counts().values()) > 0
        proxy.stop()
        # stop() joined every relay thread: none is left blocked in a
        # socket call to wake while the interpreter finalizes, which
        # aborted about one child in three under load (ROADMAP Queue 3, F4)
        left = [t.name for t in threading.enumerate() if t.name.startswith("chaos")]
        assert left == [], left
        # finish the requests the faults orphaned before the interpreter
        # tears down (a daemon thread inside a batch at exit aborts it)
        assert srv.drain(timeout=30.0)["drained"]
        srv.shutdown(); srv.server_close()
        print("OK", flush=True)
    """)
    env = dict(os.environ, BST_LOCKCHECK="1", BST_CAPACITY="0")
    proc = subprocess.run([sys.executable, "-c", body], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK", out[-3000:]
