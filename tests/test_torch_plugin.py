"""The port's plugin layer against the JAX reference's: the batch plugin's
gang release choreography and permit mapping (tests/test_batch_plugin.py),
the PodGroup controller's phase machine driven through ``_sync_handler``
(tests/test_controller.py), and the leases and the leader-gated controller
failover (tests/test_leader.py, the lease over the HTTP API server too). Each scenario runs through both
packages, the port's operation on the CPU; the observations must be equal,
and the reference test's own assertions hold on the port's.
"""

import importlib
import threading
import time
import types as pytypes

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _pkg(name):
    ns = pytypes.SimpleNamespace(name=name)
    for attr, mod in (("scen", "sim.scenarios"), ("types", "api.types"),
                      ("cache", "cache.pg_cache"), ("core", "core.operation"),
                      ("fwtypes", "framework.types"), ("plugin", "plugin.batch_plugin"),
                      ("snapshot", "ops.snapshot"), ("client", "client"),
                      ("controller", "controller"), ("leader", "plugin.leader"),
                      ("factory", "plugin.factory"), ("cluster", "framework.cluster"),
                      ("serde", "api.serde")):
        setattr(ns, attr, importlib.import_module(f"{name}.{mod}"))
    ns.kw = {"device": "cpu"} if name.endswith("_torch") else {}
    return ns


def both(fn):
    """(reference, port) observations of ``fn(m)``."""
    return [fn(_pkg(name)) for name in PACKAGES]


# -- the batch plugin (tests/test_batch_plugin.py) ---------------------------


class _Cluster:
    def __init__(self, m, nodes):
        self.m = m
        self.nodes = list(nodes)

    def list_nodes(self):
        return list(self.nodes)

    def node_requested(self, node_name):
        return self.m.snapshot.node_requested_from_pods([])


class _StubWaiting:
    def __init__(self):
        self.pods = {}

    def get_waiting_pod(self, uid):
        return self.pods.get(uid)

    def iterate_over_waiting_pods(self, fn):
        for wp in list(self.pods.values()):
            fn(wp)


class _StubWaitingPod:
    def __init__(self, pod, node_name="n1"):
        self.pod = pod
        self.node_name = node_name
        self.allowed = 0
        self.rejected = []

    def get_pod(self):
        return self.pod

    def allow(self, name):
        self.allowed += 1
        return True

    def reject(self, reason):
        self.rejected.append(reason)
        return True


def _build(m, members=2):
    node = m.scen.make_sim_node("n1", {"cpu": "32", "memory": "64Gi", "pods": "110"})
    cache = m.cache.PGStatusCache()
    pg = m.scen.make_sim_group("gang", members, creation_ts=1.0)
    pods = m.scen.make_member_pods("gang", members, {"cpu": "1"})
    pgs = m.cache.PodGroupMatchStatus(pg)
    pg.status.phase = m.types.PodGroupPhase.PENDING
    pgs.pod = pods[0]
    pg.spec.min_resources = pods[0].resource_require()
    cache.set(pg.full_name(), pgs)
    op = m.core.ScheduleOperation(cache, _Cluster(m, [node]), scorer="oracle", **m.kw)
    handle = _StubWaiting()
    plugin = m.plugin.BatchSchedulingPlugin(handle, op, pg_client=None)
    return plugin, handle, op, cache, pods


def _permit_all(plugin, op, pods):
    out = []
    for p in pods:
        op.pre_filter(p)
        code, _ = plugin.permit(p, "n1")
        out.append(code.value if hasattr(code, "value") else str(code))
    return out


def test_release_allows_every_matched_waiting_pod():
    def drive(m):
        plugin, handle, op, cache, pods = _build(m)
        codes = _permit_all(plugin, op, pods)
        wps = {p.metadata.uid: _StubWaitingPod(p) for p in pods}
        handle.pods = wps
        plugin.start_batch_schedule("default/gang")
        first = [wp.allowed for wp in wps.values()]
        plugin.start_batch_schedule("default/gang")  # pairs consumed
        return codes, first, [wp.allowed for wp in wps.values()], plugin.start_chan.qsize()

    ref, port = both(drive)
    assert port == ref
    assert port[1] == [1, 1] and port[2] == [1, 1]


def test_release_drops_stale_pair_and_continues():
    def drive(m):
        plugin, handle, op, cache, pods = _build(m, members=3)
        _permit_all(plugin, op, pods)
        wp1, wp2 = _StubWaitingPod(pods[1]), _StubWaitingPod(pods[2])
        handle.pods = {pods[1].metadata.uid: wp1, pods[2].metadata.uid: wp2}
        plugin.start_batch_schedule("default/gang")
        pairs = op.get_pod_node_pairs("default/gang")
        return ([pairs.get(p.metadata.uid) is None for p in pods],
                wp1.allowed, wp2.allowed)

    ref, port = both(drive)
    assert port == ref == ([True, True, True], 1, 1)


def test_release_grace_covers_late_waiting_pod_despite_dead_pair():
    def drive(m):
        plugin, handle, op, cache, pods = _build(m, members=3)
        _permit_all(plugin, op, pods)
        wp2 = _StubWaitingPod(pods[2])
        late = {"wp": None}

        class _LateHandle:
            def get_waiting_pod(self, uid):
                if uid == pods[2].metadata.uid:
                    return wp2
                if uid == pods[1].metadata.uid:
                    return late["wp"]
                return None

            def iterate_over_waiting_pods(self, fn):
                pass

        plugin.handle = _LateHandle()
        wp1 = _StubWaitingPod(pods[1])
        t = threading.Timer(0.005, lambda: late.__setitem__("wp", wp1))
        t.start()
        plugin.start_batch_schedule("default/gang")
        t.cancel()
        pairs = op.get_pod_node_pairs("default/gang")
        return wp2.allowed, wp1.allowed, pairs.get(pods[0].metadata.uid) is None

    ref, port = both(drive)
    assert port == ref == (1, 1, True)


def test_update_batch_cache_evicts_replaced_uid():
    def drive(m):
        plugin, handle, op, cache, pods = _build(m)
        _permit_all(plugin, op, pods)
        pairs = op.get_pod_node_pairs("default/gang")
        before = pairs.get(pods[0].metadata.uid) is not None
        reborn = m.scen.make_member_pods("gang", 1, {"cpu": "1"})[0]
        assert reborn.metadata.uid != pods[0].metadata.uid
        handle.pods = {reborn.metadata.uid: _StubWaitingPod(reborn)}
        plugin.update_batch_cache()
        return before, pairs.get(pods[0].metadata.uid) is None

    ref, port = both(drive)
    assert port == ref == (True, True)


def test_permit_outcome_mapping():
    def drive(m):
        plugin, handle, op, cache, pods = _build(m)
        loose = m.scen.make_member_pods("loose", 1, {"cpu": "1"})[0]
        loose.metadata.labels = {}
        out = [plugin.permit(loose, "n1")[0].value]
        op.pre_filter(pods[0])
        code, timeout = plugin.permit(pods[0], "n1")
        out += [code.value, timeout]
        stranger = m.scen.make_member_pods("ghost", 1, {"cpu": "1"})[0]
        out.append(plugin.permit(stranger, "n1")[0].value)
        return out

    ref, port = both(drive)
    assert port == ref
    assert port[2] > 1.0  # gang TTL + 1 s margin


def test_reject_pod_is_noop_for_unknown_uid():
    def drive(m):
        plugin, handle, op, cache, pods = _build(m)
        plugin.reject_pod("no-such-uid")
        wp = _StubWaitingPod(pods[0])
        handle.pods = {pods[0].metadata.uid: wp}
        plugin.reject_pod(pods[0].metadata.uid)
        return wp.rejected

    ref, port = both(drive)
    assert port == ref == ["Group failed"]


def test_extension_point_gate_matches_reference():
    def drive(m):
        gate_mod = importlib.import_module(f"{m.name}.plugin.gate")
        plugin, handle, op, cache, pods = _build(m)
        gate = gate_mod.ExtensionPointGate(plugin)  # the reference's shipped four
        out = [sorted(gate.enabled), gate.score(pods[0], "n1")]
        gate.filter(pods[0], "no-such-node")  # filter is off: no raise
        gate.pre_filter(pods[0])
        code, _ = gate.permit(pods[0], "n1")
        out.append(code.value)
        with pytest.raises(ValueError):
            gate_mod.ExtensionPointGate(plugin, {"bogus"})
        return out

    ref, port = both(drive)
    assert port == ref


def test_serde_round_trips_preserve_all_fields():
    def drive(m):
        to_dict = m.types.to_dict
        pg = m.scen.make_sim_group("rt", 5, creation_ts=12.5)
        pg.metadata.uid = "pg-rt"
        pg.spec.min_resources = {"cpu": 2000, "nvidia.com/gpu": 1}
        pg.spec.max_schedule_time = 90.0
        pg.spec.priority_class_name = "high"
        pg.status.phase = m.types.PodGroupPhase("Scheduling")
        pg.status.scheduled = 3
        pg.status.occupied_by = "default/owner"
        pod = m.scen.make_member_pods("rt", 1, {"cpu": "2", "memory": "1Gi"}, priority=7)[0]
        pod.metadata.uid = "pod-rt"
        pod.spec.node_selector = {"zone": "east"}
        pod.spec.node_name = "n9"
        node = m.scen.make_sim_node("rt-n", {"cpu": "8", "memory": "16Gi", "pods": "110"},
                                    labels={"zone": "east"})
        node.metadata.uid = "node-rt"
        node.spec.unschedulable = True
        out = []
        for obj, back in ((pg, m.serde.pod_group_from_dict), (pod, m.serde.pod_from_dict),
                          (node, m.serde.node_from_dict)):
            d = to_dict(obj)
            assert to_dict(back(d)) == d
            out.append(d)
        return out

    ref, port = both(drive)
    assert port == ref


# -- the PodGroup controller (tests/test_controller.py) ----------------------


class _Harness:
    def __init__(self, m, max_schedule_seconds=None):
        self.m = m
        self.api = m.client.APIServer()
        self.client = m.client.Clientset(self.api)
        self.cache = m.cache.PGStatusCache()
        self.rejected = []
        self.backoffs = []
        factory = m.client.SharedInformerFactory(self.api)
        self.controller = m.controller.PodGroupController(
            client=self.client, pg_informer=factory.pod_groups(), pg_cache=self.cache,
            reject_pod=self.rejected.append, add_to_backoff=self.backoffs.append,
            max_schedule_seconds=max_schedule_seconds,
        )

    def sync(self, name, namespace="default"):
        pg = self.client.podgroups(namespace).get(name)
        self.controller._sync_handler(pg, f"{namespace}/{name}")
        return self.client.podgroups(namespace).get(name)

    def group(self, name, n):
        pg = self.m.scen.make_sim_group(name, n)
        pg.metadata.uid = f"pg-{name}"
        self.client.podgroups().create(pg)

    def member(self, name, gang, node, phase):
        pod = self.m.scen.make_member_pods(gang, 1, {"cpu": "1"})[0]
        pod.metadata.name = name
        self.client.pods().create(pod)
        self.client.pods().bind(name, node)
        self.client.pods().patch(name, {"status": {"phase": phase}})


def _status(pg):
    s = pg.status
    return (s.phase.value, s.scheduled, s.running, s.succeeded, s.failed)


def test_controller_phase_machine_matches_reference():
    def drive(m):
        out = []
        h = _Harness(m)
        h.group("g", 2)
        out.append(_status(h.sync("g")))  # "" -> Pending, cached
        out.append(h.cache.get("default/g") is not None)
        h.client.podgroups().patch("g", {"status": {"phase": "Scheduling", "scheduled": 2}})
        for i in range(2):
            h.member(f"g-{i}", "g", "n1", "Running")
        out.append(_status(h.sync("g")))  # Running
        for i in range(2):
            h.client.pods().patch(f"g-{i}", {"status": {"phase": "Succeeded"}})
        out.append(_status(h.sync("g")))  # Finished, uncached
        out.append(h.cache.get("default/g") is None)
        return out

    ref, port = both(drive)
    assert port == ref
    assert port[2][0] == "Running" and port[3][0] == "Finished"


def test_controller_failure_demotion_and_recovery_match_reference():
    def drive(m):
        out = []
        h = _Harness(m)  # failure
        h.group("f", 2)
        h.sync("f")
        h.client.podgroups().patch("f", {"status": {"phase": "Scheduling", "scheduled": 2}})
        h.member("f-0", "f", "n1", "Running")
        h.member("f-1", "f", "n1", "Failed")
        out.append((_status(h.sync("f")), h.cache.get("default/f") is None))
        h = _Harness(m)  # crash recovery re-derives scheduled
        h.group("r", 3)
        h.client.podgroups().patch("r", {"status": {"phase": "Pending",
                                                    "schedule_start_time": 123.0}})
        for i in range(2):
            h.member(f"r-{i}", "r", "n1", "Running")
        out.append(_status(h.sync("r")))
        h = _Harness(m)  # demotion when members vanish
        h.group("d", 3)
        h.sync("d")
        h.client.podgroups().patch("d", {"status": {"phase": "Scheduled", "scheduled": 3}})
        h.member("d-0", "d", "n1", "Running")
        out.append(_status(h.sync("d")))
        h = _Harness(m)  # local schedule progress not clobbered
        h.group("l", 3)
        h.sync("l")
        h.cache.get("default/l").pod_group.status.phase = m.types.PodGroupPhase.PRE_SCHEDULING
        h.sync("l")
        out.append(h.cache.get("default/l").pod_group.status.phase.value)
        return out

    ref, port = both(drive)
    assert port == ref
    assert port[0][0][0] == "Failed" and port[1][1] == 2
    assert port[2][:2] == ("Scheduling", 1) and port[3] == "PreScheduling"


def test_a_view_older_than_an_eviction_cannot_restore_the_gang():
    """Port-only (the reference keeps the race): a policy eviction resets
    the victim gang while the controller still holds a view of it taken
    between the member deletions. Folding that view in would put the
    deleted members' progress back over the reset (Scheduling, 3 of 4),
    and the first respawned member would then pass Permit as if three
    siblings were bound. The reset's resource version fences the view."""
    m = _pkg("batch_scheduler_tpu_torch")
    h = _Harness(m)
    h.group("v", 4)
    h.sync("v")
    h.client.podgroups().patch("v", {"status": {"phase": "Scheduling", "scheduled": 4}})
    for i in range(4):
        h.member(f"v-{i}", "v", "n1", "Running")
    assert _status(h.sync("v"))[:2] == ("Running", 4)
    h.client.pods().delete("v-0")
    stale = h.sync("v")  # the demotion the first deletion caused
    assert _status(stale)[:2] == ("Scheduling", 3)
    op = m.core.ScheduleOperation(h.cache, m.cluster.ClusterState(),
                                  pg_client=h.client, device="cpu")
    op.note_gang_evicted("default/v")
    # the controller's informers lag: its view of the group and of the
    # members predates the reset and the other three deletions
    h.controller._sync_handler(stale, "default/v")
    for i in range(1, 4):
        h.client.pods().delete(f"v-{i}")
    local = h.cache.get("default/v").pod_group.status
    assert (local.phase.value, local.scheduled) == ("Pending", 0)
    assert _status(h.sync("v"))[:2] == ("Pending", 0)
    respawned = m.scen.make_member_pods("v", 1, {"cpu": "1"})[0]
    outcome = op.permit(respawned, "n1")
    assert not outcome.ready and type(outcome.error).__name__ == "WaitingError"


def test_controller_ttl_eviction_aborts_gang():
    def drive(m):
        h = _Harness(m, max_schedule_seconds=60)
        h.group("g", 2)
        h.sync("g")
        pgs = h.cache.get("default/g")
        pgs.matched_pod_nodes.set("uid-1", object(), ttl=60.0)
        pgs.pod_name_uids.set("default/g-0", "uid-1", ttl=0.001)
        time.sleep(0.01)  # the TTL itself, not a synchronisation
        pgs.pod_name_uids.purge_expired()
        return h.rejected, h.backoffs, pgs.matched_pod_nodes.items()

    ref, port = both(drive)
    assert port == ref == (["uid-1"], ["default/g"], {})


# -- leases and the leader gate (tests/test_leader.py) -----------------------


class _FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def test_api_lease_cas_and_takeover():
    def drive(m):
        api = m.client.APIServer()
        clock = _FakeClock()
        a = m.leader.APILease(api, default_duration=10.0, clock=clock)
        b = m.leader.APILease(api, default_duration=10.0, clock=clock)
        out = [a.acquire("a"), b.acquire("b"), a.renew("a"), b.renew("b")]
        clock.now += 5.0
        out.append(a.acquire("a"))
        clock.now += 11.0
        out += [b.acquire("b"), a.acquire("a"), a.get().holder_identity]
        b.release("b")
        out.append(a.acquire("a"))
        return out

    ref, port = both(drive)
    assert port == ref == [True, False, True, False, True, True, False, "b", True]


def test_api_lease_race_single_winner():
    def drive(m):
        api = m.client.APIServer()
        clock = _FakeClock()
        seed = m.leader.APILease(api, default_duration=1.0, clock=clock)
        assert seed.acquire("old")
        clock.now += 5.0
        results = {}
        barrier = threading.Barrier(2)

        def claim(identity):
            lease = m.leader.APILease(api, default_duration=10.0, clock=clock)
            barrier.wait()
            results[identity] = lease.acquire(identity)

        threads = [threading.Thread(target=claim, args=(i,)) for i in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sorted(results.values()), seed.get().holder_identity in ("a", "b")

    ref, port = both(drive)
    assert port == ref == ([False, True], True)


def test_api_lease_over_http():
    """The API lease through each package's HTTP client and gateway: the
    same acquire / renew / release outcomes."""
    def drive(m):
        gateway = importlib.import_module(f"{m.name}.client.http_gateway")
        http = importlib.import_module(f"{m.name}.client.http_apiserver")
        server = gateway.serve_gateway(m.client.APIServer())
        remote = http.HTTPAPIServer(*server.server_address[:2])
        try:
            a = m.leader.APILease(remote, default_duration=10.0)
            b = m.leader.APILease(remote, default_duration=10.0)
            out = [a.acquire("a"), b.acquire("b"), a.renew("a")]
            a.release("a")
            out += [b.acquire("b"), b.get().holder_identity]
            return out
        finally:
            remote.close()
            server.shutdown()
            server.server_close()

    ref, port = both(drive)
    assert port == ref == [True, False, True, True, "b"]


def test_in_memory_and_file_leases_match_reference(tmp_path):
    def drive(m):
        out = []
        clock = _FakeClock()
        for lease in (m.leader.InMemoryLease(clock=clock),
                      m.leader.FileLease(str(tmp_path / f"{m.name}.lease"), clock=clock)):
            out += [lease.acquire("a", 10.0), lease.acquire("b", 10.0), lease.renew("a"),
                    lease.renew("b")]
            clock.now += 11.0
            out += [lease.acquire("b", 10.0), lease.get().holder_identity]
            lease.release("b")
            out.append(lease.acquire("a", 10.0))
        return out

    ref, port = both(drive)
    assert port == ref


class _Handle:
    def __init__(self, m):
        self.cluster = m.cluster.ClusterState()

    def get_waiting_pod(self, uid):
        return None

    def iterate_over_waiting_pods(self, fn):
        pass


def _wait(predicate, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def test_two_replica_failover():
    """The leader dies: the follower's controller takes the lease and
    reconciles the in-flight gang and new ones — in both packages."""

    def drive(m):
        api = m.client.APIServer()
        cs = m.client.Clientset(api)

        def build(identity):
            config = m.factory.PluginConfig(identity=identity, leader_poll_seconds=0.05,
                                            lease_renew_seconds=0.2,
                                            controller_resync_seconds=0.1, **m.kw)
            lease = m.leader.APILease(api, default_duration=1.0)
            return m.factory.new_plugin_runtime(api, _Handle(m), config, lease=lease)

        rt_a, rt_b = build("replica-a"), build("replica-b")
        out = []
        try:
            rt_a.start()
            assert _wait(lambda: rt_a.lease.get() is not None)
            out.append(rt_a.lease.get().holder_identity)
            cs.podgroups().create(m.scen.make_sim_group("inflight", 2))
            assert _wait(lambda: rt_a.operation.status_cache.get("default/inflight") is not None)
            assert _wait(lambda: cs.podgroups().get("inflight").status.phase.value == "Pending")
            rt_b.start()
            # B polls the live lease several times without taking it
            assert _wait(lambda: rt_a.lease.get().renew_time > 0)
            time.sleep(0.5)  # B's poll interval is 0.05 s: ten chances to misbehave
            out.append(rt_a.lease.get().holder_identity)
            out.append(rt_b.operation.status_cache.get("default/inflight") is None)
            rt_a.stop()
            assert _wait(lambda: rt_b.lease.get() is not None
                         and rt_b.lease.get().holder_identity == "replica-b", timeout=10.0)
            assert _wait(lambda: rt_b.operation.status_cache.get("default/inflight")
                         is not None, timeout=10.0)
            cs.podgroups().create(m.scen.make_sim_group("post-failover", 2))
            assert _wait(lambda: cs.podgroups().get("post-failover").status.phase.value
                         == "Pending", timeout=10.0)
            out.append(rt_b.lease.get().holder_identity)
        finally:
            rt_a.stop()
            rt_b.stop()
        return out

    ref, port = both(drive)
    assert port == ref == ["replica-a", "replica-a", True, "replica-b"]


def test_port_runtime_refuses_what_it_lacks():
    """The port's config no longer lacks the compile warmer: it takes the
    reference's flag as the reference does (the bucket warmer), and its
    default device is the card."""
    m = _pkg("batch_scheduler_tpu_torch")
    assert m.factory.PluginConfig(oracle_compile_warmer=True).oracle_compile_warmer
    assert not m.factory.PluginConfig().oracle_compile_warmer
    assert m.factory.PluginConfig().device == "cuda"
