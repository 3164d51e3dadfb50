"""The port's whole in-process stack (API server, informers, scheduler with
its whole-gang fast lane, plugin, controller, leader gate, sim kubelet:
``sim.SimCluster``) on the CPU against the JAX reference's ``SimCluster``.

Each of tests/test_sim_e2e.py's scenarios runs through both packages with
the same steps; the port must reach the same per-gang final phase and
bound count, the same set of admitted gangs and the same lifecycle-ledger
event kinds per gang, and pass the reference test's own assertions. A
seeded 200-node x 40-gang cluster, every pod queued before the scheduler
starts, runs with both scorers: there the node of every pod must match too
(the serial scorer places pod by pod; the oracle's fast lane seats a
gang's members on its plan's nodes in queue-set order, so there each
gang's multiset of nodes is compared). Exact equality throughout.

Synchronisation is by ``wait_for`` on state with generous timeouts.
"""

import importlib
import random
import threading
import time
import types as pytypes

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
TIMEOUT = 30.0


def _pkg(name):
    ns = pytypes.SimpleNamespace(name=name)
    ns.sim = importlib.import_module(f"{name}.sim")
    ns.scen = importlib.import_module(f"{name}.sim.scenarios")
    ns.types = importlib.import_module(f"{name}.api.types")
    ns.ledger = importlib.import_module(f"{name}.utils.lifecycle").DEFAULT_LEDGER
    ns.capacity = importlib.import_module(f"{name}.ops.capacity")
    return ns


@pytest.fixture
def run():
    """``run(scenario, **kwargs)`` builds one SimCluster per package (the
    port's on the CPU), drives ``scenario(m, cluster)`` on each, the two
    side by side on their own threads (the packages share no state), and
    returns the two summaries (reference, port); every cluster is stopped.
    A scenario's failure in either package is raised here."""
    clusters = []

    def one(name, scenario, kwargs, out, i):
        m = _pkg(name)
        kw = dict(kwargs)
        if name.endswith("_torch"):
            kw["device"] = "cpu"
        try:
            c = m.sim.SimCluster(**kw)
            clusters.append(c)
            try:
                out[i] = ("ok", scenario(m, c))
            finally:
                c.stop()
        except BaseException as e:  # noqa: BLE001 — re-raised by go()
            out[i] = ("error", e)

    def go(scenario, **kwargs):
        out = [None, None]
        threads = [
            threading.Thread(target=one, args=(name, scenario, kwargs, out, i),
                             name=f"sim-{name}", daemon=True)
            for i, name in enumerate(PACKAGES)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240.0)
        for name, t, res in zip(PACKAGES, threads, out):
            assert not t.is_alive(), f"{name}: scenario still running"
            if res[0] == "error":
                raise AssertionError(f"{name}: {res[1]!r}") from res[1]
        return [res[1] for res in out]

    yield go
    for c in clusters:
        c.stop()


def _summary(m, c, gangs, namespace="default"):
    """Per gang: final phase, bound members, whether it was admitted
    (a permit event), and the ledger's event kinds."""
    view = m.ledger.snapshot()["gangs"]
    out = {}
    for g in gangs:
        key = f"{namespace}/{g}"
        kinds = sorted({e["event"] for e in view.get(key, {}).get("events", [])})
        bound = sum(1 for p in c.member_pods(g, namespace) if p.spec.node_name)
        out[g] = {
            "phase": c.group_phase(g, namespace).value,
            "bound": bound,
            "admitted": "permit" in kinds,
            "kinds": kinds,
        }
    return out


def _unlabel(pods):
    for p in pods:
        p.metadata.labels = {}
    return pods


@pytest.mark.parametrize("scorer", ["oracle", "serial"])
def test_race_scenario_end_to_end(run, scorer):
    def scenario(m, c):
        nodes, groups, pods = m.scen.race_scenario()
        c.add_nodes(nodes)
        sysload = _unlabel(m.scen.make_member_pods("sysload", 1, {"cpu": "900m"}))[0]
        sysload.spec.node_name = "node-1"
        c.clientset.pods().create(sysload)
        for pg in groups:
            c.create_group(pg)
        c.start()
        for group_pods in pods.values():
            c.create_pods(group_pods)
        P = m.types.PodGroupPhase
        assert c.wait_for_bound("web-group-race1", 5, timeout=TIMEOUT), c.scheduler.stats
        assert c.wait_for_group_phase("web-group-race1", P.RUNNING, timeout=TIMEOUT)
        # the loser is denied at least once before its summary is read
        assert c.wait_for(lambda: c.scheduler.stats["unschedulable"] >= 1, timeout=TIMEOUT)
        assert [p for p in c.member_pods("web-group-race2") if p.spec.node_name] == []
        assert c.group_phase("web-group-race2") in (P.PENDING, P.PRE_SCHEDULING)
        return _summary(m, c, ["web-group-race1", "web-group-race2"])

    ref, port = run(scenario, scorer=scorer)
    assert port == ref
    assert port["web-group-race1"]["bound"] == 5
    assert port["web-group-race2"]["admitted"] is False


def test_multi_node_gang_spreads_and_runs(run):
    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node(f"n{i}", {"cpu": "4", "memory": "16Gi",
                                                     "pods": "20"}) for i in range(4)])
        c.create_group(m.scen.make_sim_group("wide", 12))
        c.start()
        c.create_pods(m.scen.make_member_pods("wide", 12, {"cpu": "1"}))
        assert c.wait_for_bound("wide", 12, timeout=TIMEOUT), c.scheduler.stats
        assert c.wait_for_group_phase("wide", m.types.PodGroupPhase.RUNNING, timeout=TIMEOUT)
        used = sorted(p.spec.node_name for p in c.member_pods("wide"))
        return _summary(m, c, ["wide"]), len(set(used))

    ref, port = run(scenario, scorer="oracle")
    assert port == ref
    # 12 x 1 cpu over 4 x 4 cpu nodes: best fit packs exactly 3 nodes
    assert port[1] == 3


def _fragmented(m, c):
    c.add_nodes([m.scen.make_sim_node(f"n{i}", {"cpu": "2", "pods": "10"}) for i in range(3)])
    c.create_group(m.scen.make_sim_group("frag", 4, max_schedule_time=1.0))
    c.start()
    c.create_pods(m.scen.make_member_pods("frag", 4, {"cpu": "1500m"}))


def test_gang_timeout_aborts_partial_gang_serial(run):
    def scenario(m, c):
        _fragmented(m, c)
        op = c.runtime.operation
        assert c.wait_for(lambda: (pgs := op.status_cache.get("default/frag")) is not None
                          and len(pgs.matched_pod_nodes.items()) > 0, timeout=TIMEOUT)
        assert c.wait_for(lambda: op.last_denied_pg.contains("default/frag"), timeout=TIMEOUT)
        assert c.wait_for(lambda: len(c.scheduler.waiting) == 0, timeout=TIMEOUT)
        assert all(not p.spec.node_name for p in c.member_pods("frag"))
        s = _summary(m, c, ["frag"])
        # the TTL abort ran: members were permitted (parked), none bound
        return s["frag"]["bound"], c.scheduler.stats["permit_waits"] > 0

    ref, port = run(scenario, scorer="serial")
    assert port == ref == (0, True)


def test_oracle_rejects_fragmented_gang_upfront(run):
    def scenario(m, c):
        _fragmented(m, c)
        op = c.runtime.operation
        assert c.wait_for(lambda: op.last_denied_pg.contains("default/frag"), timeout=TIMEOUT)
        assert c.scheduler.stats["permit_waits"] == 0
        assert all(not p.spec.node_name for p in c.member_pods("frag"))
        return _summary(m, c, ["frag"])

    ref, port = run(scenario, scorer="oracle")
    assert port == ref
    assert port["frag"]["kinds"] == ["admitted", "arrival", "deny"]


def test_non_group_pods_schedule_immediately(run):
    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node("n1", {"cpu": "4", "pods": "10"})])
        c.start()
        solo = _unlabel(m.scen.make_member_pods("solo", 2, {"cpu": "1"}))
        c.create_pods(solo)
        assert c.wait_for(lambda: all(c.clientset.pods().get(p.metadata.name).spec.node_name
                                      for p in solo), timeout=TIMEOUT)
        return sorted(c.clientset.pods().get(p.metadata.name).spec.node_name for p in solo)

    ref, port = run(scenario, scorer="oracle")
    assert port == ref == ["n1", "n1"]


def _online(m, cpu):
    return _unlabel(m.scen.make_member_pods("online", 1, {"cpu": cpu}, priority=10))


def test_preemption_evicts_pending_gang_member_only(run):
    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node("n1", {"cpu": "4", "pods": "10"})])
        c.create_group(m.scen.make_sim_group("lowgang", 4))
        c.start()
        c.create_pods(m.scen.make_member_pods("lowgang", 3, {"cpu": "1"}))
        op = c.runtime.operation
        assert c.wait_for(lambda: (pgs := op.status_cache.get("default/lowgang")) is not None
                          and len(pgs.matched_pod_nodes.items()) == 3, timeout=TIMEOUT)
        c.create_pods(_online(m, "2"))
        assert c.wait_for(lambda: c.clientset.pods().get("online-0").spec.node_name,
                          timeout=TIMEOUT), c.scheduler.stats
        assert c.scheduler.stats["preemptions"] >= 1
        return len(c.member_pods("lowgang")), c.clientset.pods().get("online-0").spec.node_name

    ref, port = run(scenario, scorer="oracle")
    assert port == ref == (2, "n1")


def test_preemption_never_touches_running_gang(run):
    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node("n1", {"cpu": "4", "pods": "10"})])
        c.create_group(m.scen.make_sim_group("rungang", 3))
        c.start()
        c.create_pods(m.scen.make_member_pods("rungang", 3, {"cpu": "1"}))
        assert c.wait_for_group_phase("rungang", m.types.PodGroupPhase.RUNNING, timeout=TIMEOUT)
        before = c.scheduler.stats["unschedulable"]
        c.create_pods(_online(m, "2"))
        # the online pod's cycles ran (each one tries preemption first)
        assert c.wait_for(lambda: c.scheduler.stats["unschedulable"] >= before + 2,
                          timeout=TIMEOUT)
        assert not c.clientset.pods().get("online-0").spec.node_name
        assert c.scheduler.stats["preemptions"] == 0
        return _summary(m, c, ["rungang"])

    ref, port = run(scenario, scorer="oracle")
    assert port == ref
    assert port["rungang"]["bound"] == 3


def _pinned(m, name, n, cpu, zone, priority=0):
    pods = m.scen.make_member_pods(name, n, {"cpu": cpu}, priority=priority)
    for p in pods:
        p.spec.node_selector = {"zone": zone}
    return pods


def _two_zones(m, c):
    c.add_nodes([m.scen.make_sim_node("n1", {"cpu": "4", "pods": "10"}, labels={"zone": "a"}),
                 m.scen.make_sim_node("n2", {"cpu": "4", "pods": "10"}, labels={"zone": "b"})])


def test_preemption_picks_fewest_victims_node(run):
    def scenario(m, c):
        _two_zones(m, c)
        c.create_group(m.scen.make_sim_group("ganga", 4))
        c.create_group(m.scen.make_sim_group("gangb", 2))
        c.start()
        c.create_pods(_pinned(m, "ganga", 3, "1", "a"))
        c.create_pods(_pinned(m, "gangb", 1, "2", "b"))
        op = c.runtime.operation
        assert c.wait_for(lambda: (a := op.status_cache.get("default/ganga")) is not None
                          and len(a.matched_pod_nodes.items()) == 3
                          and (b := op.status_cache.get("default/gangb")) is not None
                          and len(b.matched_pod_nodes.items()) == 1, timeout=TIMEOUT)
        c.create_pods(_online(m, "3"))
        assert c.wait_for(lambda: c.clientset.pods().get("online-0").spec.node_name,
                          timeout=TIMEOUT), c.scheduler.stats
        assert c.scheduler.stats["preemptions"] >= 1
        return (c.clientset.pods().get("online-0").spec.node_name,
                len(c.member_pods("ganga")), len(c.member_pods("gangb")))

    ref, port = run(scenario, scorer="oracle")
    assert port == ref == ("n2", 3, 0)


def test_preemption_prefers_low_priority_victims_over_fewest(run):
    def scenario(m, c):
        _two_zones(m, c)
        c.create_group(m.scen.make_sim_group("highgang", 2))
        c.create_group(m.scen.make_sim_group("lowgang", 3))
        c.start()
        c.create_pods(_pinned(m, "highgang", 1, "2", "a", priority=5))
        c.create_pods(_pinned(m, "lowgang", 2, "1", "b"))
        op = c.runtime.operation
        assert c.wait_for(lambda: (h := op.status_cache.get("default/highgang")) is not None
                          and len(h.matched_pod_nodes.items()) == 1
                          and (lo := op.status_cache.get("default/lowgang")) is not None
                          and len(lo.matched_pod_nodes.items()) == 2, timeout=TIMEOUT)
        c.create_pods(_online(m, "3"))
        assert c.wait_for(lambda: c.clientset.pods().get("online-0").spec.node_name,
                          timeout=TIMEOUT), c.scheduler.stats
        return (c.clientset.pods().get("online-0").spec.node_name,
                len(c.member_pods("highgang")), len(c.member_pods("lowgang")))

    ref, port = run(scenario, scorer="oracle")
    assert port == ref == ("n2", 1, 1)


def test_new_extended_resource_after_first_batch(run):
    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node("n1", {"cpu": "8", "pods": "20"})])
        c.create_group(m.scen.make_sim_group("plain", 2))
        c.start()
        c.create_pods(m.scen.make_member_pods("plain", 2, {"cpu": "1"}))
        assert c.wait_for(lambda: c.scheduler.stats["binds"] >= 2, timeout=TIMEOUT)
        c.create_group(m.scen.make_sim_group("accel", 2))
        c.create_pods(m.scen.make_member_pods("accel", 2, {"cpu": "1", "fake.com/npu": "1"}))
        assert c.wait_for(lambda: c.scheduler.stats["unschedulable"] >= 2, timeout=TIMEOUT)
        assert [p for p in c.member_pods("accel") if p.spec.node_name] == []
        assert c.scheduler.stats["binds"] == 2
        c.create_group(m.scen.make_sim_group("after", 2))
        c.create_pods(m.scen.make_member_pods("after", 2, {"cpu": "1"}))
        assert c.wait_for(lambda: c.scheduler.stats["binds"] >= 4, timeout=TIMEOUT)
        return {g: (s["bound"], s["admitted"]) for g, s in
                _summary(m, c, ["plain", "accel", "after"]).items()}

    ref, port = run(scenario, scorer="oracle")
    assert port == ref
    assert port["accel"] == (0, False)


def test_capacity_observatory_in_sim_verdict(run, monkeypatch):
    monkeypatch.setenv("BST_CAPACITY", "1")
    monkeypatch.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")

    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node(f"c{i}", {"cpu": "8", "pods": "64"}) for i in range(4)])
        for t in range(2):
            c.create_group(m.scen.make_sim_group(f"capg{t}", 2, namespace=f"team-{t}",
                                                 creation_ts=float(t)))
        c.start()
        for t in range(2):
            c.create_pods(m.scen.make_member_pods(f"capg{t}", 2, {"cpu": "1"},
                                                  namespace=f"team-{t}"))
            assert c.wait_for(lambda t=t: sum(1 for p in c.member_pods(f"capg{t}", f"team-{t}")
                                              if p.spec.node_name) >= 2, timeout=TIMEOUT)
        report = c.capacity()
        assert report["samples"] >= 1, report
        last = report["last"]
        assert last["placed"]["gangs"] >= 1
        tenants = {t["tenant"] for t in last["tenants"]}
        assert {"team-0", "team-1"} & tenants, tenants
        sums = {}
        for t in last["tenants"]:
            for lane, share in t["shares"].items():
                sums[lane] = sums.get(lane, 0.0) + share
        assert all(v <= 1.000001 for v in sums.values()), sums
        sampler = m.capacity.active_sampler()
        line = m.capacity.format_capacity_verdict(sampler.last(), sampler.lane_names())
        assert line.startswith("capacity: frag ") and "busiest lane cpu" in line
        recs = c.decisions("team-0/capg0").get("team-0/capg0") or []
        assert recs and all(r.get("tenant") == "team-0" for r in recs), recs[:2]
        # the reference's epoch-old creation stamps put these gangs past
        # the controller's 48 h GC horizon, so whether one is reported
        # Scheduled or Running yet is a race: phases are left out here
        summaries = [_summary(m, c, [f"capg{t}"], f"team-{t}")[f"capg{t}"] for t in range(2)]
        return sorted(tenants), [{k: v for k, v in s.items() if k != "phase"}
                                 for s in summaries]

    ref, port = run(scenario, scorer="oracle")
    assert port == ref


# -- a seeded 200-node x 40-gang cluster, every pod queued before start -----

SEEDED_NODES, SEEDED_GANGS = 200, 40


def _seeded_spec(seed=5):
    rng = random.Random(seed)
    nodes = [(f"s{i:03d}", rng.choice(["4", "8", "16"]), rng.choice(["a", "b", "c"]))
             for i in range(SEEDED_NODES)]
    gangs = []
    for g in range(SEEDED_GANGS):
        members = rng.randrange(2, 12)
        cpu = rng.choice(["1", "2", "3"])
        zone = rng.choice(["", "", "a"])
        gangs.append((f"sg{g:02d}", members, cpu, zone, rng.choice([0, 0, 1])))
    return nodes, gangs


def _start_settled(c, total):
    """``SimCluster.start()`` with the scheduler held back until the run's
    inputs are settled: the PodGroup informer and status cache synced and
    the controller's ""->Pending sweep done (so every pod's queue key sees
    its group's creation stamp), then every pod created and queued. And
    each whole-gang transaction is committed before the next gang's cycle
    (``FLUSH_GANGS = 1``): with the default cross-gang buffer, whether a
    permitted gang's binds are flushed before the next gang's batch is a
    wall-clock race, which moves later gangs' plans in the reference as in
    the port."""
    c._started = True
    c._fwk_informers.start()
    c.runtime.start()
    c.kubelet.start()
    c._fwk_informers.wait_for_cache_sync()
    c.runtime.informers.wait_for_cache_sync()
    c._wait_for_status_cache()
    assert c.wait_for(lambda: all((pg.get("status") or {}).get("phase")
                                  for pg in c.api.list("PodGroup")), timeout=TIMEOUT)


@pytest.mark.parametrize("scorer", ["oracle", "serial"])
def test_seeded_cluster_matches_reference(run, scorer):
    nodes_spec, gangs_spec = _seeded_spec()

    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node(name, {"cpu": cpu, "memory": "64Gi", "pods": "110"},
                                          labels={"zone": zone})
                     for name, cpu, zone in nodes_spec])
        all_pods = []
        # recent stamps in gang order: epoch-old ones would trip the
        # controller's 48 h GC horizon and leave the gangs Scheduled
        base_ts = time.time() - 1.0
        for g, (name, members, cpu, zone, prio) in enumerate(gangs_spec):
            c.create_group(m.scen.make_sim_group(name, members,
                                                 creation_ts=base_ts + g * 1e-3))
            pods = m.scen.make_member_pods(name, members, {"cpu": cpu, "memory": "1Gi"},
                                           priority=prio)
            for p in pods:
                if zone:
                    p.spec.node_selector = {"zone": zone}
            all_pods.extend(pods)
        total = len(all_pods)
        _start_settled(c, total)
        c.create_pods(all_pods)
        assert c.wait_for(lambda: len(c.scheduler.queue) == total, timeout=TIMEOUT)
        c.scheduler.FLUSH_GANGS = 1
        c.scheduler.start()
        assert c.wait_for(lambda: c.scheduler.stats["binds"] >= total, timeout=60.0), \
            c.scheduler.stats
        names = [g[0] for g in gangs_spec]
        assert c.wait_for(lambda: all(c.group_phase(n) == m.types.PodGroupPhase.RUNNING
                                      for n in names), timeout=TIMEOUT)
        placement = {}
        for n in names:
            pods = c.member_pods(n)
            if scorer == "serial":
                placement[n] = sorted((p.metadata.name, p.spec.node_name) for p in pods)
            else:
                # the fast lane seats a gang's queued members in set order
                placement[n] = sorted(p.spec.node_name for p in pods)
        return _summary(m, c, names), placement

    ref, port = run(scenario, scorer=scorer)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert all(s["bound"] == s["admitted"] * len(port[1][g]) for g, s in port[0].items())
