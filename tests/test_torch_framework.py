"""The port's scheduling-framework host structures against the JAX
reference's, on seeded inputs, with exact equality: the scheduling queue
(pop order under the operation's sort key, gang drains, backoff and its
promotion), ``ScheduleOperation.sort_key``, ``WaitingPods``, the
controller's ``RateLimitingQueue`` under a fake clock, ``create_merge_patch``
and the API serde round trip, and the event-log names by kind each new
``ClusterState`` method emits (the scorer's fold proof rests on them).

Both packages are driven the same way through ``importlib``; the JAX
package is imported only inside the tests, with ``JAX_PLATFORMS=cpu``
(tests/conftest.py) and nothing in it touching a device.
"""

import importlib
import random

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
SEEDS = (0, 1, 2)


def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


class _Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _seeded_world(seed):
    """Seeded queue input: (groups, pods) as plain tuples, shared by both
    packages. groups: name -> (namespace, creation_ts); pods: (name,
    namespace, gang or "", priority)."""
    rng = random.Random(seed)
    groups = {}
    for g in range(6):
        # duplicated creation stamps exercise the reverse-name tiebreak
        groups[f"g{g}"] = (rng.choice(["default", "team-a"]), float(rng.randrange(3)))
    pods = []
    for i in range(40):
        gang = rng.choice(list(groups) + [""])
        ns = groups[gang][0] if gang else rng.choice(["default", "team-a"])
        pods.append((f"p{i:02d}", ns, gang, rng.choice([0, 0, 1, 5])))
    return groups, pods


def _typed(pkg, groups, pods):
    scen = _m(pkg, "sim.scenarios")
    pgs = {
        (ns, name): scen.make_sim_group(name, 2, namespace=ns, creation_ts=ts)
        for name, (ns, ts) in groups.items()
    }
    typed = []
    for name, ns, gang, prio in pods:
        p = scen.make_member_pods(gang or "solo", 1, {"cpu": "1"}, priority=prio,
                                  namespace=ns)[0]
        p.metadata.name = name
        if not gang:
            p.metadata.labels = {}
        typed.append(p)
    return pgs, typed


def _operation(pkg, pgs, clock):
    core = _m(pkg, "core.operation")
    cache = _m(pkg, "cache.pg_cache").PGStatusCache()
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    return core.ScheduleOperation(
        cache, None, pg_lister=lambda ns, name: pgs.get((ns, name)),
        scorer="serial", clock=clock, **kw,
    )


def _drive_queue(pkg, seed):
    """Push the seeded pods, move a seeded third to backoff, drain a gang,
    then pop everything as the clock advances; the trace of every step."""
    groups, pods = _seeded_world(seed)
    pgs, typed = _typed(pkg, groups, pods)
    clock = _Clock()
    op = _operation(pkg, pgs, clock)
    types = _m(pkg, "framework.types")
    sched = _m(pkg, "framework.scheduler")
    q = _m(pkg, "framework.queue").SchedulingQueue(
        None, backoff_base=1.0, backoff_cap=4.0, clock=clock,
        group_key_fn=sched._gang_key, sort_key_fn=op.sort_key,
    )
    rng = random.Random(seed + 100)
    trace = []
    try:
        infos = []
        for p in typed:
            clock.now += 0.001
            info = types.PodInfo(pod=p, timestamp=clock.now)
            infos.append(info)
            q.push(info)
        trace.append(("len", len(q)))
        trace.append(("sizes", [q.group_size(f"{groups[g][0]}/{g}") for g in sorted(groups)]))
        # a third of the first pops go to backoff (attempts grow the delay)
        for _ in range(12):
            info = q.pop(timeout=0)
            trace.append(("pop", info.name))
            if rng.random() < 0.4:
                q.push_backoff(info)
                q.push_backoff(info) if rng.random() < 0.3 else None
                trace.append(("backoff", info.name, info.attempts))
        gang = sorted(groups)[seed % len(groups)]
        drained = q.pop_group(f"{groups[gang][0]}/{gang}")
        trace.append(("drain", sorted(i.name for i in drained)))
        while (info := q.pop(timeout=0)) is not None:
            trace.append(("pop", info.name))
        # nothing due yet: the backed-off entries come back as time passes
        for step in range(6):
            clock.now += 1.0
            # promote what is due now (the flusher thread does the same
            # on its own tick; either way the same entries move)
            with q._cond:
                q._promote_locked()
            while (info := q.pop(timeout=0)) is not None:
                trace.append(("due", step, info.name))
        trace.append(("len", len(q)))
    finally:
        q.close()
    return trace


@pytest.mark.parametrize("seed", SEEDS)
def test_queue_traces_match_reference(seed):
    ref, port = (_drive_queue(pkg, seed) for pkg in PACKAGES)
    assert port == ref
    assert ("len", 0) == port[-1]
    assert any(step[0] == "due" for step in port)  # backoff promotion ran


@pytest.mark.parametrize("seed", SEEDS)
def test_sort_key_orders_match_reference(seed):
    orders = []
    for pkg in PACKAGES:
        groups, pods = _seeded_world(seed)
        pgs, typed = _typed(pkg, groups, pods)
        clock = _Clock()
        op = _operation(pkg, pgs, clock)
        types = _m(pkg, "framework.types")
        infos = [types.PodInfo(pod=p, timestamp=float(i % 7)) for i, p in enumerate(typed)]
        # an unobserved gang sorts after known gangs of its priority (+inf)
        ghost = _m(pkg, "sim.scenarios").make_member_pods("ghost", 1, {"cpu": "1"})[0]
        infos.append(types.PodInfo(pod=ghost, timestamp=0.0))
        by_key = sorted(infos, key=lambda i: (op.sort_key(i), i.seq))
        orders.append([i.name for i in by_key])
        # the key agrees with compare() wherever compare gives an order
        for a in infos[:15]:
            for b in infos[:15]:
                if op.compare(a.pod, a.timestamp, b.pod, b.timestamp):
                    assert op.sort_key(a) < op.sort_key(b) or (
                        op.sort_key(a) == op.sort_key(b)
                    ), (a.name, b.name)
        # a deleted group's stamp is tombstoned: the cache does not keep it
        name, (ns, _) = sorted(groups.items())[0]
        op._forget_creation(f"{ns}/{name}")
        assert (ns, name) not in op._creation_cache
    assert orders[1] == orders[0]


def _drive_waiting(pkg):
    w = _m(pkg, "framework.waiting")
    scen = _m(pkg, "sim.scenarios")
    clock = _Clock()
    reg = w.WaitingPods(clock)
    pods = scen.make_member_pods("g", 4, {"cpu": "1"})
    trace = []
    try:
        wps = [w.WaitingPod(p, f"n{i}", clock.now + 1.0 + i) for i, p in enumerate(pods)]
        for wp in wps:
            reg.park(wp)
        trace.append(("len", len(reg)))
        trace.append(("allow", wps[0].allow("batch-scheduler"), wps[0].allow("x")))
        trace.append(("reject", wps[1].reject("Group failed"), wps[1].allow("x")))
        seen = []
        reg.iterate(lambda wp: seen.append(wp.node_name))
        trace.append(("iterate", sorted(seen)))
        clock.now += 3.5  # wps[2]'s deadline passes, wps[3]'s not
        outcomes = []
        for _ in range(3):
            wp, outcome, message = reg.resolved.get(timeout=10.0)
            outcomes.append((wp.node_name, outcome, message))
        trace.append(("resolved", outcomes))
        trace.append(("left", len(reg), reg.get(pods[3].metadata.uid) is wps[3],
                      reg.get(pods[0].metadata.uid)))
    finally:
        reg.close()
    return trace


def test_waiting_pods_match_reference():
    ref, port = (_drive_waiting(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port[-2][1][-1] == ("n2", "timeout", "permit wait deadline exceeded")


def _drive_workqueue(pkg, seed):
    clock = _Clock()
    q = _m(pkg, "utils.workqueue").RateLimitingQueue(base_delay=0.5, max_delay=4.0,
                                                      clock=clock)
    rng = random.Random(seed)
    keys = [f"ns/k{i}" for i in range(5)]
    trace = []
    for _ in range(30):
        op = rng.choice(["add", "limited", "after", "get", "forget", "tick"])
        key = rng.choice(keys)
        if op == "add":
            q.add(key)
        elif op == "limited":
            q.add_rate_limited(key)
        elif op == "after":
            q.add_after(key, rng.choice([0.0, 0.25, 1.0]))
        elif op == "forget":
            q.forget(key)
        elif op == "tick":
            clock.now += rng.choice([0.25, 0.5, 2.0])
        else:
            got = q.get(timeout=0)
            trace.append(("got", got))
            if got is not None:
                if rng.random() < 0.5:
                    q.add(got)  # re-added while processing: dirty
                q.done(got)
        trace.append((op, len(q)))
    clock.now += 10.0
    while (got := q.get(timeout=0)) is not None:
        trace.append(("drain", got))
        q.done(got)
    q.shut_down()
    trace.append(("shut", q.get(timeout=0), q.is_shut_down()))
    return trace


@pytest.mark.parametrize("seed", SEEDS)
def test_rate_limiting_queue_matches_reference(seed):
    ref, port = (_drive_workqueue(pkg, seed) for pkg in PACKAGES)
    assert port == ref


def _seeded_doc(rng, depth=0):
    doc = {}
    for i in range(rng.randrange(1, 5)):
        kind = rng.choice(["int", "str", "none", "list", "dict"] if depth < 2
                          else ["int", "str", "none"])
        key = f"k{i}"
        if kind == "int":
            doc[key] = rng.randrange(5)
        elif kind == "str":
            doc[key] = rng.choice(["a", "b", ""])
        elif kind == "none":
            doc[key] = None
        elif kind == "list":
            doc[key] = [rng.randrange(3) for _ in range(rng.randrange(3))]
        else:
            doc[key] = _seeded_doc(rng, depth + 1)
    return doc


def _mutate(rng, doc):
    out = {}
    for k, v in doc.items():
        r = rng.random()
        if r < 0.2:
            continue  # removed
        if isinstance(v, dict) and r < 0.7:
            out[k] = _mutate(rng, v)
        elif r < 0.45:
            out[k] = rng.choice([7, "z", None, [1], {"n": 1}])
        else:
            out[k] = v
    if rng.random() < 0.5:
        out[f"new{rng.randrange(3)}"] = rng.randrange(9)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_patch_matches_reference(seed):
    results = []
    for pkg in PACKAGES:
        patch = _m(pkg, "utils.patch")
        rng = random.Random(seed)
        out = []
        for _ in range(25):
            old = _seeded_doc(rng)
            new = _mutate(rng, old)
            p = patch.create_merge_patch(old, new)
            applied = patch.apply_merge_patch(patch.json_deepcopy(old), p)
            out.append((p, applied))
        results.append(out)
    assert results[1] == results[0]
    # the reference's own contract, held on the port's answers: a None
    # patch value deletes, and applying the patch gives the new document
    # up to explicit nulls
    for p, applied in results[1]:
        assert isinstance(p, dict) and isinstance(applied, dict)


@pytest.mark.parametrize("seed", SEEDS)
def test_serde_round_trip_matches_reference(seed):
    results = []
    for pkg in PACKAGES:
        scen = _m(pkg, "sim.scenarios")
        types = _m(pkg, "api.types")
        serde = _m(pkg, "api.serde")
        rng = random.Random(seed)
        out = []
        for i in range(6):
            pg = scen.make_sim_group(f"rt{i}", rng.randrange(1, 9),
                                     namespace=rng.choice(["default", "t"]),
                                     creation_ts=rng.random())
            pg.metadata.uid = f"pg-{i}"
            pg.spec.min_resources = {"cpu": 1000 * rng.randrange(1, 5)}
            pg.status.phase = types.PodGroupPhase(rng.choice(["Pending", "Scheduling", "Running"]))
            pg.status.scheduled = rng.randrange(5)
            pod = scen.make_member_pods(f"rt{i}", 1, {"cpu": "2", "memory": "1Gi"},
                                        priority=rng.randrange(3))[0]
            pod.metadata.uid = f"pod-{i}"
            pod.spec.node_selector = {"zone": rng.choice(["a", "b"])}
            pod.spec.node_name = rng.choice(["", "n1"])
            node = scen.make_sim_node(f"n{i}", {"cpu": str(rng.randrange(1, 64)),
                                                "pods": "110"},
                                      labels={"zone": "a"})
            node.metadata.uid = f"node-{i}"
            node.spec.unschedulable = rng.random() < 0.3
            for obj, kind in ((pg, "PodGroup"), (pod, "Pod"), (node, "Node")):
                d = types.to_dict(obj)
                back = serde.object_from_dict(kind, d)
                assert types.to_dict(back) == d
                out.append(d)
        results.append(out)
    assert results[1] == results[0]


class _Sink:
    def __init__(self):
        self.events = []

    def note(self, kind, names):
        self.events.append((kind, tuple(names)))


def _drive_cluster_events(pkg):
    fc = _m(pkg, "framework.cluster")
    scen = _m(pkg, "sim.scenarios")
    types = _m(pkg, "api.types")
    c = fc.ClusterState()
    for i in range(3):
        c.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"}))
    sink = _Sink()
    c.subscribe_events(sink.note)
    pods = scen.make_member_pods("g", 6, {"cpu": "1"})
    for i, p in enumerate(pods):
        p.metadata.uid = f"u{i}"
    trace = []

    def step(label, fn):
        v0 = c.version()
        fn()
        trace.append((label, c.version() - v0, list(sink.events)))
        sink.events.clear()

    step("assume_many", lambda: c.assume_many([(p, f"n{i % 2}") for i, p in enumerate(pods[:4])]))
    # re-seating an assumed pod elsewhere names both nodes
    step("assume_many_move", lambda: c.assume_many([(pods[0], "n2")]))
    trace.append(("assumed", [c.is_assumed(p.metadata.uid) for p in pods]))
    step("finish_binding_many", lambda: c.finish_binding_many([p.metadata.uid for p in pods[:2]]))
    trace.append(("assumed", [c.is_assumed(p.metadata.uid) for p in pods]))
    trace.append(("counts", [c.pod_count(f"n{i}") for i in range(3)]))

    def raw(p, node, phase="Running"):
        d = types.to_dict(p)
        d["spec"]["node_name"] = node
        d["status"]["phase"] = phase
        return d

    # the bind commit of an assumed pod: a no-op, the assume cleared
    step("observe_raw_commit", lambda: c.observe_pod_raw(raw(pods[2], "n0")))
    # an unknown placement: typed rehydration through observe_pod
    step("observe_raw_new", lambda: c.observe_pod_raw(raw(pods[4], "n1")))
    # unbound doc: ignored
    step("observe_raw_unbound", lambda: c.observe_pod_raw(raw(pods[5], "")))
    step("observe_raw_terminal", lambda: c.observe_pod_raw(raw(pods[1], "n1", "Succeeded")))
    step("remove_raw", lambda: c.remove_pod_raw(raw(pods[4], "n1")))
    step("remove_raw_unknown", lambda: c.remove_pod_raw({"metadata": {"uid": "nope"}}))
    trace.append(("counts", [c.pod_count(f"n{i}") for i in range(3)]))
    trace.append(("requested", [dict(c.node_requested(f"n{i}")) for i in range(3)]))
    return trace


def test_cluster_state_events_match_reference():
    ref, port = (_drive_cluster_events(pkg) for pkg in PACKAGES)
    assert port == ref
    # every version bump carries exactly one event (the fold's invariant)
    for entry in port:
        if len(entry) == 3 and isinstance(entry[1], int):
            assert entry[1] == len(entry[2]), entry
    assert ("node-requested", ("n2", "n0")) in port[1][2] or \
        ("node-requested", ("n0", "n2")) in port[1][2]


def test_pg_cache_for_each_matches_reference():
    seen = []
    for pkg in PACKAGES:
        cache_mod = _m(pkg, "cache.pg_cache")
        scen = _m(pkg, "sim.scenarios")
        cache = cache_mod.PGStatusCache()
        deleted = []
        cache.on_delete(deleted.append)
        for name in ("b", "a", "c"):
            pg = scen.make_sim_group(name, 2)
            cache.set(pg.full_name(), cache_mod.PodGroupMatchStatus(pg))
        cache.delete("default/c")
        out = []
        cache.for_each(lambda n, s: out.append((n, s.pod_group.spec.min_member)))
        seen.append((sorted(out), deleted, cache.mutations()))
    assert seen[1] == seen[0]


def test_nodes_requested_is_node_requested_in_one_pass():
    """The port's batch read (one lock pass for the scorer's pack) answers
    exactly ``node_requested`` for every node, and for a subset."""
    fc = _m(PACKAGES[1], "framework.cluster")
    scen = _m(PACKAGES[1], "sim.scenarios")
    c = fc.ClusterState()
    for i in range(4):
        c.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"}))
    pods = scen.make_member_pods("g", 5, {"cpu": "1", "memory": "1Gi"})
    c.assume_many([(p, f"n{i % 3}") for i, p in enumerate(pods)])
    every = c.nodes_requested()
    assert every == {f"n{i}": c.node_requested(f"n{i}") for i in range(4)}
    assert c.nodes_requested(["n2", "gone"]) == {"n2": c.node_requested("n2"), "gone": {}}


def test_in_place_status_sync_folds_as_a_gang_event():
    """The port's status cache: re-storing the entry already held (the
    controller's in-place status sync) is not membership churn; it fires
    ``on_update``, which an operation turns into a named gang event, so
    the next refresh folds (the reference counts it as churn and scans)
    and serves exactly the full pack's batch."""
    import numpy as np

    cm = _m(PACKAGES[1], "cache.pg_cache")
    scen = _m(PACKAGES[1], "sim.scenarios")
    fc = _m(PACKAGES[1], "framework.cluster")
    ops = _m(PACKAGES[1], "core.operation")
    scorer_mod = _m(PACKAGES[1], "core.oracle_scorer")
    snapshot = _m(PACKAGES[1], "ops.snapshot")
    oracle = _m(PACKAGES[1], "ops.oracle")

    cache = cm.PGStatusCache()
    heard = []
    cache.on_update(heard.append)
    pg = scen.make_sim_group("g", 2, creation_ts=1.0)
    pgs = cm.PodGroupMatchStatus(pg)
    cache.set("default/g", pgs)
    m0 = cache.mutations()
    cache.set("default/g", pgs)  # in place
    assert cache.mutations() == m0 and heard == ["default/g"]
    cache.set("default/g", cm.PodGroupMatchStatus(pg))  # a new entry
    assert cache.mutations() == m0 + 1 and heard == ["default/g"]

    cluster = fc.ClusterState()
    for i in range(4):
        cluster.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"}))
    cache = cm.PGStatusCache()
    for j in range(3):
        g = scen.make_sim_group(f"gang{j}", 3, creation_ts=float(j))
        g.spec.min_resources = {"cpu": 1000}
        cache.set(g.full_name(), cm.PodGroupMatchStatus(g))
    op = ops.ScheduleOperation(cache, cluster, scorer="oracle", device="cpu")
    op.oracle.refresh(cluster, cache)
    op.oracle.refresh(cluster, cache)
    assert op.oracle.last_fold_outcome == "folded"
    # the controller's sync: a status field moved, then the entry re-stored
    live = cache.get("default/gang1")
    live.pod_group.status.scheduled = 2
    cache.set("default/gang1", live)
    op.oracle.refresh(cluster, cache)
    assert op.oracle.last_fold_outcome == "folded"
    full = snapshot.ClusterSnapshot(*scorer_mod.read_cluster_inputs(cluster, cache))
    want, _ = oracle.execute_batch_host(full.device_args(), full.progress_args(), device="cpu")
    got = op.oracle._state.result
    for k in ("placed", "gang_feasible", "progress", "assignment_nodes", "assignment_counts"):
        assert np.array_equal(got[k], want[k]), k
    assert op.oracle.snapshot.progress_args()[1].tolist()[:3] == full.progress_args()[1].tolist()[:3]


def _bare_scorer_in_place_sync(pkg):
    """A bare scorer over a ``ClusterState`` and a status cache (no
    operation listens to the cache): two refreshes, a status field moved
    in place, the entry re-stored, a refresh. Returns the served result,
    the full pack's result and the fold outcome."""
    cm = _m(pkg, "cache.pg_cache")
    scen = _m(pkg, "sim.scenarios")
    fc = _m(pkg, "framework.cluster")
    scorer_mod = _m(pkg, "core.oracle_scorer")
    snapshot = _m(pkg, "ops.snapshot")
    oracle = _m(pkg, "ops.oracle")
    cpu = {"device": "cpu"} if pkg.endswith("_torch") else {}

    cluster = fc.ClusterState()
    for i in range(4):
        cluster.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"}))
    cache = cm.PGStatusCache()
    for j in range(3):
        g = scen.make_sim_group(f"gang{j}", 3, creation_ts=float(j))
        g.spec.min_resources = {"cpu": 1000}
        cache.set(g.full_name(), cm.PodGroupMatchStatus(g))
    scorer = scorer_mod.OracleScorer(**cpu)
    scorer.refresh(cluster, cache)
    scorer.refresh(cluster, cache)
    live = cache.get("default/gang1")
    live.pod_group.status.scheduled = 2
    cache.set("default/gang1", live)
    scorer.refresh(cluster, cache)
    full = snapshot.ClusterSnapshot(*scorer_mod.read_cluster_inputs(cluster, cache))
    want, _ = oracle.execute_batch_host(full.device_args(), full.progress_args(), **cpu)
    served = (scorer._state.result, scorer.snapshot.progress_args()[1].tolist()[:3])
    return served, want, getattr(scorer, "last_fold_outcome", None)


def test_bare_scorer_hears_an_in_place_status_sync():
    """A scorer wired to the status cache with no operation in between
    still hears of an entry re-stored in place: the refresh folds the
    named gang and serves the full pack's rows (progress ``[0, 2, 0]``),
    the JAX package's (which scans) bit for bit."""
    import numpy as np

    (ref, ref_scheduled), _, _ = _bare_scorer_in_place_sync(PACKAGES[0])
    (got, scheduled), want, outcome = _bare_scorer_in_place_sync(PACKAGES[1])
    assert outcome == "folded"
    assert scheduled == ref_scheduled == [0, 2, 0]
    for k in ("placed", "gang_feasible", "progress", "assignment_nodes", "assignment_counts"):
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_status_cache_forgets_a_collected_scorers_log():
    """The status cache holds a scorer's ``on_update`` subscription weakly:
    scorers wired one after another leave one live entry, not one each,
    and a re-stored entry after that still folds in the live scorer."""
    import gc

    cm = _m(PACKAGES[1], "cache.pg_cache")
    scen = _m(PACKAGES[1], "sim.scenarios")
    fc = _m(PACKAGES[1], "framework.cluster")
    scorer_mod = _m(PACKAGES[1], "core.oracle_scorer")

    cluster = fc.ClusterState()
    for i in range(4):
        cluster.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"}))
    cache = cm.PGStatusCache()
    g = scen.make_sim_group("gang0", 3, creation_ts=0.0)
    g.spec.min_resources = {"cpu": 1000}
    live = cm.PodGroupMatchStatus(g)
    cache.set(g.full_name(), live)
    for _ in range(5):
        scorer = scorer_mod.OracleScorer(device="cpu")
        scorer.refresh(cluster, cache)
        del scorer
        gc.collect()
    scorer = scorer_mod.OracleScorer(device="cpu")
    scorer.refresh(cluster, cache)  # its registration prunes the dead ones
    assert len(cache._on_update) == 1
    cache.set(g.full_name(), live)  # in place
    scorer.refresh(cluster, cache)
    assert scorer.last_fold_outcome == "folded"


@pytest.mark.parametrize("store", ["bound", "unbound", "unreachable"])
def test_kept_assume_released_only_on_a_fresh_read(store, monkeypatch):
    """A kept assume (a bind whose answer an outage cut) is released only
    when a read through the API server shows the pod unbound, not on the
    informer's view, which can predate the lost bind: the store has the pod
    bound while the informer still shows it unbound, and the charge must
    stay (the forget here let config 6 over the HTTP gateway bind a ninth
    1-GPU pod to an 8-GPU node across a restart). A failed read keeps the
    charge and the marker; a read showing the pod unbound releases it."""
    from batch_scheduler_tpu_torch.api.types import to_dict
    from batch_scheduler_tpu_torch.framework.types import PodInfo
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_node

    c = SimCluster(scorer="oracle", device="cpu")
    try:
        node = make_sim_node("n0", {"cpu": "1", "memory": "4Gi", "pods": "110"})
        c.add_nodes([node])
        c.cluster.add_node(node)
        pod = make_member_pods("x", 1, {"cpu": "1"})[0]
        pod.metadata.labels = {}
        c.create_pods([pod])
        pod.metadata.uid = c.api.get("Pod", "default", pod.metadata.name)["metadata"]["uid"]
        unbound_doc = to_dict(pod)
        sched = c.scheduler
        # the informer's view: the pod as created, unbound
        monkeypatch.setattr(sched._pod_informer, "peek_raw", lambda ns, name: unbound_doc)
        c.cluster.assume(pod, "n0")
        sched._kept_assumes.add(pod.metadata.uid)
        if store == "bound":
            c.api.bind_pods("default", [(pod.metadata.name, "n0")])
        if store == "unreachable":
            def down(*a, **k):
                raise OSError("connection refused")
            monkeypatch.setattr(sched.clientset, "pods", lambda ns: type(
                "Down", (), {"get": staticmethod(down)})())
        forgets = []
        real = c.cluster.forget
        monkeypatch.setattr(c.cluster, "forget", lambda uid: (forgets.append(uid), real(uid)))
        sched._schedule_one(PodInfo(pod=pod))
        if store == "unbound":
            assert forgets[:1] == [pod.metadata.uid]
        else:
            assert forgets == [] and c.cluster.is_assumed(pod.metadata.uid)
        assert (pod.metadata.uid in sched._kept_assumes) == (store == "unreachable")
        # the lost bind that applied is counted once, as found applied
        assert sched.binds_found_applied == (store == "bound")
    finally:
        c.stop()


@pytest.mark.parametrize("view", ["informer", "read"])
def test_a_lost_bind_found_applied_is_counted_once(view, monkeypatch):
    """A kept assume whose pod the liveness check already sees bound (the
    informer's copy, or a read without an informer) is a bind whose answer
    was lost and that applied: counted once in ``binds_found_applied``,
    never in ``stats["binds"]``, and a second queue entry of the pod (a
    relist's) counts nothing. So binds plus binds found applied is every
    pod bound, each once (config 6 over the HTTP gateway on the card)."""
    from batch_scheduler_tpu_torch.api.types import to_dict
    from batch_scheduler_tpu_torch.framework.types import PodInfo
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_node

    c = SimCluster(scorer="oracle", device="cpu")
    try:
        node = make_sim_node("n0", {"cpu": "1", "memory": "4Gi", "pods": "110"})
        c.add_nodes([node])
        c.cluster.add_node(node)
        pod = make_member_pods("x", 1, {"cpu": "1"})[0]
        pod.metadata.labels = {}
        c.create_pods([pod])
        pod.metadata.uid = c.api.get("Pod", "default", pod.metadata.name)["metadata"]["uid"]
        sched = c.scheduler
        c.cluster.assume(pod, "n0")
        sched._kept_assumes.add(pod.metadata.uid)
        c.api.bind_pods("default", [(pod.metadata.name, "n0")])
        bound_doc = to_dict(pod)
        bound_doc["spec"]["node_name"] = "n0"
        if view == "informer":
            monkeypatch.setattr(sched._pod_informer, "peek_raw", lambda ns, name: bound_doc)
        else:
            monkeypatch.setattr(sched, "_pod_informer", None)
        binds = sched.stats["binds"]
        for _ in range(2):
            sched._schedule_one(PodInfo(pod=pod))
        assert sched.binds_found_applied == 1 and sched.stats["binds"] == binds
        assert c.cluster.is_assumed(pod.metadata.uid)
    finally:
        c.stop()


def test_a_severed_per_pod_bind_cannot_land_after_the_read(monkeypatch):
    """The per-pod bind (the bind worker's) carries the gateway
    generation's bind epoch: a request of an old generation whose handler
    thread outlives a restart and reaches the store only after the new
    generation served the scheduler's read (``_store_state`` saw the
    pod unbound, so the assume may be forgotten) applies nothing. Sent as a
    per-pod PATCH of ``spec.node_name``, which no epoch fences, the late
    bind landed on a node the scheduler had already freed."""
    import threading

    from batch_scheduler_tpu_torch.client import APIServer, HTTPAPIServer, serve_gateway
    from batch_scheduler_tpu_torch.framework.types import PodInfo
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_node

    backing = APIServer()
    old = serve_gateway(backing)
    api = HTTPAPIServer(*old.server_address[:2], qps=0)
    c = SimCluster(scorer="oracle", device="cpu", api=api)
    new = reader = None
    try:
        node = make_sim_node("n0", {"cpu": "1", "memory": "4Gi", "pods": "110"})
        c.add_nodes([node])
        c.cluster.add_node(node)
        pod = make_member_pods("x", 1, {"cpu": "1"})[0]
        pod.metadata.labels = {}
        c.create_pods([pod])
        pod.metadata.uid = backing.get("Pod", "default", pod.metadata.name)["metadata"]["uid"]
        # hold the old generation's bind in its handler thread, whichever
        # route it takes into the store
        entered, release = threading.Event(), threading.Event()

        def hold(real):
            def held(*args, **kwargs):
                entered.set()
                release.wait(30)
                return real(*args, **kwargs)
            return held
        real_patch = backing.patch
        monkeypatch.setattr(backing, "bind_pods", hold(backing.bind_pods))
        monkeypatch.setattr(backing, "patch", lambda kind, ns, name, patch: (
            hold(real_patch) if (patch.get("spec") or {}).get("node_name") else real_patch
        )(kind, ns, name, patch))
        c.cluster.assume(pod, "n0")
        outcome = []
        worker = threading.Thread(target=lambda: outcome.append(
            c.scheduler._bind(pod, "n0")), daemon=True)
        worker.start()
        assert entered.wait(30)
        # the restart: a new generation over the same store, and the read
        # it serves shows the pod unbound
        new = serve_gateway(backing)
        reader = HTTPAPIServer(*new.server_address[:2], qps=0)
        assert not reader.get("Pod", "default", pod.metadata.name)["spec"].get("node_name")
        assert c.scheduler._store_state(PodInfo(pod=pod)) == "unbound"
        release.set()
        worker.join(30)
        assert outcome == [None]
        assert not backing.get("Pod", "default", pod.metadata.name)["spec"].get("node_name")
        assert not c.cluster.is_assumed(pod.metadata.uid)
    finally:
        c.stop()
        api.close()
        if reader is not None:
            reader.close()
        for gw in (old, new):
            if gw is not None:
                gw.shutdown()
                gw.server_close()


@pytest.mark.parametrize("owner", ["permit", "bound"])
def test_duplicate_entry_of_a_placed_pod_is_dropped(owner, monkeypatch):
    """A second queue entry of a pod this scheduler has already placed (an
    informer's relist re-adds it while it waits in Permit, or after its
    bind and before the informer's bound event) is dropped at pop: it never
    reaches PreFilter, and the placement's charge stays where it is.
    Scheduling the copy bound the pod a second time to another node, and
    its re-assume freed the first node while the store had it filled (config
    6 over the HTTP gateway over-committed nodes after a restart)."""
    from batch_scheduler_tpu_torch.api.types import to_dict
    from batch_scheduler_tpu_torch.framework.types import PodInfo
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_node

    c = SimCluster(scorer="oracle", device="cpu")
    try:
        for name in ("n0", "n1"):
            node = make_sim_node(name, {"cpu": "1", "memory": "4Gi", "pods": "110"})
            c.add_nodes([node])
            c.cluster.add_node(node)
        pod = make_member_pods("x", 1, {"cpu": "1"})[0]
        pod.metadata.labels = {}
        c.create_pods([pod])
        pod.metadata.uid = c.api.get("Pod", "default", pod.metadata.name)["metadata"]["uid"]
        sched = c.scheduler
        unbound_doc = to_dict(pod)
        monkeypatch.setattr(sched._pod_informer, "peek_raw", lambda ns, name: unbound_doc)
        c.cluster.assume(pod, "n0")
        if owner == "bound":
            c.cluster.finish_binding(pod.metadata.uid)
        calls = []
        monkeypatch.setattr(sched.plugin, "pre_filter", lambda p: calls.append(p))
        sched._schedule_one(PodInfo(pod=pod))
        assert calls == []
        assert c.cluster.pod_count("n0") == 1 and c.cluster.pod_count("n1") == 0
        assert c.cluster.is_assumed(pod.metadata.uid) == (owner == "permit")
    finally:
        c.stop()


def test_every_pod_queued_twice_binds_once():
    """F5: after an informer relist most queued pods have a second queue
    entry. The gang transaction counted its quorum over entries and took
    the popped pod's own second entry for a sibling, so the pod was seated
    twice, sent twice in one ``pods:bindmany`` and counted as two members
    (config 6 over the HTTP gateway counted 10,001 and 10,097 binds for
    10,000 pods). With every pod queued twice from the start, each pod is
    bound once, counted once, and no node holds more than it has. Exact
    counts, no tolerance."""
    import time

    from batch_scheduler_tpu_torch.framework.types import PodInfo
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)

    gangs, members = 6, 4
    c = SimCluster(scorer="oracle", device="cpu")
    queue = c.scheduler.queue
    push, doubled = queue.push, set()

    def push_twice(info):
        push(info)
        if info.uid not in doubled:
            doubled.add(info.uid)
            push(PodInfo(pod=info.pod))

    queue.push = push_twice
    try:
        c.add_nodes([make_sim_node(f"n{i}", {"cpu": "8", "memory": "32Gi", "pods": "110"})
                     for i in range(4)])
        now = time.time()
        for g in range(gangs):
            c.create_group(make_sim_group(f"dup{g}", members, creation_ts=now - 1 + g * 1e-3))
        for g in range(gangs):
            c.create_pods(make_member_pods(f"dup{g}", members, {"cpu": "1"}))
        c.start()  # the informers' sync queues every pod, twice
        for g in range(gangs):
            assert c.wait_for_bound(f"dup{g}", members, timeout=30.0), g
        time.sleep(0.3)  # a second bind of any pod would land by now
        pods = [d for d in c.api.list("Pod") if (d.get("spec") or {}).get("node_name")]
        assert len(pods) == gangs * members
        assert len(doubled) == gangs * members
        assert c.scheduler.stats["binds"] == gangs * members
        per_node = {}
        for d in pods:
            per_node[d["spec"]["node_name"]] = per_node.get(d["spec"]["node_name"], 0) + 1
        assert max(per_node.values()) <= 8
        assert sum(c.cluster.pod_count(f"n{i}") for i in range(4)) == gangs * members
    finally:
        c.stop()
