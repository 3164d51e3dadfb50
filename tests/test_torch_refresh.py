"""The port's O(churn) refresh end to end: ``OracleScorer(device="cpu")``
on the port's ``ClusterState`` against the JAX ``OracleScorer`` on the
JAX ``ClusterState``, both driven through the same ``assume`` /
``forget`` / ``finish_binding`` / node changes, group marks and a blind
mark. At every refresh the host dicts, the fold outcome and the delta
record are equal, and both equal the full pack: one ``ClusterSnapshot``
of ``read_cluster_inputs`` run as one batch, the path every refresh took
before the fold (and, in the port, all seven batch args the scorer's
resident state handed the batch equal that snapshot's). The
``ScheduleOperation`` race scenario over a ``ClusterState`` folds the
gang rows that ``_gang_event`` names (and serves stale rows without it).
Also the ClusterState emission invariant. Every array is an integer or a
bool: the tolerance is exact equality."""

import contextlib
import importlib
import os

import numpy as np
import pytest
import torch

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
HOST_KEYS = ("placed", "gang_feasible", "progress", "best", "best_exists",
             "assignment_nodes", "assignment_counts")
# the event log's cap in these drives (the reference reads it from
# BST_EVENT_LOG_CAP; the port's scorer log takes it as an attribute)
LOG_CAP = 8


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _host(result):
    return {k: np.asarray(result[k]).copy() for k in HOST_KEYS}


def _hosts_equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in HOST_KEYS)


class _Outcomes:
    """The last fold outcome of one package's scorer: the port's
    ``last_fold_outcome``; the reference's ``bst_event_folds_total``
    counter, read as a difference across the refresh."""

    def __init__(self, name, scorer):
        self.port = name.endswith("_torch")
        self.scorer = scorer
        if not self.port:
            from batch_scheduler_tpu.utils.metrics import DEFAULT_REGISTRY

            self.counter = DEFAULT_REGISTRY.counter("bst_event_folds_total")
            self.before = dict(self.counter.values())

    def last(self):
        if self.port:
            return self.scorer.last_fold_outcome
        now = dict(self.counter.values())
        moved = [dict(k)["outcome"] for k, v in now.items() if v != self.before.get(k, 0)]
        self.before = now
        return moved[0] if len(moved) == 1 else tuple(moved)


def _cluster_world(name, n=16, g=6):
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    for i in range(n):
        cluster.add_node(scen.make_sim_node(
            f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"}))
    cache = cm.PGStatusCache()
    for j in range(g):
        pg = scen.make_sim_group(f"gang-{j}", 2 + j % 4, creation_ts=float(j % 3))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"}, priority=j % 2)[0]
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 40, {"cpu": "1", "memory": "1Gi"})
    return scen, cm, cluster, cache, pods


def _scorer(name, **kw):
    mod = importlib.import_module(f"{name}.core.oracle_scorer")
    if name.endswith("_torch"):
        return mod.OracleScorer(device="cpu", **kw)
    return mod.OracleScorer(**kw)


def _refresh(name, scorer, cluster, cache):
    """One refresh, with the port's scorer log capped at LOG_CAP (the log
    exists from the first refresh on)."""
    with _env({"BST_EVENT_LOG_CAP": str(LOG_CAP)}):
        scorer.refresh(cluster, cache)
    if name.endswith("_torch"):
        scorer._event_log.cap = LOG_CAP


def _full_pack(name, cluster, cache):
    """The full pack: one ClusterSnapshot of the whole cluster, run as one
    batch — ``(snapshot, host dict)``."""
    scorer_mod = importlib.import_module(f"{name}.core.oracle_scorer")
    snap = importlib.import_module(f"{name}.ops.snapshot").ClusterSnapshot(
        *scorer_mod.read_cluster_inputs(cluster, cache))
    kw = {"device": "cpu"} if name.endswith("_torch") else {}
    host, _ = importlib.import_module(f"{name}.ops.oracle").execute_batch_host(
        snap.device_args(), snap.progress_args(), **kw)
    return snap, host


def _args_equal_full_pack(scorer, snap):
    """All seven batch args of the port scorer's last sync equal the full
    pack's."""
    return all(np.array_equal(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a),
                              np.asarray(h))
               for a, h in zip(scorer._device_state.last_args(), snap.device_args()))


def _steps():
    """(label, action(scen, cm, cluster, cache, pods, scorer)) — the same
    mutations through either package."""
    def assume(k0, count):
        def act(scen, cm, cluster, cache, pods, scorer):
            for k in range(k0, k0 + count):
                cluster.assume(pods[k], f"n{k % 16:02d}")
        return act

    def progress(j):
        def act(scen, cm, cluster, cache, pods, scorer):
            cluster.forget(pods[1].metadata.uid)
            cluster.finish_binding(pods[2].metadata.uid)
            cache.get(f"default/gang-{j}").pod_group.status.scheduled += 1
            scorer.mark_dirty(group=f"default/gang-{j}")
        return act

    def bind_many(k0, count):
        def act(scen, cm, cluster, cache, pods, scorer):
            for k in range(k0, k0 + count):
                cluster.assume(pods[k], "n03")
                cluster.finish_binding(pods[k].metadata.uid)
        return act

    def priority(j, p):
        def act(scen, cm, cluster, cache, pods, scorer):
            cache.get(f"default/gang-{j}").pod.spec.priority = p
            scorer.mark_dirty(group=f"default/gang-{j}")
        return act

    def blind(scen, cm, cluster, cache, pods, scorer):
        cluster.assume(pods[20], "n05")
        scorer.mark_dirty()

    def observe(scen, cm, cluster, cache, pods, scorer):
        pods[21].spec.node_name = "n06"
        cluster.observe_pod(pods[21])
        cluster.remove_pod(pods[3])

    def node_object(scen, cm, cluster, cache, pods, scorer):
        node = cluster.get_node("n07")
        node.metadata.resource_version += 1  # the object changed
        cluster.update_node(node)

    def new_gang(scen, cm, cluster, cache, pods, scorer):
        pg = scen.make_sim_group("gang-new", 2, creation_ts=9.0)
        pg.spec.min_resources = {"cpu": 1000}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods("gang-new", 1, {"cpu": "1"})[0]
        cache.set(pg.full_name(), pgs)
        scorer.mark_dirty(group=pg.full_name())

    def ghost(scen, cm, cluster, cache, pods, scorer):
        scorer.mark_dirty(group="default/ghost")

    def skew(scen, cm, cluster, cache, pods, scorer):
        # a mutation that bypasses the event hooks
        with cluster._lock:
            cluster._version += 1

    def wide(scen, cm, cluster, cache, pods, scorer):
        for k in range(24, 34):  # more distinct nodes than the log's cap
            cluster.assume(pods[k], f"n{k % 16:02d}")

    def nothing(scen, cm, cluster, cache, pods, scorer):
        pass

    return [
        ("first", nothing), ("assume", assume(0, 4)), ("progress", progress(1)),
        ("bind_many", bind_many(5, 3)), ("quiet", nothing), ("priority", priority(2, 5)),
        ("blind", blind), ("after-blind", assume(10, 2)), ("observe", observe),
        ("node-object", node_object), ("after-structural", assume(12, 1)),
        ("new-gang", new_gang), ("ghost", ghost), ("skew", skew), ("wide", wide),
        ("after-overflow", progress(3)),
    ]


def _drive(name, **kw):
    scen, cm, cluster, cache, pods = _cluster_world(name)
    scorer = _scorer(name, **kw)
    outcomes = _Outcomes(name, scorer)
    seq = []
    for label, act in _steps():
        act(scen, cm, cluster, cache, pods, scorer)
        _refresh(name, scorer, cluster, cache)
        outcome = outcomes.last()
        host, want = _host(scorer._state.result), _host(_full_pack(name, cluster, cache)[1])
        assert _hosts_equal(host, want), (name, label)
        d = scorer.snapshot.delta
        seq.append((label, outcome, d.kind, d.reason, d.source, d.node_rows.tolist(),
                    d.group_rows.tolist(), d.meta_rows.tolist(), host))
    return seq, scorer


def test_refresh_matches_reference_and_full_pack():
    (ref, _), (port, scorer) = (_drive(name) for name in PACKAGES)
    for a, b in zip(ref, port):
        assert a[:8] == b[:8], a[0]
        assert _hosts_equal(a[8], b[8]), a[0]
    outcomes = {label: o for label, o, *_ in port}
    assert outcomes == {
        "first": "no-base", "assume": "folded", "progress": "folded",
        "bind_many": "folded", "quiet": "folded", "priority": "folded",
        "blind": "blind", "after-blind": "folded", "observe": "folded",
        "node-object": "structural", "after-structural": "folded",
        "new-gang": "group-churn", "ghost": "unknown-name", "skew": "version-skew",
        "wide": "overflow", "after-overflow": "folded",
    }
    by_label = {s[0]: s for s in port}
    assert by_label["priority"][7] == [2]  # the queue order re-derived
    stats = scorer.stats()
    assert stats["fold_outcomes"]["folded"] == 9
    assert stats["device_state"]["keyframes"] == {"first": 1, "node-churn": 1,
                                                  "group-set": 1}
    assert stats["device_state"]["derived_batches"] == len(port)
    assert set(scorer.pack_seconds_by_path) == {"keyframe", "scan", "fold"}


def test_fold_paths_match_with_device_state_and_derive_off():
    """The reference with its holder off (``BST_DEVICE_STATE=0``: every
    batch uploaded) and with its derive off (``BST_DEVICE_DERIVE=0``)
    against the port, which always keeps resident state and derives: the
    port still equals the reference and the full pack at every refresh."""
    port, scorer = _drive(PACKAGES[1])
    ds = scorer.stats()["device_state"]
    assert ds["derived_batches"] == len(port) and ds["meta_resident"]
    for env in ({"BST_DEVICE_STATE": "0"}, {"BST_DEVICE_DERIVE": "0"}):
        with _env(env):
            ref, _ = _drive(PACKAGES[0])
        assert [a[:8] for a in ref] == [b[:8] for b in port]


@pytest.mark.parametrize("wave", [None, 8], ids=["serial", "wave8"])
def test_batch_args_equal_full_pack_every_refresh(wave):
    """After every refresh of the drive, the seven batch args the port's
    resident state handed the batch (resident lanes, host tail, derived
    fit row and order) equal the full pack's, and so do the host dict and
    the wave telemetry."""
    name = PACKAGES[1]
    scen, cm, cluster, cache, pods = _cluster_world(name)
    scorer = _scorer(name)
    with _env({"BST_SCAN_WAVE": str(wave or 0)}):
        for label, act in _steps():
            act(scen, cm, cluster, cache, pods, scorer)
            _refresh(name, scorer, cluster, cache)
            snap, want = _full_pack(name, cluster, cache)
            assert _args_equal_full_pack(scorer, snap), label
            assert _hosts_equal(_host(scorer._state.result), _host(want)), label
            # ``compiled`` marks the process's first batch at a shape key:
            # the full pack's batch follows the scorer's at the same key
            rest = lambda t: {k: v for k, v in t.items() if k != "compiled"}  # noqa: E731
            assert rest(scorer.last_telemetry) == rest(want["telemetry"]), label
            assert want["telemetry"]["compiled"] is False, label


def test_member_request_change_folds_one_group_row():
    """A gang's member request changes: the refresh folds, the delta names
    exactly that gang's [G,R] row in both packages, the port's holder
    scatters it, and the batch args equal the full pack's."""
    out = []
    for name in PACKAGES:
        scen, cm, cluster, cache, pods = _cluster_world(name)
        scorer = _scorer(name)
        outcomes = _Outcomes(name, scorer)
        _refresh(name, scorer, cluster, cache)
        outcomes.last()
        cache.get("default/gang-2").pod_group.spec.min_resources = {"cpu": 2000, "memory": 2**29}
        scorer.mark_dirty(group="default/gang-2")
        _refresh(name, scorer, cluster, cache)
        d = scorer.snapshot.delta
        out.append((outcomes.last(), d.kind, d.source, d.node_rows.tolist(),
                    d.group_rows.tolist(), _host(scorer._state.result)))
    assert out[0][:5] == out[1][:5] == ("folded", "delta", "events", [], [2])
    assert _hosts_equal(out[0][5], out[1][5])
    snap, want = _full_pack(PACKAGES[1], cluster, cache)
    assert _args_equal_full_pack(scorer, snap)
    assert _hosts_equal(out[1][5], _host(want))
    assert scorer.stats()["device_state"]["rows_scattered"] == 1


# -- the race scenario through ScheduleOperation -----------------------------


def _race(name, gang_event=True):
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    core = importlib.import_module(f"{name}.core.operation")
    phases = importlib.import_module(f"{name}.api.types").PodGroupPhase
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    nodes, groups, pods = scen.race_scenario()
    for n in nodes:
        cluster.add_node(n)
    sys_pod = scen.make_member_pods("sys", 1, {"cpu": "900m"})[0]
    sys_pod.metadata.labels = {}
    sys_pod.spec.node_name = "node-1"
    cluster.observe_pod(sys_pod)
    cache = cm.PGStatusCache()
    for pg in groups:
        pg.status.phase = phases.PENDING
        cache.set(pg.full_name(), cm.PodGroupMatchStatus(pg))
    kwargs = {"device": "cpu"} if name.endswith("_torch") else {}
    op = core.ScheduleOperation(cache, cluster, scorer="oracle", **kwargs)
    if not gang_event:
        op._gang_event = lambda full_name: None
    outcomes = _Outcomes(name, op.oracle)
    refreshes = []
    inner = op.oracle.refresh

    def refresh(c, s):
        inner(c, s)
        snap = op.oracle.snapshot
        folded = getattr(snap, "event_fold", None) or {}
        refreshes.append((outcomes.last(), sorted(g for g, _ in folded.get("groups", [])),
                          _hosts_equal(_host(op.oracle._state.result),
                                       _host(_full_pack(name, c, s)[1]))))
    op.oracle.refresh = refresh

    def outcome(fn):
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — the outcome IS the error class
            return type(e).__name__
        return "ok" if out is None else (out.ready, type(out.error).__name__ if out.error else None)

    seq = []
    for pod in pods["web-group-race1"]:
        seq.append(outcome(lambda: op.pre_filter(pod)))
        seq.append(outcome(lambda: op.filter(pod, "node-1")))
        cluster.assume(pod, "node-1")
        seq.append(outcome(lambda: op.permit(pod, "node-1")))
    for pod in pods["web-group-race1"]:
        pod.spec.node_name = "node-1"
        cluster.observe_pod(pod)
        cluster.finish_binding(pod.metadata.uid)
        op.post_bind(pod, "node-1")
    for pod in pods["web-group-race2"][:2]:
        seq.append(outcome(lambda: op.pre_filter(pod)))
    return seq, refreshes


def test_race_over_cluster_state_folds_gang_events():
    (ref_seq, ref_refreshes), (seq, refreshes) = (_race(name) for name in PACKAGES)
    assert seq == ref_seq
    assert refreshes == ref_refreshes
    assert seq[14] == (True, None) and seq[-2:] == ["ResourceNotEnoughError", "DeniedError"]
    assert all(equal for _, _, equal in refreshes)
    # plan-covered permits dirty nothing but note the gang: the refreshes
    # that the members' assumes trigger fold its matched count
    folded = [groups for o, groups, _ in refreshes if o == "folded"]
    assert folded and all(g == ["default/web-group-race1"] for g in folded[:4])


def test_race_without_gang_events_serves_stale_rows():
    """The check above has teeth: with ``_gang_event`` a no-op (the port
    before this change) a fold skips the gang's moved progress row, and
    its batch differs from the full pack."""
    _, refreshes = _race(PACKAGES[1], gang_event=False)
    assert not all(equal for _, _, equal in refreshes)


# -- ClusterState ------------------------------------------------------------


def test_cluster_state_emission_matches_reference():
    """Every ClusterState version bump reaches subscribers as exactly one
    event — the equality the fold's completeness proof rests on — with the
    same kinds and names in both packages."""
    out = []
    for name in PACKAGES:
        scen = importlib.import_module(f"{name}.sim.scenarios")
        cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
        seen = []

        class Sub:
            def note(self, kind, names):
                seen.append((kind, tuple(names)))

        sub = Sub()
        cluster.subscribe_events(sub.note)
        for i in range(2):
            cluster.add_node(scen.make_sim_node(f"e{i}", {"cpu": "8", "pods": "64"}))
        p = scen.make_member_pods("ep", 4, {"cpu": "1"})
        cluster.assume(p[0], "e0")
        cluster.assume(p[0], "e1")  # re-assume releases the old node
        cluster.assume(p[1], "e0")
        cluster.assume(p[2], "e1")
        cluster.forget(p[1].metadata.uid)
        cluster.forget("unknown-uid")  # no bump, no event
        cluster.finish_binding(p[2].metadata.uid)  # no bump, no event
        p[2].spec.node_name = "e1"
        cluster.observe_pod(p[2])  # the bind of an assumed pod: no change
        p[3].spec.node_name = "e0"
        cluster.observe_pod(p[3])
        cluster.remove_pod(p[3])
        cluster.remove_node("e1")
        out.append((seen, cluster.version(), cluster.node_requested("e0"),
                    cluster.node_requested("e1"), [n.metadata.name for n in cluster.list_nodes()]))
        assert len(seen) == cluster.version()
        del sub
        cluster.add_node(scen.make_sim_node("e9", {"cpu": "8"}))  # collected: pruned
        assert len(seen) == out[-1][1]
    assert out[0] == out[1]


def test_status_cache_counters_match_reference():
    """``mutations()`` counts every set and delete (the fold's group-set
    proof), absent names included."""
    out = []
    for name in PACKAGES:
        scen = importlib.import_module(f"{name}.sim.scenarios")
        cm = importlib.import_module(f"{name}.cache.pg_cache")
        cache = cm.PGStatusCache()
        counts = [cache.mutations()]
        for j in range(3):
            cache.set(f"default/g{j}", cm.PodGroupMatchStatus(scen.make_sim_group(f"g{j}", 2)))
            counts.append(cache.mutations())
        cache.delete("default/g1")
        cache.delete("default/absent")
        counts.append(cache.mutations())
        out.append((counts, sorted(cache.snapshot())))
    assert out[0] == out[1]
    assert out[1][0] == [0, 1, 2, 3, 5]


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_refresh_on_card_matches_cpu():
    """The same churn through a cuda scorer and a cpu scorer on one
    ClusterState each: equal host dicts, fold outcomes and delta records
    at every refresh, and the resident tensors equal the host pack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name = PACKAGES[1]
    runs = []
    for device in ("cuda", "cpu"):
        scen, cm, cluster, cache, pods = _cluster_world(name)
        mod = importlib.import_module(f"{name}.core.oracle_scorer")
        scorer = mod.OracleScorer(device=device)
        seq = []
        for label, act in _steps():
            act(scen, cm, cluster, cache, pods, scorer)
            _refresh(name, scorer, cluster, cache)
            d = scorer.snapshot.delta
            assert _args_equal_full_pack(scorer, _full_pack(name, cluster, cache)[0]), label
            seq.append((label, scorer.last_fold_outcome, d.kind, d.reason,
                        d.node_rows.tolist(), _host(scorer._state.result)))
        runs.append(seq)
    for a, b in zip(*runs):
        assert a[:5] == b[:5] and _hosts_equal(a[5], b[5]), a[0]
