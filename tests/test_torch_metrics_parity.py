"""The in-process batch path's metrics, held against the JAX package's.

One scripted sequence runs through the JAX ``OracleScorer`` (on the CPU,
as its own tests run it) and the port's ``OracleScorer(device="cpu")``,
each on its own package's ``ClusterState`` with event wiring: a keyframe,
churn refreshes that fold, one whose blind mark forces the snapshot-lite
scan, one whose priority change re-sorts the queue order, refreshes with
``BST_SCAN_WAVE=8``, a node-object change and a new gang (keyframes of
the device-resident state); then a policy scorer's keyframe over labelled
nodes (labels past the hash lanes are truncated) and a label change.

Each package records into its own process-wide ``DEFAULT_REGISTRY``; the
test reads every series of the batch path as a difference across the
sequence (other tests share the registries) and requires equal deltas:
counters by label set, gauges by their values after the sequence,
histograms by observation count (their sums are times). Every value is
an integer count: the tolerance is exact equality."""

import contextlib
import importlib
import os

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")

COUNTERS = (
    "bst_oracle_batches_total",
    "bst_event_folds_total",
    "bst_scan_waves_total",
    "bst_scan_wave_demotions_total",
    "bst_scan_wave_uniform_total",
    "bst_pack_rows_rewritten",
    "bst_refresh_lite_packs_total",
    "bst_pack_policy_rows_rewritten",
    "bst_refresh_order_resorts_total",
    "bst_policy_label_truncations_total",
    "bst_device_keyframe_resyncs_total",
    "bst_device_rows_scattered_total",
    "bst_refresh_derived_batches_total",
)
GAUGES = (
    "bst_oracle_inflight_batches",
    "bst_scan_wave_enabled",
    "bst_device_state_generation",
)
HISTOGRAMS = (
    "bst_oracle_batch_seconds",
    "bst_oracle_pack_seconds",
    "bst_scan_waves_per_batch",
)
HOLDER_LABEL = "scorer"


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(autouse=True)
def _restore_active_engines():
    """An enabled PolicyEngine registers itself process-wide."""
    engines = [importlib.import_module(f"{p}.policy.engine") for p in PACKAGES]
    saved = [e._active[0] for e in engines]
    yield
    for e, s in zip(engines, saved):
        e._active[0] = s


def _registry(pkg):
    return importlib.import_module(f"{pkg}.utils.metrics").DEFAULT_REGISTRY


def _read(pkg):
    """Every batch-path series of ``pkg``'s registry: counters and gauges
    by label set, histograms' counts by label set."""
    reg = _registry(pkg)
    out = {}
    for name in COUNTERS + GAUGES:
        metric = reg.get(name)
        out[name] = dict(metric.values()) if metric is not None else {}
    for name in HISTOGRAMS:
        metric = reg.get(name)
        out[name] = (
            {k: snap[2] for k, snap in metric.snapshots().items()}
            if metric is not None else {}
        )
    return out


def _delta(before, after):
    """Counters and histogram counts as differences; gauges as their values
    after the sequence (the holder gauge for this sequence's holder label
    only: other tests' holders share the registry), but the in-flight
    gauge as its change: it counts every batch in flight in the process,
    so a batch another test left dispatched shows in its value, and the
    sequence must leave it where it found it."""
    out = {}
    for name, now in after.items():
        if name == "bst_device_state_generation":
            key = (("holder", HOLDER_LABEL),)
            out[name] = {key: now.get(key)}
        elif name == "bst_oracle_inflight_batches":
            out[name] = {k: v - before[name].get(k, 0) for k, v in now.items()}
        elif name in GAUGES:
            out[name] = dict(now)
        else:
            out[name] = {
                k: v - before[name].get(k, 0)
                for k, v in now.items() if v != before[name].get(k, 0)
            }
    return out


def _world(pkg, n=16, g=6):
    scen = importlib.import_module(f"{pkg}.sim.scenarios")
    cm = importlib.import_module(f"{pkg}.cache.pg_cache")
    cluster = importlib.import_module(f"{pkg}.framework.cluster").ClusterState()
    for i in range(n):
        labels = {"zone": f"z{i % 3}", "pool": f"p{i % 2}"}
        if i % 4 == 0:  # six labels: two past the four hash lanes
            labels.update({f"extra-{k}": "x" for k in range(4)})
        cluster.add_node(scen.make_sim_node(
            f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"}, labels=labels))
    cache = cm.PGStatusCache()
    for j in range(g):
        pg = scen.make_sim_group(f"gang-{j}", 2 + j % 4, creation_ts=float(j % 3))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"}, priority=j % 2)[0]
        cache.set(pg.full_name(), pgs)
    # eight identical gangs first in the queue order: a uniform wave at W=8
    for j in range(8):
        pg = scen.make_sim_group(f"uni-{j}", 2, creation_ts=0.0)
        pg.spec.min_resources = {"cpu": 2000}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"uni-{j}", 1, {"cpu": "1"}, priority=9)[0]
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 40, {"cpu": "1", "memory": "1Gi"})
    return scen, cm, cluster, cache, pods


def _scorer(pkg, **kw):
    mod = importlib.import_module(f"{pkg}.core.oracle_scorer")
    if pkg.endswith("_torch"):
        return mod.OracleScorer(device="cpu", **kw)
    return mod.OracleScorer(**kw)


def _script(pkg):
    """The sequence, through ``pkg``; returns the fold outcomes the port's
    two scorers counted themselves (None for the JAX package)."""
    scen, cm, cluster, cache, pods = _world(pkg)
    scorer = _scorer(pkg)

    def assume(k0, count):
        for k in range(k0, k0 + count):
            cluster.assume(pods[k], f"n{k % 16:02d}")

    def priority(j, p):
        cache.get(f"default/gang-{j}").pod.spec.priority = p
        scorer.mark_dirty(group=f"default/gang-{j}")

    def blind():
        cluster.assume(pods[20], "n05")
        scorer.mark_dirty()

    def node_object():
        node = cluster.get_node("n07")
        node.metadata.resource_version += 1
        cluster.update_node(node)

    def new_gang():
        pg = scen.make_sim_group("gang-new", 2, creation_ts=9.0)
        pg.spec.min_resources = {"cpu": 1000}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods("gang-new", 1, {"cpu": "1"})[0]
        cache.set(pg.full_name(), pgs)
        scorer.mark_dirty(group=pg.full_name())

    steps = [
        (None, lambda: None),                 # keyframe (no-base)
        (None, lambda: assume(0, 4)),         # fold
        (None, lambda: priority(2, 5)),       # fold with a queue re-sort
        (None, blind),                        # blind mark: the lite scan
        (None, lambda: assume(10, 2)),        # fold
        ("8", lambda: assume(12, 3)),         # fold, wavefront W=8
        ("8", lambda: priority(4, 3)),        # fold + re-sort, W=8
        ("8", node_object),                   # structural: scan, W=8
        (None, new_gang),                     # group set: keyframe
        (None, lambda: assume(16, 2)),        # fold
    ]
    for wave, act in steps:
        act()
        with _env({"BST_SCAN_WAVE": wave}):
            scorer.refresh(cluster, cache)

    # the policy half: a policy scorer over the labelled nodes (keyframe,
    # every node's policy row written, labels past the lanes truncated),
    # then one node's labels change (one row rewritten and scattered)
    eng = importlib.import_module(f"{pkg}.policy.engine")
    engine = eng.PolicyEngine(eng.PolicyConfig(
        terms=("affinity", "anti-affinity", "spread"), spread_node_key="zone"))
    pscorer = _scorer(pkg, policy_engine=engine)
    pscorer.refresh(cluster, cache)
    node = cluster.get_node("n04")
    node.metadata.labels = dict(node.metadata.labels, pool="p9", **{"extra-9": "y"})
    node.metadata.resource_version += 1
    cluster.update_node(node)
    pscorer.refresh(cluster, cache)
    if not pkg.endswith("_torch"):
        return None
    return {k: scorer.fold_outcomes.get(k, 0) + pscorer.fold_outcomes.get(k, 0)
            for k in set(scorer.fold_outcomes) | set(pscorer.fold_outcomes)}


def test_batch_path_metrics_deltas_match_reference():
    deltas = {}
    for pkg in PACKAGES:
        before = _read(pkg)
        outcomes = _script(pkg)
        deltas[pkg] = _delta(before, _read(pkg))
    ref, port = deltas["batch_scheduler_tpu"], deltas["batch_scheduler_tpu_torch"]
    for name in COUNTERS + GAUGES + HISTOGRAMS:
        assert port[name] == ref[name], name
    # the sequence reaches every series it is meant to
    for name in COUNTERS + HISTOGRAMS:
        assert port[name], name
    batches = 12
    assert port["bst_oracle_batches_total"] == {(): batches}
    assert port["bst_oracle_batch_seconds"] == {(): batches}
    assert port["bst_oracle_pack_seconds"] == {(): batches}
    # the port's own count of fold outcomes is the counter's delta
    folds = {dict(k)["outcome"]: int(v) for k, v in port["bst_event_folds_total"].items()}
    assert sum(folds.values()) == batches
    assert outcomes == folds
    assert port["bst_device_state_generation"] != {(("holder", HOLDER_LABEL),): None}


# ---------------------------------------------------------------------------
# the gang observatory's series (core.explain)
# ---------------------------------------------------------------------------

OBSERVATORY_SERIES = (
    ("bst_explain_queries_total", "counter"),
    ("bst_whatif_queries_total", "counter"),
    ("bst_whatif_query_seconds", "histogram"),
    ("bst_device_keyframe_resyncs_total", "counter"),
)


def _read_observatory(pkg):
    reg = _registry(pkg)
    out = {}
    for name, kind in OBSERVATORY_SERIES:
        metric = reg.get(name)
        if metric is None:
            out[name] = {}
        elif kind == "histogram":
            out[name] = {k: snap[2] for k, snap in metric.snapshots().items()}
        else:
            out[name] = dict(metric.values())
    return out


def _observatory_script(pkg):
    """Explain both gangs of a two-gang world through an oracle
    ScheduleOperation's observatory, then one what-if query of each kind
    through it (one baseline, the rest cached; add-nodes past the node
    bucket keyframes its fork), then one on another rung."""
    scen, cm, cluster, cache, _ = _world(pkg, n=8, g=2)
    exp = importlib.import_module(f"{pkg}.core.explain")
    health = importlib.import_module(f"{pkg}.utils.health")
    saved = (exp.active_observatory(), health.active_pending())
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    try:
        op = importlib.import_module(f"{pkg}.core.operation").ScheduleOperation(
            cache, cluster, scorer="oracle", **kw)
        op.oracle.ensure_fresh(cluster, cache)
        obs = exp.active_observatory()
        for gang in ("default/gang-0", "default/gang-1", "default/uni-0"):
            obs.explain(gang)
        for cf in ({"kind": "drain", "node": "n01"}, {"kind": "cordon", "node": "n02"},
                   {"kind": "add-nodes", "count": 12,
                    "shape": {"cpu": "16", "memory": "64Gi", "pods": "110"}},
                   {"kind": "bump-gang", "gang": "default/gang-1", "tier": 7},
                   {"kind": "remove-gang", "gang": "default/uni-3"}):
            obs.whatif(cf)
        obs.whatif({"kind": "drain", "node": "n03"}, rung="cpu-ladder")
    finally:
        exp.set_active_observatory(saved[0])
        health.set_active_pending(saved[1])


def test_observatory_metrics_deltas_match_reference():
    deltas = {}
    for pkg in PACKAGES:
        before = _read_observatory(pkg)
        _observatory_script(pkg)
        after = _read_observatory(pkg)
        deltas[pkg] = {
            name: {k: v - before[name].get(k, 0) for k, v in now.items()
                   if v != before[name].get(k, 0)}
            for name, now in after.items()
        }
    ref, port = deltas["batch_scheduler_tpu"], deltas["batch_scheduler_tpu_torch"]
    assert port == ref
    assert port["bst_explain_queries_total"] == {(): 3}
    assert port["bst_whatif_queries_total"] == {
        (("kind", k),): n for k, n in (("drain", 2), ("cordon", 1), ("add-nodes", 1),
                                       ("bump-gang", 1), ("remove-gang", 1))}
    assert port["bst_whatif_query_seconds"] == {(): 6}
    keyframes = {dict(k)["reason"]: v for k, v in port["bst_device_keyframe_resyncs_total"].items()}
    assert keyframes["whatif-base"] == 2 and keyframes["fork-shape"] == 1


# ---------------------------------------------------------------------------
# the top-K rung's series (BST_SCAN_TOPK)
# ---------------------------------------------------------------------------

TOPK_COUNTERS = (
    "bst_scan_batches_total",
    "bst_topk_demotions_total",
    "bst_scan_waves_total",
    "bst_scan_wave_demotions_total",
    "bst_scan_wave_uniform_total",
)
TOPK_GAUGES = ("bst_scan_topk_k",)


def _read_topk(pkg):
    reg = _registry(pkg)
    out = {}
    for name in TOPK_COUNTERS + TOPK_GAUGES:
        metric = reg.get(name)
        out[name] = dict(metric.values()) if metric is not None else {}
    metric = reg.get("bst_scan_waves_per_batch")
    out["bst_scan_waves_per_batch"] = (
        {k: snap[2] for k, snap in metric.snapshots().items()} if metric is not None else {})
    return out


def _topk_script(pkg):
    """Twelve 4-cpu nodes and gangs of 3-cpu members (one a node): a
    6-member gang outruns K=4 candidates and demotes to the dense column,
    K=16 covers it. Refreshes at K=4, K=16 (W=4), then the dense scans."""
    scen = importlib.import_module(f"{pkg}.sim.scenarios")
    cm = importlib.import_module(f"{pkg}.cache.pg_cache")
    cluster = importlib.import_module(f"{pkg}.framework.cluster").ClusterState()
    for i in range(12):
        cluster.add_node(scen.make_sim_node(f"n{i:02d}", {"cpu": "4", "memory": "16Gi",
                                                          "pods": "110"}))
    cache = cm.PGStatusCache()
    for j in range(5):
        pg = scen.make_sim_group(f"wide-{j}", 2 + 2 * (j % 3), creation_ts=float(j))
        pg.spec.min_resources = {"cpu": 3000}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"wide-{j}", 1, {"cpu": "3"})[0]
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 4, {"cpu": "1"})
    scorer = _scorer(pkg)
    steps = [
        ({"BST_SCAN_TOPK": "4"}, lambda: None),
        ({"BST_SCAN_TOPK": "4"}, lambda: cluster.assume(pods[0], "n00")),
        ({"BST_SCAN_TOPK": "16", "BST_SCAN_WAVE": "4"}, lambda: cluster.assume(pods[1], "n01")),
        ({"BST_SCAN_TOPK": "x"}, lambda: cluster.assume(pods[2], "n02")),
        ({"BST_SCAN_WAVE": "8"}, lambda: cluster.assume(pods[3], "n03")),
    ]
    for env, act in steps:
        act()
        with _env({"BST_SCAN_TOPK": None, "BST_SCAN_WAVE": None, **env}):
            scorer.refresh(cluster, cache)


def test_topk_metrics_deltas_match_reference():
    deltas = {}
    for pkg in PACKAGES:
        before = _read_topk(pkg)
        _topk_script(pkg)
        after = _read_topk(pkg)
        deltas[pkg] = {
            name: (dict(now) if name in TOPK_GAUGES else
                   {k: v - before[name].get(k, 0) for k, v in now.items()
                    if v != before[name].get(k, 0)})
            for name, now in after.items()
        }
    ref, port = deltas["batch_scheduler_tpu"], deltas["batch_scheduler_tpu_torch"]
    for name in TOPK_COUNTERS + TOPK_GAUGES + ("bst_scan_waves_per_batch",):
        assert port[name] == ref[name], name
    paths = {dict(k)["path"]: v for k, v in port["bst_scan_batches_total"].items()}
    assert paths == {"topk": 3, "serial": 1, "wavefront": 1}
    assert port["bst_scan_topk_k"] == {(): 16.0}
    assert sum(port["bst_topk_demotions_total"].values()) > 0


# ---------------------------------------------------------------------------
# the scheduler loop's series (framework.scheduler, plugin.batch_plugin,
# the lifecycle ledger's time-to-placement)
# ---------------------------------------------------------------------------

FRAMEWORK_COUNTERS = (
    "bst_pods_bound_total",
    "bst_gang_releases_total",
    "bst_cycle_errors_total",
    "bst_preemptions_total",
)
FRAMEWORK_HISTOGRAMS = (
    "bst_schedule_cycle_seconds",
    "bst_extension_point_seconds",
    "bst_gang_ttp_seconds",
    "bst_gang_ttp_phase_seconds",
)


def _read_framework(pkg):
    reg = _registry(pkg)
    out = {}
    for name in FRAMEWORK_COUNTERS:
        metric = reg.get(name)
        out[name] = dict(metric.values()) if metric is not None else {}
    for name in FRAMEWORK_HISTOGRAMS:
        metric = reg.get(name)
        out[name] = (
            {k: snap[2] for k, snap in metric.snapshots().items()}
            if metric is not None else {}
        )
    return out


def _framework_script(pkg, scorer):
    """One SimCluster run: 6 gangs that fit and one that fits nowhere, every
    pod queued before the scheduler starts, each whole-gang transaction
    committed before the next cycle, and a backoff far past the run, so
    every count is fixed by the inputs: one cycle a gang on the oracle's
    fast lane (a pod on the serial path), one a denied member."""
    sim = importlib.import_module(f"{pkg}.sim")
    scen = importlib.import_module(f"{pkg}.sim.scenarios")
    from test_torch_sim_e2e import _start_settled

    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    c = sim.SimCluster(scorer=scorer, backoff_base=300.0, backoff_cap=300.0, **kw)
    try:
        c.add_nodes([scen.make_sim_node(f"m{i}", {"cpu": "8", "memory": "32Gi", "pods": "64"})
                     for i in range(6)])
        import time as _time

        base = _time.time() - 1.0
        pods = []
        for g in range(7):
            members, cpu = (3, "2") if g < 6 else (2, "64")
            c.create_group(scen.make_sim_group(f"fw{g}", members, creation_ts=base + g * 1e-3))
            pods.extend(scen.make_member_pods(f"fw{g}", members, {"cpu": cpu}))
        _start_settled(c, len(pods))
        c.create_pods(pods)
        assert c.wait_for(lambda: len(c.scheduler.queue) == len(pods), timeout=30.0)
        c.scheduler.FLUSH_GANGS = 1
        c.scheduler.start()
        assert c.wait_for(lambda: c.scheduler.stats["binds"] >= 18
                          and c.scheduler.stats["unschedulable"] >= 2, timeout=30.0), \
            c.scheduler.stats
        stats = dict(c.scheduler.stats)
    finally:
        c.stop()
    return stats


@pytest.mark.parametrize("scorer", ["oracle", "serial"])
def test_framework_metrics_deltas_match_reference(scorer):
    deltas, stats = {}, {}
    for pkg in PACKAGES:
        before = _read_framework(pkg)
        stats[pkg] = _framework_script(pkg, scorer)
        after = _read_framework(pkg)
        deltas[pkg] = {
            name: {k: v - before[name].get(k, 0) for k, v in now.items()
                   if v != before[name].get(k, 0)}
            for name, now in after.items()
        }
    ref, port = deltas["batch_scheduler_tpu"], deltas["batch_scheduler_tpu_torch"]
    assert stats["batch_scheduler_tpu_torch"] == stats["batch_scheduler_tpu"]
    for name in FRAMEWORK_COUNTERS + FRAMEWORK_HISTOGRAMS:
        assert port[name] == ref[name], name
    s = stats["batch_scheduler_tpu_torch"]
    # the series are the run's own counts
    assert port["bst_schedule_cycle_seconds"] == {(): s["cycles"]}
    assert port["bst_pods_bound_total"] == {(): s["binds"]} and s["binds"] == 18
    assert port["bst_gang_releases_total"] == {(): 6}
    points = {dict(k)["point"]: v for k, v in port["bst_extension_point_seconds"].items()}
    assert points["preFilter"] == s["cycles"]
    assert sum(port["bst_gang_ttp_seconds"].values()) == 6
    if scorer == "oracle":
        assert s["cycles"] == 6 + 2 and points["permit"] == 6
