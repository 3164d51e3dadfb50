"""The port's ``serve_metrics`` (``batch_scheduler_tpu_torch/utils/metrics.py``)
against the JAX package's, each on ``127.0.0.1:0`` over its own
registry: after the same script (span ring, flight recorder, lifecycle
ledger, health model, policy engine and capacity sampler fed the same
way in both packages), every route the port serves answers with the
reference's status and payload keys (``/metrics`` with the same text),
the four routes whose payloads name the port's own machinery
(``/debug/buckets``, ``/debug/perf``, ``/debug/profile``, ``/debug/drain``)
answer 200 with the reference's top-level keys, an unknown path answers
404, and malformed queries answer 400 in both. Then the denial and policy-blame
flight records that a ``ScheduleOperation`` writes are equal in both
packages (times and trace ids aside).

The rings here are sized so that nothing is evicted while a request
reads them: no request races an eviction."""

import importlib
import json
import urllib.error
import urllib.request

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
PORTED = ("/metrics", "/healthz", "/debug/", "/debug/trace",
          "/debug/decisions", "/debug/gangs", "/debug/events",
          "/debug/health", "/debug/policy", "/debug/explain",
          "/debug/whatif", "/debug/capacity")
# served since PR 16; their values describe the port's kernels, its
# allocator and its compile ledger, so only their top-level keys compare
SERVED = ("/debug/buckets", "/debug/perf", "/debug/profile", "/debug/drain")
# index entries whose text names the port's counterpart of the reference's
# XLA machinery (kernel plans and bounds, torch.profiler)
RETOLD = {"/debug/buckets", "/debug/profile"}
QUERIES = (
    "/debug/decisions?gang=ns-a/g0", "/debug/decisions?tenant=ns-b",
    "/debug/decisions?limit=1", "/debug/gangs?gang=ns-a/g0",
    "/debug/gangs?tenant=ns-b&limit=1", "/debug/events?since=2&limit=3",
    "/debug/capacity?points=2", "/debug?x=1",
)
MALFORMED = ("/debug/decisions?limit=-1", "/debug/gangs?limit=x",
             "/debug/events?since=-3", "/debug/events?timeout_s=nan",
             "/debug/capacity?points=many", "/debug/profile?seconds=5s",
             "/debug/profile?seconds=nan", "/debug/profile?seconds=inf")


def _get(addr, path):
    try:
        with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _keys(obj, depth=0):
    """The key structure of a JSON payload: dicts by their keys (values'
    structures below), lists by their first element's."""
    if depth > 6:
        return None
    if isinstance(obj, dict):
        return {k: _keys(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0], depth + 1)] if obj else []
    return None


def _script(name, reg):
    """Feed one package's process-wide recorders the same evidence."""
    tr = importlib.import_module(f"{name}.utils.trace")
    life = importlib.import_module(f"{name}.utils.lifecycle")
    health = importlib.import_module(f"{name}.utils.health")
    eng = importlib.import_module(f"{name}.policy.engine")
    tr.configure(enabled=True, sample=1.0, capacity=tr.DEFAULT_CAPACITY)
    tr.DEFAULT_FLIGHT_RECORDER.clear()
    life.DEFAULT_LEDGER.reset()
    health.DEFAULT_HEALTH.reset()
    with tr.start_trace("cycle", pods=2):
        with tr.span("oracle.refresh", cat="oracle"):
            pass
        tr.DEFAULT_FLIGHT_RECORDER.record(
            "ns-a/g0", phase="pre_filter", verdict="denied", reason="r",
            coalesce=True, batch=1, feasible_nodes=0)
        life.DEFAULT_LEDGER.note_batch_context("aid-1", {"lock_wait_seconds": 0.5})
        life.DEFAULT_LEDGER.note_arrival("ns-a/g0", tier=1, pods=2)
        life.DEFAULT_LEDGER.note_deny("ns-a/g0", "r")
    tr.DEFAULT_FLIGHT_RECORDER.record("ns-b/g1", phase="policy", verdict="info",
                                      batch=1, nodes=2, terms={"priority_class": 0})
    tr.DEFAULT_FLIGHT_RECORDER.record("_batch", phase="batch", verdict="info",
                                      batch=1, telemetry={"wave_width": 0})
    life.DEFAULT_LEDGER.note_arrival("ns-b/g1", pods=1)
    life.DEFAULT_LEDGER.note_permit("ns-b/g1")
    life.DEFAULT_LEDGER.note_bind("ns-b/g1", members=1)
    life.DEFAULT_LEDGER.note_delete("ns-b/g1")
    eng.PolicyEngine(eng.PolicyConfig(terms=("affinity", "spread")))
    reg.counter("bst_oracle_batches_total", "Fused oracle batches executed").inc(3)
    reg.histogram("bst_oracle_pack_seconds", "Host snapshot-pack time per batch").observe(0.002)
    reg.gauge("bst_oracle_degraded", "").set(0)


def _world(name):
    """(scorer refresh with one capacity sample) so /debug/capacity has a
    live sampler with a summary in both packages."""
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    for i in range(8):
        cluster.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "memory": "16Gi",
                                                      "pods": "110"}))
    cache = cm.PGStatusCache()
    for j in range(5):
        pg = scen.make_sim_group(f"g{j}", 2 + j, creation_ts=float(j))
        pg.spec.min_resources = {"cpu": 3000 + 4000 * (j == 4)}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"g{j}", 1, {"cpu": "3"})[0]
        cache.set(pg.full_name(), pgs)
    return cluster, cache


@pytest.fixture(scope="module")
def endpoints(tmp_path_factory):
    """Both packages' endpoints after the same script; the process-wide
    switches and registrations are put back afterwards."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BST_CAPACITY", "1")
    mp.setenv("BST_CAPACITY_BUDGET_FRAC", "1.0")
    out = {}
    saved = []
    try:
        for name in PACKAGES:
            metrics = importlib.import_module(f"{name}.utils.metrics")
            eng = importlib.import_module(f"{name}.policy.engine")
            cap = importlib.import_module(f"{name}.ops.capacity")
            health = importlib.import_module(f"{name}.utils.health")
            saved.append((eng, eng._active[0], cap, cap.active_sampler(),
                          health, health.active_pending()))
            mod = importlib.import_module(f"{name}.core.oracle_scorer")
            cluster, cache = _world(name)
            scorer = (mod.OracleScorer(device="cpu") if name.endswith("_torch")
                      else mod.OracleScorer())
            scorer.refresh(cluster, cache)
            health.set_active_pending(health.PendingGangTracker())
            reg = metrics.Registry()
            _script(name, reg)
            srv = metrics.serve_metrics(reg, port=0)
            out[name] = (srv, srv.server_address)
        yield {n: a for n, (_, a) in out.items()}
    finally:
        for srv, _ in out.values():
            srv.shutdown()
            srv.server_close()
        for name in PACKAGES:
            tr = importlib.import_module(f"{name}.utils.trace")
            tr.configure(enabled=False)
            tr.DEFAULT_FLIGHT_RECORDER.clear()
            importlib.import_module(f"{name}.utils.lifecycle").DEFAULT_LEDGER.reset()
        for eng, active, cap, sampler, health, pending in saved:
            eng._active[0] = active
            cap.set_active_sampler(sampler)
            health.set_active_pending(pending)
        mp.undo()


def _payloads(endpoints, path):
    return [_get(endpoints[n], path) for n in PACKAGES]


@pytest.mark.parametrize("path", PORTED + QUERIES)
def test_ported_route_matches_reference(endpoints, path):
    (s_ref, b_ref), (s_port, b_port) = _payloads(endpoints, path)
    assert s_ref == s_port == 200, (path, s_ref, s_port)
    if path.startswith("/metrics"):
        assert b_ref == b_port
        return
    if path == "/healthz":
        assert b_ref == b_port == b"ok\n"
        return
    ref, port = json.loads(b_ref), json.loads(b_port)
    if path.startswith("/debug/health"):
        # a pooled client of either package elsewhere in the process adds
        # a failover view; this script has none of its own
        ref["signals"].pop("failover", None)
        port["signals"].pop("failover", None)
    if path.startswith("/debug?") or path == "/debug/":
        assert set(ref["endpoints"]) == set(port["endpoints"]) == set(PORTED + SERVED)
        assert {k: v for k, v in ref["endpoints"].items() if k not in RETOLD} == {
            k: v for k, v in port["endpoints"].items() if k not in RETOLD}
        return
    assert _keys(ref) == _keys(port), path


def test_payload_values_match_reference(endpoints):
    """Beyond keys: the flight-recorder, ledger, health and policy payloads
    carry the same values (times and ids aside)."""

    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()
                    if k not in ("ts", "first_ts", "trace_id", "arrival",
                                 "sched", "permit", "bind", "ttp_s",
                                 "queue_wait", "schedule_wait", "bind_wait")}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    for path in ("/debug/decisions", "/debug/gangs", "/debug/events?since=0",
                 "/debug/policy"):
        ref, port = (json.loads(b) for _, b in _payloads(endpoints, path))
        assert strip(ref) == strip(port), path
    ref, port = (json.loads(b) for _, b in _payloads(endpoints, "/debug/health"))
    for sig in ("pending", "identity", "degraded", "breaker", "burn:ttp", "cycle"):
        assert strip(ref["signals"][sig]) == strip(port["signals"][sig]), sig
    trace = [json.loads(b) for _, b in _payloads(endpoints, "/debug/trace")]
    assert [sorted(e["name"] for e in t["traceEvents"]) for t in trace][0] == sorted(
        e["name"] for e in trace[1]["traceEvents"])


@pytest.mark.parametrize("path", SERVED)
def test_served_routes_answer_with_reference_keys(endpoints, path):
    """Bare GETs: a copy of the bucket entries, the perf report, the
    capture state and the drain state, with the reference's top-level
    keys (the bucket entries' own keys name the port's kernels); the perf
    report's phases are the same script's in both."""
    (s_ref, b_ref), (s_port, b_port) = _payloads(endpoints, path)
    assert s_ref == s_port == 200, (path, s_ref, s_port)
    ref, port = json.loads(b_ref), json.loads(b_port)
    assert isinstance(ref, dict) and isinstance(port, dict)
    if path == "/debug/buckets":
        assert all("rungs" in entry for entry in port.values()), port
        return
    assert set(ref) == set(port), path
    if path == "/debug/perf":
        assert ref["phases"] == port["phases"]
        assert ref["scan_rung_mix"] == port["scan_rung_mix"]
        assert ref["device_memory"] is port["device_memory"] is None


@pytest.mark.parametrize("path", ("/nope", "/debug/nope", "/debug/trace/x"))
def test_left_out_routes_answer_as_unknown(endpoints, path):
    assert _get(endpoints["batch_scheduler_tpu_torch"], path) == (404, b"")


@pytest.mark.parametrize("path", MALFORMED)
def test_malformed_queries_answer_400_like_reference(endpoints, path):
    (s_ref, b_ref), (s_port, b_port) = _payloads(endpoints, path)
    assert s_ref == s_port == 400
    assert json.loads(b_ref) == json.loads(b_port)


# ---------------------------------------------------------------------------
# the flight records a ScheduleOperation writes
# ---------------------------------------------------------------------------


def _records(name, gangs):
    tr = importlib.import_module(f"{name}.utils.trace")
    snap = tr.DEFAULT_FLIGHT_RECORDER.snapshot()
    return {
        g: [{k: v for k, v in r.items() if k not in ("ts", "trace_id")}
            for r in snap.get(g, [])]
        for g in gangs
    }


def _race(name):
    """The README race: one node, two gangs of five one-cpu pods, ~7.1
    free cpus — the first gang places, the second is denied."""
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    core = importlib.import_module(f"{name}.core.operation")
    errs = importlib.import_module(f"{name}.utils.errors")
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    nodes, groups, pods = scen.race_scenario()
    for n in nodes:
        cluster.add_node(n)
    sys_pod = scen.make_member_pods("sys", 1, {"cpu": "900m"})[0]
    sys_pod.metadata.labels = {}
    cluster.assume(sys_pod, nodes[0].metadata.name)
    cache = cm.PGStatusCache()
    for pg in groups:
        cache.set(pg.full_name(), cm.PodGroupMatchStatus(pg))
    kw = {"device": "cpu"} if name.endswith("_torch") else {}
    op = core.ScheduleOperation(cache, cluster, scorer="oracle", **kw)
    outcomes = []
    for pod in (pods[pg.metadata.name][0] for pg in groups):
        try:
            op.pre_filter(pod)
            outcomes.append("ok")
        except errs.SchedulingError as e:
            outcomes.append(type(e).__name__)
    return op, cache, [pg.full_name() for pg in groups], outcomes


def test_denial_records_match_reference():
    """The race's denied gang: one coalesced pre_filter record with its
    blame and the served capacity row's feasible-node count, equal in both
    packages; the pending tracker counts the denial."""
    seen = []
    for name in PACKAGES:
        tr = importlib.import_module(f"{name}.utils.trace")
        tr.DEFAULT_FLIGHT_RECORDER.clear()
        op, cache, gangs, outcomes = _race(name)
        recs = _records(name, gangs)
        seen.append((outcomes, recs, op.pending_tracker.report()["pending_gangs"]))
        denied = [r for rs in recs.values() for r in rs if r["phase"] == "pre_filter"]
        assert denied and all("feasible_nodes" in r for r in denied)
        g = denied[0]["gang"]
        assert denied[0]["feasible_nodes"] == op.oracle.feasible_node_count(g)
        # a deleted gang leaves the tracker and closes its lifecycle
        cache.delete(g)
        assert op.pending_tracker.report()["pending_gangs"] == 0
    assert seen[0] == seen[1]


_POLICY_LABELS = [
    {"policy.batch.scheduler.tpu/affinity": "pool:p1"},
    {"policy.batch.scheduler.tpu/anti-affinity": "team:red"},
    {"policy.batch.scheduler.tpu/spread": "1"},
    {"policy.batch.scheduler.tpu/spread": "1",
     "policy.batch.scheduler.tpu/affinity": "zone=z2"},
    {},
]


def _policy_op(name):
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    core = importlib.import_module(f"{name}.core.operation")
    eng = importlib.import_module(f"{name}.policy.engine")
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    for i in range(12):
        cluster.add_node(scen.make_sim_node(
            f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"},
            labels={"zone": f"z{i % 4}", "pool": f"p{i % 3}",
                    "team": "red" if i % 2 else "blue"}))
    cache = cm.PGStatusCache()
    pods = []
    for j, labels in enumerate(_POLICY_LABELS):
        pg = scen.make_sim_group(f"gang-{j}", 3 + j % 3, creation_ts=float(j))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = cm.PodGroupMatchStatus(pg)
        pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"}, priority=j % 2)[0]
        pod.metadata.labels.update(labels)
        pgs.pod = pod
        cache.set(pg.full_name(), pgs)
        pods.append(pod)
    kw = {"device": "cpu"} if name.endswith("_torch") else {}
    cfg = eng.PolicyConfig(terms=("affinity", "anti-affinity", "spread"))
    op = core.ScheduleOperation(cache, cluster, scorer="oracle", policy=cfg, **kw)
    for pod in pods:
        op.pre_filter(pod)
    return [pg for pg in sorted(cache.snapshot())]


def test_policy_blame_records_match_reference():
    """Every placed gang of a policy operation gets one ``policy`` record
    whose per-term contributions are equal in both packages."""
    seen = []
    for name in PACKAGES:
        eng = importlib.import_module(f"{name}.policy.engine")
        saved = eng._active[0]
        tr = importlib.import_module(f"{name}.utils.trace")
        tr.DEFAULT_FLIGHT_RECORDER.clear()
        try:
            gangs = _policy_op(name)
        finally:
            eng._active[0] = saved
        seen.append(_records(name, gangs))
    assert seen[0] == seen[1]
    policy = [r for rs in seen[1].values() for r in rs if r["phase"] == "policy"]
    assert len(policy) == len(_POLICY_LABELS)
    assert all(r["verdict"] == "info" and "priority_class" in r["terms"] for r in policy)
    assert any("affinity_penalty" in r["terms"] for r in policy)
