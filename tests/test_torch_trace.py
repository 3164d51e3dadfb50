"""The port's span pipeline and gang flight recorder
(``batch_scheduler_tpu_torch/utils/trace.py``) against the JAX package's
(``batch_scheduler_tpu/utils/trace.py``): the same script through both
modules gives the same span trees, sampling pattern, ring contents and
drop counts, Chrome-trace export, remote-span folding and flight-recorder
rings. Times and ids (``ts``, ``dur``, ``trace_id``, ``span_id``,
``parent_id``, ``tid``) differ run to run and are compared by shape: the
parent links are resolved to span names. Everything else is held to
exact equality. Then a traced ``OracleScorer.refresh`` of both packages
on the same cluster gives the same span name tree and the same ``_batch``
record, and a traced ``RemoteScorer`` refresh stitches the sidecar's
spans under the client's trace id."""

import importlib
import json

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
_IDS = ("ts", "dur", "tid", "trace_id", "span_id", "parent_id")


def _mods(name):
    return importlib.import_module(f"{name}.utils.trace")


@pytest.fixture
def traced():
    """Tracing on in both packages, empty default rings, sampler counter at
    zero; restored to the default (off, full sampling) afterwards."""
    mods = [_mods(n) for n in PACKAGES]
    for m in mods:
        m.configure(enabled=True, sample=1.0, capacity=m.DEFAULT_CAPACITY)
        m._sample_counter[0] = 0
        m.DEFAULT_FLIGHT_RECORDER.clear()
    yield mods
    for m in mods:
        m.configure(enabled=False, sample=1.0, capacity=m.DEFAULT_CAPACITY)
        m._sample_counter[0] = 0
        m.DEFAULT_FLIGHT_RECORDER.clear()


def _shape(events):
    """Span events with ids and times dropped and parents named."""
    names = {e["args"].get("span_id"): e["name"] for e in events}
    out = []
    for e in events:
        args = {k: v for k, v in e["args"].items() if k not in _IDS}
        out.append({
            **{k: v for k, v in e.items() if k not in _IDS + ("args",)},
            "args": args,
            "parent": names.get(e["args"].get("parent_id")),
        })
    return out


def _span_script(tr):
    """Roots, nesting, attributes set mid-span, an exception inside a span,
    and a span opened outside any trace."""
    with tr.span("orphan"):  # no live trace: the shared no-op
        pass
    with tr.start_trace("cycle", pods=3) as root:
        with tr.span("pre_filter", gang="ns/a"):
            with tr.span("oracle.refresh", cat="oracle") as s:
                s.set(groups=4)
        try:
            with tr.span("bind"):
                raise KeyError("x")
        except KeyError:
            pass
        root.set(verdict="placed")
    with tr.start_trace("cycle", trace_id="00000000000000aa"):
        assert tr.current_context()[0] == "00000000000000aa"
        with tr.span("select_node", pid="other"):
            pass
    assert tr.current_context() is None


def test_span_nesting_matches_reference(traced):
    shapes = []
    for tr in traced:
        _span_script(tr)
        shapes.append(_shape(tr.DEFAULT_RECORDER.snapshot()))
    assert shapes[0] == shapes[1]
    by_name = {e["name"]: e for e in shapes[1]}
    assert by_name["oracle.refresh"]["parent"] == "pre_filter"
    assert by_name["bind"]["args"]["error"] == "KeyError"
    assert "orphan" not in by_name


def test_child_spans_share_the_root_trace_id(traced):
    for tr in traced:
        with tr.start_trace("cycle"):
            tid = tr.current_context()[0]
            with tr.span("a"):
                with tr.span("b"):
                    assert tr.current_context()[0] == tid
        events = tr.DEFAULT_RECORDER.snapshot()
        assert {e["args"]["trace_id"] for e in events} == {tid}
        assert len(tid) == 16 and int(tid, 16) >= 0


@pytest.mark.parametrize("sample", [0.0, 0.25, 0.5, 1.0])
def test_sampling_keeps_the_same_roots(traced, sample):
    kept = []
    for tr in traced:
        tr.configure(enabled=True, sample=sample)
        tr._sample_counter[0] = 0
        for i in range(12):
            with tr.start_trace("cycle", i=i):
                with tr.span("child"):
                    pass
        kept.append([
            (e["name"], e["args"].get("i"))
            for e in tr.DEFAULT_RECORDER.snapshot()
        ])
    assert kept[0] == kept[1]
    assert len([k for k in kept[1] if k[0] == "cycle"]) == round(12 * sample)


def test_disabled_tracing_is_the_shared_null_span():
    for tr in (_mods(n) for n in PACKAGES):
        tr.configure(enabled=False)
        tr.DEFAULT_RECORDER.clear()
        assert tr.start_trace("cycle") is tr._NULL_SPAN
        with tr.start_trace("cycle") as s:
            assert tr.span("child") is tr._NULL_SPAN
            s.set(anything=1)
            assert tr.current_context() is None
        assert tr.DEFAULT_RECORDER.snapshot() == []
        assert not tr.enabled()


@pytest.mark.parametrize("capacity,count", [(4, 3), (4, 4), (4, 9), (1, 5)])
def test_ring_capacity_and_eviction(capacity, count):
    out = []
    for tr in (_mods(n) for n in PACKAGES):
        rec = tr.TraceRecorder(capacity=capacity)
        for i in range(count):
            rec.add({"name": f"s{i}", "ph": "X", "pid": "scheduler", "args": {}})
        out.append((rec.snapshot(), rec.dropped))
    assert out[0] == out[1]
    assert out[1][1] == max(0, count - capacity)
    assert [e["name"] for e in out[1][0]] == [
        f"s{i}" for i in range(max(0, count - capacity), count)
    ]


def test_configure_capacity_resizes_the_default_ring(traced):
    for tr in traced:
        tr.configure(enabled=True, capacity=3)
        for i in range(5):
            with tr.start_trace(f"t{i}"):
                pass
        events, dropped = tr.DEFAULT_RECORDER._snapshot_with_dropped()
        assert [e["name"] for e in events] == ["t2", "t3", "t4"]
        assert dropped == 2


def test_chrome_trace_export(traced, tmp_path):
    exports = []
    for i, tr in enumerate(traced):
        tr.configure(enabled=True, capacity=4)
        _span_script(tr)
        doc = tr.DEFAULT_RECORDER.chrome_trace()
        path = tr.DEFAULT_RECORDER.export(str(tmp_path / f"trace{i}.json"))
        with open(path) as f:
            assert json.load(f)["otherData"] == doc["otherData"]
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        exports.append((meta, _shape(spans), doc["displayTimeUnit"],
                        doc["otherData"]))
    assert exports[0] == exports[1]
    assert exports[1][3] == {"dropped_spans": 2}  # six spans, four kept


def test_record_remote_spans_folds_and_skips_malformed(traced):
    spans = [
        {"name": "oracle.schedule", "ts": 1.5e15, "dur": 120.0,
         "args": {"trace_id": "ab" * 8, "n": 4}},
        {"name": "oracle.device_batch", "ts": "1.6e15", "cat": "device",
         "tid": 7, "args": None},
        {"ts": 1.0},  # no name: skipped
        "not-a-dict",
        {"name": "bad-ts", "ts": "soon"},
        {"name": "no-dur", "ts": 2},
    ]
    out = []
    for tr in traced:
        tr.record_remote_spans(spans, pid="oracle-server")
        out.append(tr.DEFAULT_RECORDER.snapshot())
    assert out[0] == out[1]
    assert [e["name"] for e in out[1]] == [
        "oracle.schedule", "oracle.device_batch", "no-dur"]
    assert {e["pid"] for e in out[1]} == {"oracle-server"}


def _flight_script(rec):
    rec.record("ns1/a", phase="pre_filter", verdict="denied", reason="r1",
               coalesce=True, batch=1, feasible_nodes=3)
    rec.record("ns1/a", phase="pre_filter", verdict="denied", reason="r1",
               coalesce=True, batch=2, feasible_nodes=2)
    rec.record("ns1/a", phase="pre_filter", verdict="denied", reason="r2",
               coalesce=True, batch=3)
    rec.record("ns1/a", phase="pre_filter", verdict="denied", reason="r2",
               batch=4)  # not coalesced
    rec.record("ns2/b", phase="policy", verdict="info", terms={"x": 1})
    rec.record("_batch", phase="batch", verdict="info", batch=1,
               telemetry={"phase": "nested, never splatted"})
    for i in range(6):
        rec.record(f"ns3/g{i}", phase="permit", verdict="placed")
        rec.record("ns1/a", phase="pre_filter", verdict="denied", reason="r2",
                   coalesce=True, batch=5 + i)


def _no_ts(decisions):
    return {
        g: [{k: v for k, v in r.items() if k not in ("ts", "trace_id")}
            for r in recs]
        for g, recs in decisions.items()
    }


@pytest.mark.parametrize("per_gang,max_gangs", [(32, 1024), (2, 4), (1, 1)])
def test_flight_recorder_coalescing_and_bounds(per_gang, max_gangs):
    views = []
    for tr in (_mods(n) for n in PACKAGES):
        rec = tr.FlightRecorder(per_gang=per_gang, max_gangs=max_gangs)
        _flight_script(rec)
        decisions, dropped = rec._snapshot_with_dropped()
        views.append((
            _no_ts(decisions), dropped,
            _no_ts(rec.snapshot(tenant="ns1")),
            _no_ts(rec.snapshot(limit=2)), _no_ts(rec.snapshot(limit=0)),
            _no_ts(rec.snapshot(gang="ns1/a")),
            _no_ts(rec.snapshot(gang="missing")),
            {k: v for k, v in (rec.last("ns1/a") or {}).items() if k != "ts"},
            sorted(json.loads(rec.to_json()))
        ))
    assert views[0] == views[1]


def test_flight_record_carries_the_live_trace_id(traced):
    for tr in traced:
        rec = tr.FlightRecorder()
        with tr.start_trace("cycle"):
            tid = tr.current_context()[0]
            rec.record("ns/a", phase="pre_filter", verdict="denied")
        rec.record("ns/a", phase="pre_filter", verdict="wait")
        first, second = rec.snapshot()["ns/a"]
        assert first["trace_id"] == tid
        assert "trace_id" not in second
        assert first["tenant"] == "ns"


# ---------------------------------------------------------------------------
# a traced refresh of both packages' OracleScorer
# ---------------------------------------------------------------------------


def _world(name, n=16, g=6):
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
        pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"})[0]
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 8, {"cpu": "1", "memory": "1Gi"})
    return cluster, cache, pods


def _scorer(name, **kw):
    mod = importlib.import_module(f"{name}.core.oracle_scorer")
    if name.endswith("_torch"):
        return mod.OracleScorer(device="cpu", **kw)
    return mod.OracleScorer(**kw)


# the telemetry keys both packages' batches report (the rest name each
# package's own device and compiler)
_SHARED_TELEMETRY = ("mask_mode", "n_bucket", "g_bucket", "wave_width",
                     "scan_policy")


def _traced_refreshes(name, tmp_path, rounds=4):
    tr = _mods(name)
    audit = importlib.import_module(f"{name}.utils.audit")
    cluster, cache, pods = _world(name)
    log = audit.AuditLog(str(tmp_path / name), keyframe_every=2)
    scorer = _scorer(name, audit_log=log)
    trees, records, audit_traces, refresh_traces = [], [], [], []
    for k in range(rounds):
        if k:
            cluster.assume(pods[k], f"n{k:02d}")
        tr.DEFAULT_RECORDER.clear()
        with tr.start_trace("cycle"):
            scorer.refresh(cluster, cache)
        events = tr.DEFAULT_RECORDER.snapshot()
        trees.append(sorted(
            (e["name"], e["parent"], tuple(sorted(e["args"].items())))
            for e in _shape(events)
        ))
        refresh_traces.append(
            [e["args"]["trace_id"] for e in events if e["name"] == "oracle.refresh"]
        )
        batch = tr.DEFAULT_FLIGHT_RECORDER.last("_batch")
        records.append({
            **{k: v for k, v in batch.items()
               if k not in ("ts", "trace_id", "batch_ms", "pack_ms",
                            "audit_id", "telemetry")},
            "telemetry": {k: batch["telemetry"][k] for k in _SHARED_TELEMETRY},
            "trace_is_refresh": [batch.get("trace_id")] == refresh_traces[-1],
        })
    log.flush()
    for rec in audit.AuditReader(str(tmp_path / name)).batches()[0]:
        audit_traces.append(rec.get("trace_id"))
    return trees, records, audit_traces, refresh_traces


def test_traced_refresh_matches_reference(traced, tmp_path):
    ref, port = (_traced_refreshes(n, tmp_path) for n in PACKAGES)
    assert ref[0] == port[0]  # span name trees, attributes included
    assert ref[1] == port[1]  # the _batch records
    assert ("oracle.batch", "oracle.refresh",
            (("groups", 6), ("nodes", 16))) in port[0][0]
    assert {n for n, _, _ in port[0][1]} == {
        "cycle", "oracle.refresh", "oracle.event_fold",
        "oracle.device_state_sync", "oracle.batch"}
    assert all(r["trace_is_refresh"] for r in port[1])
    # every audit record is keyed by its refresh's trace id
    for _, _, audits, refreshes in (ref, port):
        assert [[a] for a in audits] == refreshes


def test_untraced_refresh_leaves_no_span_and_a_null_audit_trace(tmp_path):
    tr = _mods("batch_scheduler_tpu_torch")
    tr.configure(enabled=False)
    tr.DEFAULT_RECORDER.clear()
    _, _, audits, _ = _traced_refreshes("batch_scheduler_tpu_torch", tmp_path,
                                        rounds=2)
    assert tr.DEFAULT_RECORDER.snapshot() == []
    assert audits == [None, None]
    rec = tr.DEFAULT_FLIGHT_RECORDER.last("_batch")
    assert "trace_id" not in rec and rec["phase"] == "batch"


@pytest.fixture(scope="module")
def servers():
    """(reference server, port server on the CPU)."""
    from batch_scheduler_tpu.service import serve_background as jserve
    from batch_scheduler_tpu_torch.service import serve_background as tserve

    ref, port = jserve(), tserve(device="cpu")
    yield ref, port
    for srv in (ref, port):
        srv.shutdown()
        srv.server_close()


def test_remote_refresh_stitches_the_sidecar_spans(traced, servers):
    """A traced RemoteScorer refresh against the in-process sidecar of its
    package: the wire round trip nests under ``oracle.batch``, and the
    sidecar's four spans come back under the client's trace id with the
    round trip as their parent — once from the client's TRACE_INFO and
    once from the server's own ring (one process here, so one ring)."""
    trees = []
    for name, srv in zip(PACKAGES, servers):
        tr = _mods(name)
        cmod = importlib.import_module(f"{name}.service.client")
        cluster, cache, _ = _world(name)
        remote = cmod.RemoteScorer(cmod.ResilientOracleClient(*srv.address, window=2))
        tr.DEFAULT_RECORDER.clear()
        with tr.start_trace("cycle"):
            tid = tr.current_context()[0]
            remote.refresh(cluster, cache)
        events = tr.DEFAULT_RECORDER.snapshot()
        assert {e["args"]["trace_id"] for e in events} == {tid}
        trees.append(sorted((e["name"], e["parent"], e["pid"]) for e in _shape(events)))
        remote.close()
    assert trees[0] == trees[1]
    server_spans = [t for t in trees[1] if t[2] == "oracle-server"]
    assert sorted({t[0] for t in server_spans}) == [
        "oracle.device_batch", "oracle.lock_wait", "oracle.schedule",
        "oracle.unpack_pad"]
    assert len(server_spans) == 8
    assert {t[1] for t in server_spans} == {"oracle.wire_round_trip"}
    assert ("oracle.wire_round_trip", "oracle.batch", "scheduler") in trees[1]
