"""The port's audit layer (batch_scheduler_tpu_torch.utils.audit, the
replay rungs of core.oracle_scorer and utils.health.IdentityAuditor) on
the CPU: the counterparts of tests/test_audit.py's ring, v2 re-fold,
replay and identity-audit tests; rings that cross between the two
packages in both directions (each package's reader re-folds and replays
the other's records identically); the two scorers' plan_digest and
input_digest sequences on one cluster script; plan_digest equal across
the packages in both mask modes, both readback forms and both scan
paths; and the port's metrics registry rendering the reference's text.
Digests are compared exactly and every array is an integer or a bool:
the tolerance is exact equality."""

from __future__ import annotations

import glob
import importlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from batch_scheduler_tpu_torch.core.oracle_scorer import (
    OracleScorer,
    REPLAY_RUNGS,
    replay_audit_record,
    replay_batch,
)
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
from batch_scheduler_tpu_torch.ops.snapshot import (
    ClusterSnapshot,
    DeltaSnapshotPacker,
    GroupDemand,
    _demand_fp,
)
from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node
from batch_scheduler_tpu_torch.utils import audit as audit_mod
from batch_scheduler_tpu_torch.utils.audit import AuditLog, AuditReader
from batch_scheduler_tpu_torch.utils.health import IdentityAuditor
from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
NODE_ALLOC = {"cpu": "8", "memory": "32Gi", "pods": "64"}


def _make_snapshot(n=5, g=4, cpu_per_member=1000):
    nodes = [make_sim_node(f"n{i}", NODE_ALLOC) for i in range(n)]
    groups = [
        GroupDemand(f"default/g{i}", 3, member_request={"cpu": cpu_per_member},
                    creation_ts=float(i))
        for i in range(g)
    ]
    return ClusterSnapshot(nodes, {}, groups)


def _executed(snap):
    host, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cpu")
    return host


def _record(log, snap, host, **kw):
    return log.record_batch(
        batch_args=snap.device_args(),
        progress_args=snap.progress_args(),
        result=host,
        plan_digest=audit_mod.plan_digest(host),
        node_names=snap.node_names,
        group_names=snap.group_names,
        **kw,
    )


def _args_equal(got, want):
    return all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))


def _only_segment(path):
    (segment,) = glob.glob(os.path.join(str(path), "audit-*.jsonl"))
    return segment


# -- ring mechanics (tests/test_audit.py:72-166) ------------------------------

def test_roundtrip_bit_identical_through_deltas(tmp_path):
    """Keyframe + row-delta records reconstruct to exactly the recorded
    arrays, across churn that rewrites some rows between records."""
    log = AuditLog(str(tmp_path), keyframe_every=4)
    snaps, hosts = [], []
    requested = {}
    for i in range(6):
        requested[f"n{i % 5}"] = {"cpu": 1000 * (i + 1), "pods": i + 1}
        nodes = [make_sim_node(f"n{j}", NODE_ALLOC) for j in range(5)]
        groups = [GroupDemand(f"default/g{j}", 3, member_request={"cpu": 1000},
                              creation_ts=float(j)) for j in range(4)]
        snap = ClusterSnapshot(nodes, dict(requested), groups)
        host = _executed(snap)
        _record(log, snap, host)
        snaps.append(snap)
        hosts.append(host)
    assert log.flush()
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert len(batches) == 6 and not skipped
    kinds = [rec["keyframe"] for rec in batches]
    assert True in kinds and False in kinds
    for rec, snap, host in zip(batches, snaps, hosts):
        assert _args_equal(rec["batch_args"], snap.device_args())
        assert _args_equal(rec["progress_args"], snap.progress_args())
        assert rec["plan_digest"] == audit_mod.plan_digest(host)
    log.stop()


def test_ring_rotation_respects_size_cap(tmp_path):
    """Oldest segments are deleted once the ring exceeds cap_bytes, and
    the survivors still read back and replay."""
    snap = _make_snapshot()
    host = _executed(snap)
    log = AuditLog(str(tmp_path), cap_bytes=40_000, keyframe_every=1)
    log.segment_bytes = 8_000
    for _ in range(40):
        _record(log, snap, host)
    assert log.flush()
    segments = glob.glob(os.path.join(str(tmp_path), "audit-*.jsonl"))
    total = sum(os.path.getsize(p) for p in segments)
    assert total <= 40_000 + 8_000 + 4096
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert batches and not skipped
    assert replay_audit_record(batches[-1], against="steady", device="cpu")["identical"]
    log.stop()


def test_keyframe_recovery_after_truncation(tmp_path):
    """Deltas whose keyframe was rotated away are reported as
    unreconstructable and reconstruction resumes at the next keyframe."""
    snap = _make_snapshot()
    host = _executed(snap)
    log = AuditLog(str(tmp_path), keyframe_every=3)
    for _ in range(7):  # keyframes at seq 1, 4 and 7
        _record(log, snap, host)
    assert log.flush()
    log.stop()
    segment = _only_segment(tmp_path)
    with open(segment) as f:
        lines = f.readlines()
    with open(segment, "w") as f:
        f.writelines(lines[2:])
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert len(skipped) == 1 and "keyframe" in skipped[0]["reason"]
    assert [rec["seq"] for rec in batches] == [4, 5, 6, 7]
    for rec in batches:
        assert _args_equal(rec["batch_args"], snap.device_args())


# -- audit format v2 (tests/test_audit.py:172-370) ----------------------------

def _fold_ring(tmp_path, steps=6, keyframe_every=4):
    """A v2 ring recorded from a real fold sequence of the port's packer:
    one full pack, then ``steps`` pack_fold refreshes (node churn, group
    progress churn, one priority bump that resorts the queue order).
    Returns (log, snaps, hosts) with the log NOT yet stopped."""
    nodes = [make_sim_node(f"n{j}", NODE_ALLOC) for j in range(5)]
    groups = [GroupDemand(f"default/g{j}", 3, member_request={"cpu": 1000},
                          creation_ts=float(j)) for j in range(4)]
    node_req = {n.metadata.name: {} for n in nodes}
    packer = DeltaSnapshotPacker()
    log = AuditLog(str(tmp_path), fmt="v2", keyframe_every=keyframe_every)

    def record(snap, ev):
        host = _executed(snap)
        refold = (snap.schema, snap.lite_fps) if snap.lite_fps is not None else None
        _record(log, snap, host, event_fold=ev, refold=refold)
        return host

    snap = packer.pack(nodes, node_req, groups)
    snaps, hosts = [snap], [record(snap, None)]
    for i in range(steps):
        nm = f"n{i % 5}"
        node_req[nm] = {"cpu": 1000 * (i + 1), "pods": i + 1}
        g = groups[i % 4]
        g.scheduled = min(i, 2)
        if i == 3:
            g.priority = 5  # sort-key churn: the re-fold must resort too
        fsnap = packer.pack_fold([(nm, dict(node_req[nm]))], [g])
        assert fsnap is not None, f"fold step {i} bailed"
        ev = {"bumps": i + 1, "nodes": [(nm, dict(node_req[nm]))],
              "groups": [(g.full_name, _demand_fp(g))]}
        hosts.append(record(fsnap, ev))
        snaps.append(fsnap)
    return log, snaps, hosts


def test_v2_event_records_refold_bit_identical(tmp_path):
    """event_batch records reconstruct by RE-FOLDING the recorded event
    stream through the port's packer: bit-identical inputs (input_digest
    checked per step) and identical replay on every rung."""
    log, snaps, hosts = _fold_ring(tmp_path)
    assert log.flush()
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert len(batches) == 7 and not skipped
    kinds = [rec.get("record_kind", "array") for rec in batches]
    assert kinds.count("event_batch") >= 4, kinds
    for rec, snap, host in zip(batches, snaps, hosts):
        assert _args_equal(rec["batch_args"] + rec["progress_args"],
                           snap.device_args() + snap.progress_args())
        assert rec["plan_digest"] == audit_mod.plan_digest(host)
        if rec.get("record_kind") == "event_batch":
            assert rec["refold"] == {"input_digest_ok": True, "first_divergent_event": None}
            assert "assignment_nodes" not in rec["result_arrays"]
    for rec in batches:
        for rung in REPLAY_RUNGS:
            rep = replay_audit_record(rec, against=rung, device="cpu")
            assert rep["identical"], (rung, rep)
            assert rep.get("refolded", False) == (rec.get("record_kind") == "event_batch")
    log.stop()


def test_v2_tampered_event_batch_blames_event(tmp_path):
    """A tampered event batch: the re-folded input digest diverges at the
    tampered record, replay diverges, and blame names the event."""
    log, _, _ = _fold_ring(tmp_path, keyframe_every=100)
    assert log.flush()
    log.stop()
    segment = _only_segment(tmp_path)
    with open(segment) as f:
        lines = [json.loads(ln) for ln in f.read().splitlines() if ln]
    tampered_seq = None
    for rec in lines:
        if rec.get("kind") == "event_batch" and rec["events"]["groups"]:
            rec["events"]["groups"][0][1][1] -= 1  # min_member 3 -> 2
            tampered_seq = rec["seq"]
            break
    assert tampered_seq is not None
    with open(segment, "w") as f:
        f.writelines(json.dumps(rec, sort_keys=True) + "\n" for rec in lines)
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert not skipped
    divergent = [rec for rec in batches
                 if (rec.get("refold") or {}).get("first_divergent_event")]
    assert divergent and divergent[0]["seq"] == tampered_seq
    for rec in divergent:
        assert rec["refold"]["first_divergent_event"]["seq"] == tampered_seq
    rep = replay_audit_record(divergent[0], against="steady", device="cpu")
    assert rep["identical"] is False
    blame = rep["blame"]
    assert blame["field"] == "<event-stream>"
    assert blame["first_divergent_event"]["seq"] == tampered_seq
    assert blame["fold"]["outcome"] == "input-divergence"


def test_v2_rotated_keyframe_reports_unreconstructable(tmp_path):
    """An event_batch record whose base keyframe rotated away is
    unreconstructable with the fold outcome named, and re-folding resumes
    bit-exactly at the next keyframe."""
    log, snaps, _ = _fold_ring(tmp_path, keyframe_every=3)
    assert log.flush()
    log.stop()
    segment = _only_segment(tmp_path)
    with open(segment) as f:
        lines = f.readlines()
    with open(segment, "w") as f:
        f.writelines(lines[2:])
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert len(skipped) == 1 and skipped[0]["seq"] == 3
    assert skipped[0]["fold_outcome"] == "no-base"
    assert "keyframe" in skipped[0]["reason"]
    assert [rec["seq"] for rec in batches] == [4, 5, 6, 7]
    for rec, snap in zip(batches, snaps[3:]):
        assert _args_equal(rec["batch_args"], snap.device_args())
        if rec.get("record_kind") == "event_batch":
            assert rec["refold"]["input_digest_ok"]


def test_v2_ring_telemetry(tmp_path):
    """bst_audit_ring_bytes / bst_audit_records_total{kind} and the
    bytes-per-record readout of ring_stats."""
    log, _, _ = _fold_ring(tmp_path)
    assert log.flush()
    segments = glob.glob(os.path.join(str(tmp_path), "audit-*.jsonl"))
    assert log.ring_bytes == sum(os.path.getsize(p) for p in segments) > 0
    gauge = DEFAULT_REGISTRY.get("bst_audit_ring_bytes")
    assert gauge.value(ring=str(tmp_path)) == float(log.ring_bytes)
    counter = DEFAULT_REGISTRY.get("bst_audit_records_total")
    kinds = {dict(k).get("kind") for k in counter.values()}
    assert {"event_batch", "batch"} <= kinds
    mine = [r for r in audit_mod.ring_stats() if r["dir"] == str(tmp_path)]
    assert mine and mine[0]["format"] == "v2"
    by_kind = mine[0]["by_kind"]
    assert by_kind["event_batch"]["records"] >= 4
    assert by_kind["event_batch"]["bytes_per_record"] < by_kind["batch"]["bytes_per_record"]
    log.stop()


# -- writer faults (tests/test_audit.py:373-458) ------------------------------

def test_writer_failure_forces_keyframe(tmp_path):
    """A failed segment append drops the delta chain: the next record is a
    keyframe, never a delta against the record that is not on disk."""
    def churned_snap(i):
        nodes = [make_sim_node(f"n{j}", NODE_ALLOC) for j in range(5)]
        groups = [GroupDemand(f"default/g{j}", 3, member_request={"cpu": 1000},
                              creation_ts=float(j)) for j in range(4)]
        return ClusterSnapshot(nodes, {"n0": {"cpu": 1000 * (i + 1)}}, groups)

    log = AuditLog(str(tmp_path), keyframe_every=100)
    s1 = churned_snap(0)
    _record(log, s1, _executed(s1))
    assert log.flush()
    orig_append = log._append

    def failing_append(line):
        raise OSError("disk full")

    log._append = failing_append
    s2 = churned_snap(1)
    _record(log, s2, _executed(s2))
    assert log.flush()
    log._append = orig_append
    s3 = churned_snap(2)
    _record(log, s3, _executed(s3))
    assert log.flush()
    assert log.write_errors == 1
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert [rec["seq"] for rec in batches] == [1, 3] and not skipped
    assert batches[1]["keyframe"]
    assert _args_equal(batches[1]["batch_args"], s3.device_args())
    assert replay_audit_record(batches[1], against="steady", device="cpu")["identical"]
    log.stop()


def test_seq_resumes_across_processes(tmp_path):
    snap = _make_snapshot()
    host = _executed(snap)
    log = AuditLog(str(tmp_path))
    _record(log, snap, host)
    _record(log, snap, host)
    assert log.flush()
    log.stop()
    log2 = AuditLog(str(tmp_path))  # a restart on the same ring
    _record(log2, snap, host)
    assert log2.flush()
    log2.stop()
    batches, _ = AuditReader(str(tmp_path)).batches()
    assert [rec["seq"] for rec in batches] == [1, 2, 3]


def test_queue_overflow_drops_never_blocks(tmp_path):
    snap = _make_snapshot()
    host = _executed(snap)
    log = AuditLog(str(tmp_path))
    log._q.maxsize = 2
    gate = threading.Event()
    log._q.put({"kind": "_sync", "_event": gate})  # the writer parks after it
    t0 = time.monotonic()
    for _ in range(20):
        _record(log, snap, host)
    assert time.monotonic() - t0 < 1.0, "the hot path must never block"
    assert log.records_dropped > 0
    log.stop()


# -- replay and divergence blame (tests/test_audit.py:461-566) -----------------

def _one_record(tmp_path, snap=None):
    snap = snap or _make_snapshot()
    log = AuditLog(str(tmp_path))
    _record(log, snap, _executed(snap))
    assert log.flush()
    log.stop()
    (rec,), _ = AuditReader(str(tmp_path)).batches()
    return rec, snap


def test_replay_bit_identical_across_rungs(tmp_path):
    rec, _ = _one_record(tmp_path)
    for rung in REPLAY_RUNGS:
        rep = replay_audit_record(rec, against=rung, device="cpu")
        assert rep["identical"], (rung, rep)
        assert rep["replayed_digest"] == rec["plan_digest"]


def test_replay_divergence_report_is_structured(tmp_path):
    """A tampered record: the blame names the field, the first differing
    gang, both config fingerprints and the executed rung."""
    rec, _ = _one_record(tmp_path)
    rec["result_arrays"]["placed"] = 1 - rec["result_arrays"]["placed"]
    rec["plan_digest"] = "0" * 64
    rep = replay_audit_record(rec, against="cpu-ladder", device="cpu")
    assert not rep["identical"]
    blame = rep["blame"]
    assert blame["field"] == "placed"
    assert blame["gang"] == "default/g0"
    assert blame["recorded"] != blame["replayed"]
    assert blame["replay_config"]["backend"] == "cpu"
    assert blame["recorded_config"]["backend"] in ("cpu", "cuda")
    assert blame["executed_rung"] == {"device": "cpu", "scan": "plain", "wave_width": 0}
    assert blame["bucket"] == [rec["shape"]["g_bucket"], rec["shape"]["n_bucket"]]


def test_replay_tampered_assignment_count_names_gang(tmp_path):
    """One assignment count changed in a record (and its digest taken over
    the changed plan): the replay diverges and blames assignment_counts
    at that gang and node."""
    rec, snap = _one_record(tmp_path)
    counts = rec["result_arrays"]["assignment_counts"]
    g = int(np.flatnonzero(counts[:, 0] > 0)[0])
    counts[g, 0] += 1
    rec["plan_digest"] = audit_mod.plan_digest(rec["result_arrays"])
    rep = replay_audit_record(rec, against="steady", device="cpu")
    assert rep["identical"] is False
    blame = rep["blame"]
    assert (blame["field"], blame["gang"], blame["slot"]) == (
        "assignment_counts", snap.group_names[g], 0)
    assert blame["node"] == snap.node_names[blame["node_index"]]


def test_replay_input_divergence_blames_assignment(tmp_path):
    """Tampered INPUTS make the replayed plan genuinely diverge: the
    report localizes the first differing field rather than crash."""
    rec, snap = _one_record(tmp_path)
    alloc = rec["batch_args"][0].copy()
    alloc[: len(snap.node_names)] //= 4  # shrink every real node
    rec["batch_args"] = (alloc,) + tuple(rec["batch_args"][1:])
    rep = replay_audit_record(rec, against="steady", device="cpu")
    assert not rep["identical"]
    assert rep["blame"]["field"] in audit_mod.PLAN_FIELDS
    assert rep["blame"]["differing_elements"] > 0


def test_replay_skips_degraded_reference_records(tmp_path):
    """A degraded record (the reference sidecar's conservative fallback
    batch, written by the JAX AuditLog) is skipped by the port's replay."""
    from batch_scheduler_tpu.core.oracle_scorer import conservative_cpu_batch
    from batch_scheduler_tpu.ops.snapshot import ClusterSnapshot as JaxSnapshot
    from batch_scheduler_tpu.ops.snapshot import GroupDemand as JaxDemand
    from batch_scheduler_tpu.sim.scenarios import make_sim_node as jax_node
    from batch_scheduler_tpu.utils import audit as jax_audit

    snap = JaxSnapshot([jax_node(f"n{i}", NODE_ALLOC) for i in range(5)], {},
                       [JaxDemand(f"default/g{i}", 3, member_request={"cpu": 1000})
                        for i in range(4)])
    host, _ = conservative_cpu_batch(snap)
    log = jax_audit.AuditLog(str(tmp_path))
    log.record_batch(batch_args=snap.device_args(), progress_args=snap.progress_args(),
                     result=host, plan_digest=jax_audit.plan_digest(host),
                     degraded=True)
    assert log.flush()
    log.stop()
    (rec,), _ = AuditReader(str(tmp_path)).batches()
    assert rec["degraded"]
    rep = replay_audit_record(rec, against="steady", device="cpu")
    assert rep["identical"] is None and "degraded" in rep["skipped"]


def test_replay_of_policy_record_raises(tmp_path):
    """A policy record replays through the policy scan, whose wrapper
    checks the columns: columns of the wrong shape raise (naming the
    column) on every rung rather than replay on another scan."""
    rec, _ = _one_record(tmp_path)
    rec["policy_args"] = (tuple(np.zeros(8, np.int32) for _ in audit_mod.POLICY_ARG_NAMES),
                          ("affinity",), (1,))
    for rung in REPLAY_RUNGS:
        with pytest.raises(ValueError, match="gang_dom must be"):
            replay_audit_record(rec, against=rung, device="cpu")


@pytest.mark.parametrize("rung,wave", [("steady", 0), ("wavefront", 8), ("cpu-ladder", 0)])
def test_replay_reports_executed_rung(tmp_path, rung, wave):
    rec, _ = _one_record(tmp_path)
    rep = replay_audit_record(rec, against=rung, device="cpu")
    assert rep["identical"]
    assert rep["executed_rung"] == {"device": "cpu", "scan": "plain", "wave_width": wave}


def test_replay_rung_pin_is_thread_local(monkeypatch):
    """A rung pinned on one thread never changes the rung another thread
    dispatches, and the pin is gone after the replay."""
    monkeypatch.delenv("BST_SCAN_WAVE", raising=False)
    snap = _make_snapshot()
    pinned, release = threading.Event(), threading.Event()
    seen = {}

    def replayer():
        with port_oracle.forced_scan_rung(8):
            host, _ = execute_batch_host(snap.device_args(), snap.progress_args(),
                                         device="cpu")
            seen["pinned"] = host["telemetry"]["wave_width"]
            pinned.set()
            release.wait(30)

    t = threading.Thread(target=replayer)
    t.start()
    try:
        assert pinned.wait(30)
        host = _executed(snap)
        assert host["telemetry"]["wave_width"] == 0
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive() and seen["pinned"] == 8
    host, _ = replay_batch(snap.device_args(), snap.progress_args(), against="wavefront",
                           device="cpu")
    assert host["telemetry"]["wave_width"] == 8
    assert getattr(port_oracle._rung_override, "value", None) is None
    assert _executed(snap)["telemetry"]["wave_width"] == 0


@pytest.mark.parametrize("rung", ["gpu-ladder", "topk"])
def test_replay_unknown_rung(rung):
    snap = _make_snapshot()
    with pytest.raises(ValueError, match="unknown replay rung") as err:
        replay_batch(snap.device_args(), snap.progress_args(), against=rung, device="cpu")
    assert all(r in str(err.value) for r in REPLAY_RUNGS)


# -- scorer integration and the identity audit (tests/test_audit.py:594-650) ---

class _FakeCluster:
    def __init__(self, nodes):
        self._nodes = nodes

    def version(self):
        return 0

    def list_nodes(self):
        return self._nodes

    def node_requested(self, name):
        return {}


class _FakeStatusCache:
    def snapshot(self):
        return {}


def test_scorer_publish_records_audit(tmp_path):
    log = AuditLog(str(tmp_path))
    scorer = OracleScorer(device="cpu", audit_log=log)
    nodes = [make_sim_node(f"n{i}", NODE_ALLOC) for i in range(4)]
    scorer.refresh(_FakeCluster(nodes), _FakeStatusCache())
    assert log.flush()
    (rec,), _ = AuditReader(str(tmp_path)).batches()
    assert not rec["speculative"] and not rec["degraded"] and rec["trace_id"] is None
    assert rec["plan_digest"] == audit_mod.plan_digest(scorer._state.result)
    assert rec["refresh"]["kind"] == "keyframe" and rec["refresh"]["reason"] == "first"
    assert rec["telemetry"] == scorer.last_telemetry
    assert replay_audit_record(rec, against="steady", device="cpu")["identical"]
    assert scorer.stats()["audit"]["publish_errors"] == 0
    log.stop()


def test_record_config_names_the_batch_device(tmp_path, monkeypatch):
    """A keyframe's config fingerprint names the device its batch ran on
    (the telemetry's), not the process default: a batch a CPU scorer ran
    on a host with a card records backend ``cpu``."""
    snap = _make_snapshot()
    host = _executed(snap)
    assert host["telemetry"]["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    assert audit_mod.config_fingerprint()["backend"] == "cuda"
    log = AuditLog(str(tmp_path), keyframe_every=1)
    _record(log, snap, host, telemetry=host["telemetry"])
    _record(log, snap, host, telemetry=dict(host["telemetry"], device="cuda:0"))
    assert log.flush()
    log.stop()
    batches, _ = AuditReader(str(tmp_path)).batches()
    assert [(rec["config"]["backend"], rec["config"]["device_name"]) for rec in batches] == [
        ("cpu", "cpu"), ("cuda", "card")]


def test_audit_error_is_counted_not_raised(tmp_path):
    """An audit failure never fails a publish, and it is counted."""
    log = AuditLog(str(tmp_path))
    scorer = OracleScorer(device="cpu", audit_log=log)

    def broken(**kw):
        raise RuntimeError("audit down")

    log.record_batch = broken
    nodes = [make_sim_node(f"n{i}", NODE_ALLOC) for i in range(4)]
    scorer.refresh(_FakeCluster(nodes), _FakeStatusCache())
    assert scorer.batches_run == 1 and scorer.max_group() == ""
    assert scorer.stats()["audit"]["publish_errors"] == 1
    log.stop()


def test_identity_audit_ok_and_mismatch(tmp_path):
    log = AuditLog(str(tmp_path))
    snap = _make_snapshot()
    host = _executed(snap)
    digest = audit_mod.plan_digest(host)
    counter = DEFAULT_REGISTRY.counter("bst_identity_audit_total")
    before = {o: counter.value(outcome=o) for o in ("ok", "mismatch")}
    auditor = IdentityAuditor(every=1)
    auditor.note_batch(snap.device_args(), snap.progress_args(), digest, "a" * 16, log)
    assert auditor.drain(60.0)
    assert auditor.stats() == {"identity_audits": 1, "identity_mismatches": 0,
                               "identity_errors": 0}
    auditor.note_batch(snap.device_args(), snap.progress_args(), "f" * 64, "b" * 16, log)
    assert auditor.drain(60.0)
    assert auditor.mismatches == 1 and auditor.errors == 0
    assert counter.value(outcome="ok") == before["ok"] + 1
    assert counter.value(outcome="mismatch") == before["mismatch"] + 1
    assert log.flush()
    events = [r for r in AuditReader(str(tmp_path)).records() if r.get("kind") == "event"]
    assert [e["event"] for e in events] == ["identity_mismatch"]
    assert events[0]["audit_id"] == "b" * 16 and events[0]["rung"] == "cpu-ladder"
    assert events[0]["expected"] == "f" * 64 and events[0]["got"] == digest
    log.stop()


def test_identity_audit_samples_every_kth(tmp_path):
    """every=2: the first batch is not verified, the second is."""
    snap = _make_snapshot()
    digest = audit_mod.plan_digest(_executed(snap))
    auditor = IdentityAuditor(every=2)
    auditor.note_batch(snap.device_args(), snap.progress_args(), digest, None)
    assert auditor.drain(60.0) and auditor.audits == 0
    auditor.note_batch(snap.device_args(), snap.progress_args(), digest, None)
    assert auditor.drain(60.0) and auditor.audits == 1 and auditor.mismatches == 0


# -- a cluster script through a scorer with an audit log -----------------------

def _world(name):
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    for i in range(12):
        cluster.add_node(scen.make_sim_node(
            f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"}))
    cache = cm.PGStatusCache()
    for j in range(6):
        ns = "team-a" if j % 2 else "team-b"
        pg = scen.make_sim_group(f"gang-{j}", 2 + j % 3, namespace=ns,
                                 creation_ts=float(j % 3))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"}, namespace=ns,
                                        priority=j % 2)[0]
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 30, {"cpu": "1", "memory": "1Gi"})
    return scen, cm, cluster, cache, pods


def _script(scen, cm, cluster, cache, pods, scorer):
    """Yields once after each mutation round: folds (node and gang rows,
    a priority move), a blind mark (scan), and a new gang (keyframe)."""
    names = sorted(cache.snapshot())
    yield  # the first refresh
    for r in range(10):
        for k in range(3):
            cluster.assume(pods[3 * r + k], f"n{(5 * r + k) % 12:02d}")
        if r >= 1:
            cluster.forget(pods[3 * (r - 1)].metadata.uid)
        name = names[r % len(names)]
        cache.get(name).pod_group.status.scheduled += 1
        scorer.mark_dirty(group=name)
        if r == 3:
            cache.get(names[-1]).pod.spec.priority = 7
            scorer.mark_dirty(group=names[-1])
        if r == 5:
            scorer.mark_dirty()  # blind: the next refresh scans
        if r == 7:
            pg = scen.make_sim_group("gang-new", 2, creation_ts=9.0)
            pg.spec.min_resources = {"cpu": 1000}
            pgs = cm.PodGroupMatchStatus(pg)
            pgs.pod = scen.make_member_pods("gang-new", 1, {"cpu": "1"})[0]
            cache.set(pg.full_name(), pgs)
            scorer.mark_dirty(group=pg.full_name())
        yield


def _drive(name, directory, fmt, keyframe_every=4, served=None):
    """The cluster script through ``name``'s OracleScorer with an audit log
    of format ``fmt``: the refreshes' host dicts (plan fields copied at
    serve time, in ``served``) and the flushed ring's directory."""
    scorer_mod = importlib.import_module(f"{name}.core.oracle_scorer")
    audit = importlib.import_module(f"{name}.utils.audit")
    log = audit.AuditLog(directory, fmt=fmt, keyframe_every=keyframe_every)
    kw = {"device": "cpu"} if name.endswith("_torch") else {}
    scorer = scorer_mod.OracleScorer(audit_log=log, **kw)
    world = _world(name)
    for _ in _script(*world, scorer):
        scorer.refresh(world[2], world[3])
        if served is not None:
            served.append({k: np.array(scorer._state.result[k], copy=True)
                           for k in audit_mod.PLAN_FIELDS})
    assert log.flush()
    log.stop()
    return scorer


def test_records_hold_the_served_host_dicts(tmp_path):
    """Records enqueued by reference back to back read back equal to the
    host dicts the scorer served, copied at serve time: no array the
    writer serialized later had been overwritten by a later batch."""
    served = []
    scorer = _drive(PACKAGES[1], str(tmp_path), "array", keyframe_every=16, served=served)
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert not skipped and len(batches) == len(served) == scorer.batches_run == 11
    for rec, host in zip(batches, served):
        assert rec["plan_digest"] == audit_mod.plan_digest(host)
        for k in audit_mod.PLAN_FIELDS:
            np.testing.assert_array_equal(rec["result_arrays"][k],
                                          audit_mod.canonical_plan(host)[k], err_msg=k)
    sources = [rec["refresh"]["source"] for rec in batches]
    assert "events" in sources and "scan" in sources
    assert {t: n for t, n in batches[0]["tenants"].items()} == {"team-a": 3, "team-b": 3}


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """The cluster script's ring from each package's scorer in each
    format, driven once for the module's cross-package tests:
    ``{(package, fmt): directory}``. The tests only read them."""
    out = {}
    for name in PACKAGES:
        for fmt in ("array", "v2"):
            d = str(tmp_path_factory.mktemp(f"{name}-{fmt}"))
            _drive(name, d, fmt)
            out[name, fmt] = d
    return out


def _ring_summary(directory, reader_mod):
    """Per record: (record kind, keyframe, plan digest, input digest,
    refresh provenance, tenants)."""
    batches, skipped = reader_mod.AuditReader(directory).batches()
    assert not skipped
    return [(rec.get("record_kind", "batch"), rec["keyframe"], rec["plan_digest"],
             rec.get("input_digest"), rec.get("refresh"), rec.get("tenants"))
            for rec in batches]


@pytest.mark.parametrize("fmt", ["array", "v2"])
def test_scorers_record_equal_digest_sequences(rings, fmt):
    """The same cluster script through both packages' scorers with an
    audit log gives equal plan_digest (and, in v2, input_digest)
    sequences record by record, with the same record kinds, refresh
    provenance and tenant stamps."""
    from batch_scheduler_tpu.utils import audit as jax_audit

    ref, port = (_ring_summary(rings[name, fmt], mod)
                 for name, mod in zip(PACKAGES, (jax_audit, audit_mod)))
    assert len(port) == 11 and port == ref
    if fmt == "v2":
        assert sum(kind == "event_batch" for kind, *_ in port) >= 4
        assert all(row[3] for row in port)


@pytest.mark.parametrize("fmt", ["array", "v2"])
def test_port_ring_replays_in_reference(rings, fmt):
    """A ring the port writes is read by the JAX AuditReader (v2 event
    records re-folded through the JAX packer) and every record replays
    identical under the JAX replay_audit_record on cpu-ladder."""
    from batch_scheduler_tpu.core.oracle_scorer import replay_audit_record as jax_replay
    from batch_scheduler_tpu.utils.audit import AuditReader as JaxReader

    batches, skipped = JaxReader(rings[PACKAGES[1], fmt]).batches()
    assert len(batches) == 11 and not skipped
    refolded = [rec for rec in batches if rec.get("record_kind") == "event_batch"]
    assert bool(refolded) == (fmt == "v2")
    assert all(rec["refold"]["input_digest_ok"] for rec in refolded)
    for rec in batches:
        assert jax_replay(rec, against="cpu-ladder")["identical"], rec["seq"]


@pytest.mark.parametrize("fmt", ["array", "v2"])
def test_reference_ring_replays_in_port(rings, fmt):
    """A ring the JAX package writes is read by the port's AuditReader (v2
    event records re-folded through the port's packer) and every record
    replays identical in the port on steady and cpu-ladder."""
    batches, skipped = AuditReader(rings[PACKAGES[0], fmt]).batches()
    assert len(batches) == 11 and not skipped
    refolded = [rec for rec in batches if rec.get("record_kind") == "event_batch"]
    assert bool(refolded) == (fmt == "v2")
    assert all(rec["refold"]["input_digest_ok"] for rec in refolded)
    for rec in batches:
        for rung in ("steady", "cpu-ladder"):
            assert replay_audit_record(rec, against=rung, device="cpu")["identical"], rung


# -- plan_digest across the packages -------------------------------------------

def _digest_inputs(mask_mode, big):
    """A padded batch through the JAX package's pad_oracle_batch: seeded
    gangs over seeded nodes, broadcast or per-gang mask; ``big`` adds a
    gang of 70,000 members, which takes the unpacked readback."""
    from batch_scheduler_tpu.ops.bucketing import pad_oracle_batch

    rng = np.random.default_rng(31 if big else 17)
    n, g, r = 40, 24, 4
    alloc = rng.integers(4, 64, size=(n, r)).astype(np.int32) * 1000
    requested = (alloc * rng.random((n, r)) * 0.5).astype(np.int32)
    group_req = rng.integers(0, 4, size=(g, r)).astype(np.int32) * 1000
    group_req[:, 3] = 1
    remaining = rng.integers(1, 12, size=g).astype(np.int32)
    if big:
        alloc[0] = [2**29, 2**29, 2**29, 100000]
        group_req[0] = [1, 0, 0, 1]
        remaining[0] = 70000
    mask = (rng.random((g, n)) < 0.8) if mask_mode == "per_group" else np.ones((1, n), bool)
    return pad_oracle_batch(
        alloc=alloc, requested=requested, group_req=group_req, remaining=remaining,
        fit_mask=mask, group_valid=np.ones(g, bool),
        order=rng.permutation(g).astype(np.int32), min_member=remaining + 1,
        scheduled=np.ones(g, np.int32), matched=np.zeros(g, np.int32),
        ineligible=np.zeros(g, bool), creation_rank=np.arange(g, dtype=np.int32),
    )


@pytest.mark.parametrize("wave", [None, "8"], ids=["serial", "wave8"])
@pytest.mark.parametrize("big", [False, True], ids=["packed", "unpacked"])
@pytest.mark.parametrize("mask_mode", ["broadcast", "per_group"])
def test_plan_digest_matches_reference(monkeypatch, mask_mode, big, wave):
    """The port's host dict digests to the JAX package's digest for the
    same inputs, with either package's plan_digest."""
    from batch_scheduler_tpu.ops.oracle import execute_batch_host as jax_execute
    from batch_scheduler_tpu.utils import audit as jax_audit

    if wave:
        monkeypatch.setenv("BST_SCAN_WAVE", wave)
    else:
        monkeypatch.delenv("BST_SCAN_WAVE", raising=False)
    batch_args, progress_args = _digest_inputs(mask_mode, big)
    ref, _ = jax_execute(batch_args, progress_args)
    port, _ = execute_batch_host(batch_args, progress_args, device="cpu")
    assert port["telemetry"]["mask_mode"] == mask_mode
    assert port["telemetry"]["wave_width"] == (8 if wave else 0)
    assert port["assignment_counts"].max() > (2**16 - 1 if big else 0)
    digest = audit_mod.plan_digest(port)
    assert digest == jax_audit.plan_digest(ref) == jax_audit.plan_digest(port)


# -- the metrics registry ------------------------------------------------------

def _exercise(registry):
    c = registry.counter("bst_test_total", 'help with "quotes"\nand a newline')
    c.inc()
    c.inc(2.5, outcome="ok", kind='we"ird\\')
    c.inc(outcome="mismatch")
    g = registry.gauge("bst_test_bytes", "ring bytes")
    g.set(12345, ring="/a/b")
    g.set(0.5)
    h = registry.histogram("bst_test_seconds", "latency")
    for v in (0.0003, 0.02, 0.02, 3.0, 11.0):
        h.observe(v, path="fold")
    h.observe(0.2)
    registry.histogram("bst_test_custom", "custom", buckets=(1, 5, 2)).observe(3)
    registry.counter("bst_test_empty", "never incremented")
    return registry.render(), h.quantile(0.5, path="fold"), h.count(path="fold")


def test_registry_renders_reference_text():
    from batch_scheduler_tpu.utils.metrics import Registry as JaxRegistry
    from batch_scheduler_tpu_torch.utils.metrics import Registry

    assert _exercise(Registry()) == _exercise(JaxRegistry())


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_card_ring_replays_on_cpu_ladder(tmp_path):
    """A ring recorded by a scorer on the card (both formats) replays
    identical on cpu-ladder, and on steady on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda

    for fmt in ("array", "v2"):
        d = str(tmp_path / fmt)
        log = AuditLog(d, fmt=fmt, keyframe_every=4)
        scorer = OracleScorer(device="cuda", audit_log=log, identity_audit_every=1)
        world = _world(PACKAGES[1])
        for _ in _script(*world, scorer):
            scorer.refresh(world[2], world[3])
        assert scorer._identity.drain(120.0) and log.flush()
        stats = scorer.stats()["audit"]
        assert stats["identity_audits"] >= 1 and stats["identity_mismatches"] == 0
        assert stats["publish_errors"] == 0 and stats["identity_errors"] == 0
        batches, skipped = AuditReader(d).batches()
        assert len(batches) == 11 and not skipped
        launches = assign_gangs_cuda.launches
        for rec in batches:
            assert rec["telemetry"]["scan"] == "cuda_kernel"
            assert rec["config"]["backend"] == "cuda"
            assert replay_audit_record(rec, against="cpu-ladder")["identical"], rec["seq"]
            assert replay_audit_record(rec, against="steady")["identical"], rec["seq"]
        assert assign_gangs_cuda.launches - launches == len(batches)
        log.stop()


def test_v2_fold_after_unrecorded_refresh_keyframes(tmp_path):
    """A refresh published while the scorer had no audit log leaves a pack
    the v2 ring never saw: the next fold must be written as a keyframe
    (the pack generation does not follow the last record's), so every
    record still re-folds and replays identically. The reference's writer
    checks only queue drops and writes an event record there, whose
    re-fold diverges."""
    log = AuditLog(str(tmp_path), fmt="v2", keyframe_every=100)
    scorer = OracleScorer(device="cpu", audit_log=log)
    world = _world(PACKAGES[1])
    for i, _ in enumerate(_script(*world, scorer)):
        scorer.configure_audit(None if i == 2 else log)
        scorer.refresh(world[2], world[3])
    assert log.flush()
    batches, skipped = AuditReader(str(tmp_path)).batches()
    assert len(batches) == 10 and not skipped
    assert [rec["refresh"]["generation"] for rec in batches[1:4]] == [2, 4, 5]
    assert batches[2]["keyframe"] and batches[3].get("record_kind") == "event_batch"
    for rec in batches:
        assert (rec.get("refold") or {"input_digest_ok": True})["input_digest_ok"]
        assert replay_audit_record(rec, against="cpu-ladder", device="cpu")["identical"]
    log.stop()
