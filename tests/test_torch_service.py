"""The port's oracle sidecar (batch_scheduler_tpu_torch/service/) against
the JAX package's, the port's server on ``device="cpu"``:

- the server's answers are the reference server's bytes, to the port's
  client, the JAX package's client and the native C++ client (under
  tests/conftest.py the JAX server runs sharded on its 8-device CPU mesh;
  the reference holds its plans equal across rungs);
- the delta-gate identity (benchmarks/delta_gate.py:483) both ways across
  the packages: wire-delta and full-snapshot remote scorers plan as the
  local scorer does;
- the mirror's DELTA_RESYNC, the in-band errors, the deadline path with
  the executor's queued batch intact, the executor's stop, drain, the
  audit id on both sides, the policy-skew counter;
- the remote scorer inside ScheduleOperation (the README race), and its
  conservative fallback through an outage and back.
"""

import importlib
import socket
import threading
import time

import numpy as np
import pytest
import torch

from batch_scheduler_tpu_torch.service import protocol as tproto

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _pkg(name, module):
    return importlib.import_module(f"{name}.{module}")


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


def _seeded_request(seed, n=40, g=12, mask="broadcast"):
    """A seeded unpadded request: 3 node shapes with random load, gangs of
    1-12 members over 5 lanes (a few infeasible), in one of three mask
    forms: one broadcast row, a uniform [G,N] mask (the server re-collapses
    it), or per-group zone selectors."""
    rng = np.random.default_rng(seed)
    shapes = np.array([[64000, 256 * 2**20, 100 * 2**20, 110, 8],
                       [32000, 128 * 2**20, 50 * 2**20, 110, 0],
                       [16000, 64 * 2**20, 20 * 2**20, 64, 0]], np.int64)
    alloc = shapes[rng.integers(0, 3, size=n)]
    requested = (alloc * rng.random((n, 5)) * 0.6).astype(np.int64)
    demands = np.array([[2000, 4 * 2**20, 0, 1, 0], [4000, 8 * 2**20, 0, 1, 1],
                        [8000, 32 * 2**20, 2**20, 1, 2], [200000, 2**20, 0, 1, 0]],
                       np.int64)
    group_req = demands[rng.choice(4, size=g, p=[0.4, 0.3, 0.2, 0.1])]
    remaining = rng.integers(1, 13, size=g)
    valid = rng.random(n) > 0.05
    if mask == "broadcast":
        fit = valid[None, :]
    elif mask == "uniform":
        fit = np.repeat(valid[None, :], g, axis=0)
    else:
        zone = rng.integers(0, 3, size=n)
        want = rng.integers(0, 3, size=g)
        sel = rng.random(g) < 0.5
        fit = np.where(sel[:, None], zone[None, :] == want[:, None], True) & valid
    return dict(
        alloc=alloc.astype(np.int32), requested=requested.astype(np.int32),
        group_req=group_req.astype(np.int32), remaining=remaining.astype(np.int32),
        fit_mask=fit, group_valid=np.ones(g, bool),
        order=rng.permutation(g).astype(np.int32),
        min_member=remaining.astype(np.int32), scheduled=np.zeros(g, np.int32),
        matched=np.zeros(g, np.int32), ineligible=rng.random(g) < 0.1,
        creation_rank=rng.permutation(g).astype(np.int32),
    )


REQUESTS = [(0, "broadcast"), (1, "uniform"), (2, "per_group"), (3, "broadcast")]


def _exchange(client_mod, srv, frames):
    """Open one connection with ``client_mod``'s OracleClient and send each
    ``(msg_type, payload)`` through its ``_round_trip``: the raw answers
    ``(type, bytes)`` (an in-band error as ``("error", message)``)."""
    client = client_mod.OracleClient(*srv.address, timeout=60)
    out = []
    try:
        for msg_type, payload in frames:
            try:
                out.append(client._round_trip(msg_type, payload))
            except RuntimeError as e:
                out.append(("error", str(e)))
    finally:
        client.close()
    return out


def _schedule_frames():
    frames = []
    for seed, mask in REQUESTS:
        req = tproto.ScheduleRequest(**_seeded_request(seed, mask=mask))
        frames.append((tproto.MsgType.SCHEDULE_REQ, tproto.pack_schedule_request(req)))
        seq = len(frames) - len([f for f in frames if f[0] == tproto.MsgType.ROW_REQ])
        for kind in tproto.ROW_KINDS:
            for gidx in (0, 5, 11):
                frames.append((tproto.MsgType.ROW_REQ,
                               tproto.pack_row_request(kind, gidx, seq)))
    return frames


@pytest.mark.parametrize("client_pkg", PACKAGES)
def test_schedule_and_row_answers_byte_identical_to_reference(servers, client_pkg):
    ref, port = servers
    client_mod = _pkg(client_pkg, "service.client")
    frames = _schedule_frames()
    want = _exchange(client_mod, ref, frames)
    got = _exchange(client_mod, port, frames)
    kinds = [t for t, _ in want]
    assert kinds.count(tproto.MsgType.SCHEDULE_RESP) == len(REQUESTS)
    assert kinds.count(tproto.MsgType.ROW_RESP) == 6 * len(REQUESTS)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"answer {i} differs"
    resp = tproto.unpack_schedule_response(got[0][1])
    assert resp.placed.any() and not resp.gang_feasible.all()


def test_native_client_gets_reference_answers(servers):
    from batch_scheduler_tpu_torch.service.native import NativeOracleClient, ensure_built

    if ensure_built() is None:
        pytest.skip("native client library unavailable (no C++ toolchain)")
    ref, port = servers
    answers = []
    for srv in (ref, port):
        native = NativeOracleClient(*srv.address)
        out = []
        for seed, mask in REQUESTS:
            resp = native.schedule(tproto.ScheduleRequest(**_seeded_request(seed, mask=mask)))
            out.append(tproto.pack_schedule_response(resp))
            out += [native.row(kind, 3, resp.batch_seq).tobytes()
                    for kind in tproto.ROW_KINDS]
        native.close()
        answers.append(out)
    assert answers[1] == answers[0]


def _frame_script():
    """Frames whose answers are deterministic: in-band errors and mirror
    refusals, in a fixed order on one connection."""
    P = tproto
    req = P.ScheduleRequest(**_seeded_request(4))
    n, g = req.alloc.shape[0], req.group_req.shape[0]
    rows = P.DeltaScheduleRequest(
        node_idx=np.array([1, 7], np.int32),
        node_rows=np.array([[1000, 2**20, 0, 1, 0], [0, 0, 0, 0, 0]], np.int32),
        group_idx=np.array([2], np.int32),
        group_rows=np.array([[1000, 2**20, 0, 1, 0]], np.int32),
        remaining=req.remaining, fit_mask=req.fit_mask, group_valid=req.group_valid,
        order=req.order, min_member=req.min_member, scheduled=req.scheduled,
        matched=req.matched, ineligible=req.ineligible,
        creation_rank=req.creation_rank, n=n, g=g, r=5,
    )
    import dataclasses

    overflow = dataclasses.replace(
        rows, node_rows=np.array([[2**31 - 1, 0, 0, 1, 0], [0] * 5], np.int32))
    wrong_shape = dataclasses.replace(rows, n=n + 8, fit_mask=np.ones((1, n + 8), bool))
    T = P.MsgType
    return [
        (T.PING, b""),
        (T.ROW_REQ, P.pack_row_request("capacity", 0, 0)),  # before any batch
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(0, 1, rows)),  # no mirror
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_keyframe(1, req)),
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(1, 2, rows)),
        (T.ROW_REQ, P.pack_row_request("scores", 2, 2)),
        (T.ROW_REQ, P.pack_row_request("capacity", 0, 1)),  # stale seq
        (T.ROW_REQ, P.pack_row_request("capacity", g, 2)),  # bad index
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(5, 6, rows)),  # generation gap
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(2, 3, wrong_shape)),
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(2, 3, overflow)),  # LANE_MAX
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(2, 3, rows)),
        (T.SCHEDULE_REQ, P.pack_schedule_request(req)),
        (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(3, 4, rows)),  # mirror dropped
        (T.SCHEDULE_REQ, P.pack_schedule_request(req) + b"\0"),  # trailing byte
        (99, b""),
        (T.PING, b""),
    ]


def test_errors_and_resyncs_byte_identical_to_reference(servers):
    ref, port = servers
    from batch_scheduler_tpu_torch.service import client as tclient
    from batch_scheduler_tpu_torch.utils.errors import DeltaResyncRequired

    script = _frame_script()
    want = _exchange(tclient, ref, script)
    got = _exchange(tclient, port, script)
    assert got == want
    R = tproto.MsgType.DELTA_RESYNC
    reasons = [tproto.unpack_delta_resync(b) for t, b in got if t == R]
    assert len(reasons) == 4
    assert reasons[1].startswith("generation gap: mirror at 2, delta base 5")
    assert reasons[2].startswith("shape mismatch")
    errors = [b for t, b in got if t == "error"]
    assert any("before any batch" in e for e in errors)
    assert any("stale batch" in e for e in errors)
    assert any("out of range" in e for e in errors)
    assert any("LANE_MAX" in e for e in errors)
    assert any("unknown message type 99" in e for e in errors)
    # the client's view of a resync: DeltaResyncRequired, in-band
    client = tclient.OracleClient(*port.address)
    with pytest.raises(DeltaResyncRequired, match="shape mismatch"):
        client.delta_schedule(tproto.DELTA_ROWS, 0, 1, _frame_script_rows())
    client.close()


def _frame_script_rows():
    req = _seeded_request(4)
    g = req["group_req"].shape[0]
    return tproto.DeltaScheduleRequest(
        node_idx=np.zeros(0, np.int32), node_rows=np.zeros((0, 5), np.int32),
        group_idx=np.zeros(0, np.int32), group_rows=np.zeros((0, 5), np.int32),
        remaining=req["remaining"], fit_mask=req["fit_mask"],
        group_valid=req["group_valid"], order=req["order"],
        min_member=req["min_member"], scheduled=req["scheduled"],
        matched=req["matched"], ineligible=req["ineligible"],
        creation_rank=req["creation_rank"], n=req["alloc"].shape[0], g=g, r=5,
    )


# -- the delta-gate identity across the packages ----------------------------


def _gate_state(name):
    """benchmarks/delta_gate.py's wire-identity cluster in one package's
    objects: 8 nodes (8 cpu, 32Gi, 110 pods) in a ClusterState and 5
    gangs of 3 one-cpu members."""
    scen = _pkg(name, "sim.scenarios")
    cache_mod = _pkg(name, "cache.pg_cache")
    phases = _pkg(name, "api.types").PodGroupPhase
    cluster = _pkg(name, "framework.cluster").ClusterState()
    for i in range(8):
        cluster.add_node(scen.make_sim_node(
            f"n{i}", {"cpu": "8", "memory": "32Gi", "pods": "110"}))
    cache = cache_mod.PGStatusCache()
    for i in range(5):
        pg = scen.make_sim_group(f"gang{i}", 3, creation_ts=float(i))
        pg.status.phase = phases.PENDING
        pgs = cache_mod.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang{i}", 1, {"cpu": "1"})[0]
        cache.set(pg.full_name(), pgs)
    return cluster, cache, scen


def _wire_identity(client_pkg, srv):
    """Three scorers of ``client_pkg`` against ``srv`` — remote on wire
    deltas, remote pinned to full snapshots, local — plus the other
    package's local scorer on its own copy of the cluster, over 4 rounds
    of a blind mark and a filler pod; returns (mismatches, wire deltas)."""
    other = PACKAGES[1 - PACKAGES.index(client_pkg)]
    cmod = _pkg(client_pkg, "service.client")
    reg = _pkg(client_pkg, "utils.metrics").DEFAULT_REGISTRY
    host, port = srv.address
    delta_remote = cmod.RemoteScorer(cmod.ResilientOracleClient(host, port, timeout=60, window=2))
    full_remote = cmod.RemoteScorer(cmod.ResilientOracleClient(host, port, timeout=60, window=2))
    full_remote._wire_delta_ok = False  # pinned to full snapshots
    states = {name: _gate_state(name) for name in PACKAGES}
    locals_ = {
        name: _pkg(name, "core.oracle_scorer").OracleScorer(
            **({"device": "cpu"} if name.endswith("_torch") else {}))
        for name in PACKAGES
    }
    scorers = [(delta_remote, client_pkg), (full_remote, client_pkg),
               (locals_[client_pkg], client_pkg), (locals_[other], other)]
    counter = reg.counter("bst_oracle_wire_delta_batches_total")
    deltas_before = counter.value(kind="delta")
    gangs = [f"default/gang{i}" for i in range(5)]
    mismatches = []
    try:
        for rnd in range(4):
            for s, name in scorers:
                cluster, cache, _ = states[name]
                s.mark_dirty()
                s.ensure_fresh(cluster, cache, group=gangs[0])
            for gname in gangs:
                plans = [(s.placed(gname), s.gang_feasible(gname),
                          tuple(sorted(s.assignment(gname).items())),
                          s.node_capacity(gname, "n3"), s.node_score(gname, "n5"))
                         for s, _ in scorers]
                if any(p != plans[0] for p in plans):
                    mismatches.append((rnd, gname, plans))
            for name in PACKAGES:
                cluster, _, scen = states[name]
                filler = scen.make_member_pods(f"filler-{rnd}", 1, {"cpu": "2"})[0]
                cluster.assume(filler, f"n{rnd}")
        return mismatches, counter.value(kind="delta") - deltas_before
    finally:
        delta_remote.close()
        full_remote.close()


def test_port_remote_scorer_against_reference_server(servers):
    mismatches, deltas = _wire_identity("batch_scheduler_tpu_torch", servers[0])
    assert not mismatches
    assert deltas >= 2


def test_reference_remote_scorer_against_port_server(servers):
    mismatches, deltas = _wire_identity("batch_scheduler_tpu", servers[1])
    assert not mismatches
    assert deltas >= 2


def test_port_remote_scorer_against_port_server_churn(servers):
    """Event-fold churn (named gangs, assume/forget) through the port's own
    pair: every refresh's plan and rows equal the local scorer's, and the
    lanes ship deltas after their keyframes."""
    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.service import RemoteScorer, ResilientOracleClient

    cluster, cache, scen = _gate_state("batch_scheduler_tpu_torch")
    remote = RemoteScorer(ResilientOracleClient(*servers[1].address, window=2))
    local = OracleScorer(device="cpu")
    names = sorted(cache.snapshot())
    pods = iter(scen.make_member_pods("churn", 20, {"cpu": "1"}))
    held = []
    for rnd in range(6):
        for s in (remote, local):
            s.ensure_fresh(cluster, cache)
        for gname in names:
            assert remote.placed(gname) == local.placed(gname)
            assert remote.assignment(gname) == local.assignment(gname)
            for node in ("n0", "n4", "n7"):
                assert remote.node_capacity(gname, node) == local.node_capacity(gname, node)
                assert remote.node_score(gname, node) == local.node_score(gname, node)
        for uid in held:
            cluster.forget(uid)
        held = []
        pod = next(pods)
        cluster.assume(pod, f"n{rnd}")
        held.append(pod.metadata.uid)
        name = names[rnd % len(names)]
        cache.get(name).pod_group.status.scheduled += 1
        for s in (remote, local):
            s.mark_dirty(group=name)
    assert remote.last_fold_outcome == "folded"
    assert all(c.synced for c in remote._cursors)
    remote.close()


# -- executor, deadline, drain ----------------------------------------------


def test_deadline_leaves_queued_batch_intact(monkeypatch):
    """The in-flight batch blows its DEADLINE while another connection's
    batch is queued behind it: the queued batch comes back complete and
    right (the executor collects the abandoned batch), and the deadline
    connection's next request is right."""
    import batch_scheduler_tpu_torch.service.server as server_mod
    from batch_scheduler_tpu_torch.service import OracleClient, serve_background
    from batch_scheduler_tpu_torch.utils import errors as errs

    srv = serve_background(device="cpu")
    try:
        req = tproto.ScheduleRequest(**_seeded_request(5))
        client_a = OracleClient(*srv.address)
        client_b = OracleClient(*srv.address)
        want = tproto.pack_schedule_response(client_a.schedule(req))
        stall_started = threading.Event()
        stalled_once = []
        real = server_mod.dispatch_batch

        def stalling_dispatch(*args, **kwargs):
            if not stalled_once:
                stalled_once.append(1)
                stall_started.set()
                time.sleep(1.2)
            return real(*args, **kwargs)

        monkeypatch.setattr(server_mod, "dispatch_batch", stalling_dispatch)
        b_result = {}

        def run_b():
            stall_started.wait(10.0)
            b_result["resp"] = client_b.schedule(req)

        t = threading.Thread(target=run_b, daemon=True)
        t.start()
        with pytest.raises(errs.OracleDeadlineError, match="exceeded deadline of 200ms"):
            client_a._round_trip(tproto.MsgType.SCHEDULE_REQ,
                                 tproto.pack_schedule_request(req), deadline_ms=200)
        t.join(30.0)
        assert not t.is_alive(), "queued batch never completed"
        resp_b = b_result["resp"]
        resp_b.batch_seq = 1
        assert tproto.pack_schedule_response(resp_b) == want
        monkeypatch.setattr(server_mod, "dispatch_batch", real)
        resp_a = client_a.schedule(req)
        resp_a.batch_seq = 1
        assert tproto.pack_schedule_response(resp_a) == want
        client_a.close()
        client_b.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_executor_refuses_jobs_after_stop():
    from batch_scheduler_tpu_torch.service.server import DeviceExecutor

    ex = DeviceExecutor(device="cpu")
    assert ex.run(lambda: 41 + 1) == 42
    gate = threading.Event()
    slow = ex._submit(__import__(
        "batch_scheduler_tpu_torch.service.server", fromlist=["_ExecJob"]
    )._ExecJob("call", fn=lambda: gate.wait(10.0)))
    queued = ex._submit(type(slow)("call", fn=lambda: "ran"))
    stopper = threading.Thread(target=ex.stop, daemon=True)
    stopper.start()
    time.sleep(0.05)
    gate.set()
    stopper.join(10.0)
    assert not stopper.is_alive()
    assert slow.wait(1.0) is True
    # a job queued before the stop sentinel still runs; nothing hangs
    assert queued.wait(1.0) == "ran"
    with pytest.raises(RuntimeError, match="device executor stopped"):
        ex.run(lambda: 1)
    with pytest.raises(RuntimeError, match="device executor stopped"):
        ex.run_batch((), ())


def test_drain_refuses_work_and_answers_ping():
    from batch_scheduler_tpu_torch.service import (
        OracleClient, ResilientOracleClient, serve_background)
    from batch_scheduler_tpu_torch.service.server import active_servers
    from batch_scheduler_tpu_torch.utils.errors import OracleDrainingError
    from batch_scheduler_tpu_torch.utils.retry import RetryPolicy

    srv = serve_background(device="cpu")
    try:
        assert srv in active_servers()
        req = tproto.ScheduleRequest(**_seeded_request(6))
        client = OracleClient(*srv.address)
        resp = client.schedule(req)
        report = srv.drain(timeout=5.0, failover_hint="10.0.0.9:9090")
        assert report["drained"] and report["inflight_at_flush"] == 0
        assert srv.draining()
        assert srv.drain(timeout=1.0) == report  # idempotent
        with pytest.raises(OracleDrainingError) as info:
            client.schedule(req)
        assert info.value.failover_hint == "10.0.0.9:9090"
        assert info.value.retry_after_ms == 200
        with pytest.raises(OracleDrainingError):
            client.row("capacity", 0, resp.batch_seq)
        assert client.ping()
        resilient = ResilientOracleClient(
            *srv.address, retry_policy=RetryPolicy(max_attempts=2, base_delay=0.001))
        with pytest.raises(OracleDrainingError):
            resilient.schedule(req)
        assert resilient.breaker.state == "closed"  # never a breaker failure
        client.close()
        resilient.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from batch_scheduler_tpu_torch.service import OracleServer, serve_background
    from batch_scheduler_tpu_torch.service.server import DeviceExecutor

    for make in (serve_background, OracleServer, DeviceExecutor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_two_connections_concurrently(servers):
    from batch_scheduler_tpu_torch.service import OracleClient

    port = servers[1]
    reqs = [tproto.ScheduleRequest(**_seeded_request(s, mask=m)) for s, m in REQUESTS]
    want = []
    solo = OracleClient(*port.address)
    for req in reqs:
        resp = solo.schedule(req)
        want.append([tproto.pack_schedule_response(resp)]
                    + [solo.row("capacity", 4, resp.batch_seq).tobytes()])
    solo.close()
    errors, results = [], {}

    def run(tag, order):
        try:
            c = OracleClient(*port.address)
            out = {}
            for _ in range(3):
                for i in order:
                    resp = c.schedule(reqs[i])
                    row = c.row("capacity", 4, resp.batch_seq).tobytes()
                    out.setdefault(i, []).append((resp, row))
            c.close()
            results[tag] = out
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=("a", [0, 1, 2, 3])),
               threading.Thread(target=run, args=("b", [3, 2, 1, 0]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    assert not errors
    assert sorted(results) == ["a", "b"]
    for out in results.values():
        for i, answers in out.items():
            for resp, row in answers:
                # the batch sequence number is per connection
                resp.batch_seq = tproto.unpack_schedule_response(want[i][0]).batch_seq
                assert tproto.pack_schedule_response(resp) == want[i][0]
                assert row == want[i][1]


# -- the scorer and the operation over the wire -------------------------------


def test_conservative_cpu_batch_matches_reference():
    from batch_scheduler_tpu.core.oracle_scorer import conservative_cpu_batch as jccb
    from batch_scheduler_tpu_torch.core.oracle_scorer import conservative_cpu_batch as tccb

    class Snap:
        pass

    infeasible = 0
    for seed, mask in REQUESTS:
        fields = _seeded_request(seed, mask=mask)
        snap = Snap()
        for k, v in fields.items():
            setattr(snap, k, v)
        snap.node_valid = np.random.default_rng(seed).random(fields["alloc"].shape[0]) > 0.1
        (jh, jrow), (th, trow) = jccb(snap), tccb(snap)
        assert jh.keys() == th.keys()
        for k in jh:
            np.testing.assert_array_equal(np.asarray(th[k]), np.asarray(jh[k]), err_msg=k)
        assert th["gang_feasible"].any() and not th["placed"].any()
        infeasible += int((~th["gang_feasible"]).sum())
        for gidx in range(fields["group_req"].shape[0]):
            for kind in tproto.ROW_KINDS:
                np.testing.assert_array_equal(trow(kind, gidx), jrow(kind, gidx))
    assert infeasible > 0


def _race_sequence(scorer_factory, name="batch_scheduler_tpu_torch"):
    """The README race scenario through ScheduleOperation (as
    tests/test_torch_operation.py drives it), with the scorer the factory
    makes; returns the outcome sequence."""
    scen = _pkg(name, "sim.scenarios")
    cache_mod = _pkg(name, "cache.pg_cache")
    snapshot = _pkg(name, "ops.snapshot")
    core = _pkg(name, "core.operation")
    phases = _pkg(name, "api.types").PodGroupPhase

    class Cluster:
        def __init__(self, nodes):
            self.nodes = list(nodes)
            self.bound = {n.metadata.name: [] for n in self.nodes}

        def list_nodes(self):
            return list(self.nodes)

        def node_requested(self, node_name):
            return snapshot.node_requested_from_pods(self.bound.get(node_name, []))

        def bind(self, pod, node_name):
            pod.spec.node_name = node_name
            self.bound[node_name].append(pod)

    nodes, groups, pods = scen.race_scenario()
    cluster = Cluster(nodes)
    sys_pod = scen.make_member_pods("sys", 1, {"cpu": "900m"})[0]
    sys_pod.metadata.labels = {}
    cluster.bind(sys_pod, "node-1")
    cache = cache_mod.PGStatusCache()
    for pg in groups:
        pg.status.phase = phases.PENDING
        cache.set(pg.full_name(), cache_mod.PodGroupMatchStatus(pg))
    op = core.ScheduleOperation(cache, cluster, scorer=scorer_factory(), device="cpu")

    def outcome(fn):
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — the outcome IS the error class
            return type(e).__name__
        return "ok" if out is None else (out.ready, out.error is None)

    seq = []
    for pod in pods["web-group-race1"]:
        seq.append(outcome(lambda: op.pre_filter(pod)))
        seq.append(outcome(lambda: op.filter(pod, "node-1")))
        seq.append(outcome(lambda: op.permit(pod, "node-1")))
    for pod in pods["web-group-race1"]:
        cluster.bind(pod, "node-1")
        op.post_bind(pod, "node-1")
    pg1 = cache.get("default/web-group-race1").pod_group
    seq.append((pg1.status.scheduled, pg1.status.phase.value))
    race2 = pods["web-group-race2"]
    seq.append(outcome(lambda: op.pre_filter(race2[0])))
    seq.append(outcome(lambda: op.pre_filter(race2[1])))
    seq.append(op.score(race2[0], "node-1"))
    return seq, op


@pytest.mark.parametrize("client", ("plain", "resilient"))
def test_race_scenario_through_remote_scorer(servers, client):
    from batch_scheduler_tpu_torch.service import (
        OracleClient, RemoteScorer, ResilientOracleClient)

    address = servers[1].address
    make_client = {"plain": lambda: OracleClient(*address),
                   "resilient": lambda: ResilientOracleClient(*address, window=2)}[client]
    remote_seq, op = _race_sequence(lambda: RemoteScorer(make_client()))
    local_seq, _ = _race_sequence(lambda: "oracle")
    assert remote_seq == local_seq
    assert remote_seq[-3:-1] == ["ResourceNotEnoughError", "DeniedError"]
    assert remote_seq[-1] > -(2**30)
    assert op.oracle.device is None and op.oracle._device_state is None
    assert not op.oracle.degraded
    op.oracle.close()


def test_audit_ids_correlate_across_the_wire(tmp_path):
    from batch_scheduler_tpu_torch.service import (
        RemoteScorer, ResilientOracleClient, serve_background)
    from batch_scheduler_tpu_torch.utils.audit import AuditLog, AuditReader

    server_log = AuditLog(str(tmp_path / "server"))
    client_log = AuditLog(str(tmp_path / "client"))
    srv = serve_background(device="cpu", audit_log=server_log)
    try:
        cluster, cache, _ = _gate_state("batch_scheduler_tpu_torch")
        remote = RemoteScorer(ResilientOracleClient(*srv.address, window=2))
        remote.configure_audit(client_log)
        for rnd in range(3):
            remote.mark_dirty()
            remote.ensure_fresh(cluster, cache)
        remote.close()
        assert client_log.flush(10.0) and server_log.flush(10.0)
        client_ids = [r["audit_id"] for r in AuditReader(str(tmp_path / "client")).batches()[0]]
        server_recs = AuditReader(str(tmp_path / "server")).batches()[0]
        assert len(client_ids) == 3
        assert [r["audit_id"] for r in server_recs] == client_ids
        assert all(r.get("side") == "server" for r in server_recs)
        # the server's records replay to their digests on the plain scan
        from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record

        for rec in server_recs:
            assert replay_audit_record(rec, against="cpu-ladder")["identical"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_policy_fingerprint_skew_is_counted(servers):
    from batch_scheduler_tpu_torch.core.operation import ScheduleOperation
    from batch_scheduler_tpu_torch.policy import engine as engine_mod
    from batch_scheduler_tpu_torch.policy.engine import PolicyConfig
    from batch_scheduler_tpu_torch.service import OracleClient, RemoteScorer
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    counter = DEFAULT_REGISTRY.counter("bst_policy_fingerprint_mismatch_total")
    saved = engine_mod._active[0]
    try:
        before = counter.value()
        client = OracleClient(*servers[1].address)
        req = tproto.ScheduleRequest(**_seeded_request(7))
        client.schedule(req, policy_fp="0123456789abcdef")
        assert counter.value() == before + 1
        client.schedule(req)  # no annotation: nothing counted
        assert counter.value() == before + 1
        client.close()
        # ScheduleOperation stamps its engine's fingerprint on a remote
        # scorer; the policy-unaware sidecar counts each such batch
        cluster, cache, _ = _gate_state("batch_scheduler_tpu_torch")
        scorer = RemoteScorer(OracleClient(*servers[1].address))
        cfg = PolicyConfig(terms=("affinity", "spread"))
        op = ScheduleOperation(cache, cluster, scorer=scorer, device="cpu", policy=cfg)
        # the engine registered itself process-wide; the sidecar runs in
        # this process here, and a real one has no engine
        engine_mod._active[0] = saved
        assert op.oracle is scorer
        assert scorer.policy_fingerprint == cfg.fingerprint()["fingerprint"]
        before = counter.value()
        scorer.ensure_fresh(cluster, cache)
        assert counter.value() == before + 1
        scorer.close()
    finally:
        engine_mod._active[0] = saved


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_outage_degrades_to_conservative_batch_and_recovers():
    """RemoteScorer(fallback="local-cpu") inside ScheduleOperation: with the
    sidecar stopped the scorer serves the conservative CPU batch (degraded,
    counted), PreFilter denies only the provably infeasible gang; after a
    restart on the same address the scorer recovers."""
    from batch_scheduler_tpu_torch.core.operation import ScheduleOperation
    from batch_scheduler_tpu_torch.service import (
        RemoteScorer, ResilientOracleClient, serve_background)
    from batch_scheduler_tpu_torch.utils import errors as errs
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY
    from batch_scheduler_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy

    cluster, cache, scen = _gate_state("batch_scheduler_tpu_torch")
    huge = scen.make_sim_group("huge", 3, creation_ts=10.0)
    huge.spec.min_resources = {"cpu": 64000}  # fits no 8-cpu node
    cache_mod = _pkg("batch_scheduler_tpu_torch", "cache.pg_cache")
    huge.status.phase = _pkg("batch_scheduler_tpu_torch", "api.types").PodGroupPhase.PENDING
    pgs = cache_mod.PodGroupMatchStatus(huge)
    pgs.pod = scen.make_member_pods("huge", 1, {"cpu": "64"})[0]
    cache.set(huge.full_name(), pgs)
    port = _free_port()
    srv = serve_background(port=port, device="cpu")
    clock = [0.0]
    client = ResilientOracleClient(
        "127.0.0.1", port, timeout=5.0, connect_timeout=1.0,
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.001),
        breaker=CircuitBreaker(failure_threshold=1, reset_timeout=5.0,
                               clock=lambda: clock[0]))
    scorer = RemoteScorer(client, fallback="local-cpu")
    op = ScheduleOperation(cache, cluster, scorer=scorer, device="cpu")
    fallback = DEFAULT_REGISTRY.counter("bst_oracle_fallback_batches_total")
    decisions = DEFAULT_REGISTRY.counter("bst_oracle_fallback_decisions_total")
    member = scen.make_member_pods("gang1", 1, {"cpu": "1"})[0]
    try:
        before = fallback.value()
        scorer.ensure_fresh(cluster, cache)
        assert not scorer.degraded and fallback.value() == before
        assert scorer.placed("default/gang1")
        srv.shutdown()
        srv.server_close()
        scorer.mark_dirty()
        pass_before = decisions.value(decision="pass")
        deny_before = decisions.value(decision="deny")
        op.pre_filter(member)  # feasible: passes without a plan
        assert scorer.degraded and fallback.value() == before + 1
        assert not scorer.placed("default/gang1")
        assert decisions.value(decision="pass") == pass_before + 1
        huge_pod = scen.make_member_pods("huge", 1, {"cpu": "64"})[0]
        with pytest.raises(errs.ResourceNotEnoughError, match="degraded oracle"):
            op.pre_filter(huge_pod)
        assert decisions.value(decision="deny") == deny_before + 1
        # the breaker is open: a stale degraded batch is served without a
        # probe until the cooldown ends
        assert not scorer._probe_due()
        srv = serve_background(port=port, device="cpu")
        clock[0] += 6.0
        assert scorer._probe_due()
        scorer.ensure_fresh(cluster, cache)  # the degraded batch expired
        assert not scorer.degraded
        assert scorer.placed("default/gang1")
    finally:
        scorer.close()
        srv.shutdown()
        srv.server_close()


@pytest.mark.cuda
def test_cuda_server_answers_equal_cpu_server():
    """On the card: the port's server on cuda (the scan kernels, the
    executor's own stream, the mirror resident on the card) answers every
    frame of the schedule/row and error/resync scripts with the bytes of
    the port's server on the CPU (the plain scans), serial and W=8."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os

    from batch_scheduler_tpu_torch.service import client as tclient
    from batch_scheduler_tpu_torch.service import serve_background

    saved = os.environ.get("BST_SCAN_WAVE")
    try:
        for wave in (None, "8"):
            if wave is None:
                os.environ.pop("BST_SCAN_WAVE", None)
            else:
                os.environ["BST_SCAN_WAVE"] = wave
            answers = []
            for device in ("cpu", "cuda"):
                srv = serve_background(device=device)
                try:
                    answers.append(_exchange(tclient, srv, _schedule_frames())
                                   + _exchange(tclient, srv, _frame_script()))
                finally:
                    srv.shutdown()
                    srv.server_close()
            assert answers[1] == answers[0]
    finally:
        if saved is None:
            os.environ.pop("BST_SCAN_WAVE", None)
        else:
            os.environ["BST_SCAN_WAVE"] = saved


class _OldPeer:
    """A frame relay in front of a server that plays a peer from before the
    TENANT and DELTA frames: it answers those two message types with the
    in-band ERROR such a server sends, and relays everything else."""

    def __init__(self, target):
        self._target = target
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._relay, args=(conn,), daemon=True).start()

    def _relay(self, conn):
        T = tproto.MsgType
        upstream = socket.create_connection(self._target)
        try:
            while True:
                msg_type, payload = tproto.read_frame(conn)
                if msg_type in (T.DELTA_SCHEDULE_REQ, T.TENANT):
                    tproto.write_frame(conn, T.ERROR,
                                       f"unknown message type {msg_type}".encode())
                    continue
                tproto.write_frame(upstream, msg_type, payload)
                if msg_type not in (T.DEADLINE, T.TRACE, T.AUDIT_ID, T.POLICY_INFO):
                    tproto.write_frame(conn, *tproto.read_frame(upstream))
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            conn.close()
            upstream.close()

    def close(self):
        self._listener.close()


def test_remote_scorer_downgrades_against_an_old_peer(servers):
    """Against a peer without the TENANT and DELTA frames the resilient
    remote scorer stops announcing its tenant and ships full snapshots,
    for good, and plans as the local scorer does."""
    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.service import RemoteScorer, ResilientOracleClient

    peer = _OldPeer(servers[1].address)
    try:
        cluster, cache, scen = _gate_state("batch_scheduler_tpu_torch")
        remote = RemoteScorer(ResilientOracleClient(*peer.address, window=2))
        local = OracleScorer(device="cpu")
        names = sorted(cache.snapshot())
        for rnd in range(3):
            for s in (remote, local):
                s.mark_dirty()
                s.ensure_fresh(cluster, cache)
            for gname in names:
                assert remote.placed(gname) == local.placed(gname)
                assert remote.assignment(gname) == local.assignment(gname)
                assert remote.node_capacity(gname, "n2") == local.node_capacity(gname, "n2")
            cluster.assume(scen.make_member_pods(f"old-{rnd}", 1, {"cpu": "2"})[0], f"n{rnd}")
        assert remote._wire_tenant_ok is False
        assert remote._wire_delta_ok is False
        assert not remote.degraded
        remote.close()
    finally:
        peer.close()


def test_pooled_client_fails_over_on_drain():
    """A two-address ResilientOracleClient promotes its standby when the
    primary answers DRAINING (never a breaker failure), and the remote
    scorer's lane re-keyframes on the standby."""
    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.service import RemoteScorer, ResilientOracleClient
    from batch_scheduler_tpu_torch.service import serve_background
    from batch_scheduler_tpu_torch.service.client import (
        active_failover_report, parse_oracle_addresses)

    primary, standby = serve_background(device="cpu"), serve_background(device="cpu")
    try:
        spec = ",".join(f"{h}:{p}" for h, p in (primary.address, standby.address))
        assert parse_oracle_addresses(spec) == [primary.address, standby.address]
        client = ResilientOracleClient(spec)
        remote = RemoteScorer(client)
        local = OracleScorer(device="cpu")
        cluster, cache, _ = _gate_state("batch_scheduler_tpu_torch")
        for s in (remote, local):
            s.ensure_fresh(cluster, cache)
        assert client.active_address == primary.address
        primary.drain(timeout=5.0)
        for s in (remote, local):
            s.mark_dirty()
            s.ensure_fresh(cluster, cache)
        assert client.active_address == standby.address
        assert client._breakers[0].state == "closed"
        report = [c for c in active_failover_report()["clients"] if c["client"] == spec]
        assert report and report[0]["promotions"][-1]["reason"] == "drain"
        for gname in sorted(cache.snapshot()):
            assert remote.assignment(gname) == local.assignment(gname)
            assert remote.node_capacity(gname, "n1") == local.node_capacity(gname, "n1")
        remote.close()
    finally:
        for srv in (primary, standby):
            srv.shutdown()
            srv.server_close()
