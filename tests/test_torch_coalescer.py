"""The port's multi-tenant coalescer (batch_scheduler_tpu_torch/service/
coalescer.py) against the JAX package's, the port's server on
``device="cpu"``:

- the mega demux's host twins (``find_max_group_host``,
  ``repack_assignment_span``) and the block-diagonal merge
  (``build_mega_batch``) equal the JAX functions, and the port's
  compaction orders a merged row's takes as ``lax.top_k`` does;
- a coalescing server answers K tenants' request scripts (full requests
  and wire deltas, both lowerings) with the bytes of the port's dedicated
  server and of the JAX package's coalescing server;
- the mega demux, checked directly against each tenant's dedicated batch;
- the DRF order, BUSY under a full queue (over the wire, the delta's
  mirror untouched, the resilient client's retry), a disconnect mid-merge,
  the TENANT attribution of the scan counter, and the knobs' guards.

Every wait here is on a condition (a gate the test opens), never on a
timing. Exact equality throughout.
"""

import importlib
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from batch_scheduler_tpu_torch.service import protocol as tproto

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _pkg(name, module):
    return importlib.import_module(f"{name}.{module}")


def _request(seed, n=32, g=8, lanes=4, per_group=False):
    """A seeded unpadded request (the reference test's generator): random
    load, gangs of 1-4 members, a broadcast row or per-group masks."""
    r = np.random.RandomState(seed)
    remaining = r.randint(1, 5, size=g).astype(np.int32)
    if per_group:
        mask = r.rand(g, n) > 0.2
        mask[:, 0] = True
    else:
        mask = np.ones((1, n), dtype=bool)
    return tproto.ScheduleRequest(
        alloc=r.randint(4, 64, size=(n, lanes)).astype(np.int32),
        requested=r.randint(0, 4, size=(n, lanes)).astype(np.int32),
        group_req=r.randint(1, 4, size=(g, lanes)).astype(np.int32),
        remaining=remaining,
        fit_mask=mask,
        group_valid=np.ones(g, dtype=bool),
        order=r.permutation(g).astype(np.int32),
        min_member=remaining.copy(),
        scheduled=np.zeros(g, dtype=np.int32),
        matched=r.randint(0, 2, size=g).astype(np.int32),
        ineligible=np.zeros(g, dtype=bool),
        creation_rank=r.permutation(g).astype(np.int32),
    )


def _raw(req):
    return (req.alloc, req.requested, req.group_req, req.remaining,
            req.fit_mask, req.group_valid, req.order, req.min_member,
            req.scheduled, req.matched, req.ineligible, req.creation_rank)


def _padded(pkg, req):
    return _pkg(pkg, "ops.bucketing").pad_oracle_batch(
        alloc=req.alloc, requested=req.requested, group_req=req.group_req,
        remaining=req.remaining, fit_mask=req.fit_mask,
        group_valid=req.group_valid, order=req.order,
        min_member=req.min_member, scheduled=req.scheduled,
        matched=req.matched, ineligible=req.ineligible,
        creation_rank=req.creation_rank,
    )


def _job(tenant, req):
    from batch_scheduler_tpu_torch.service.coalescer import CoalesceJob

    args, progress = _padded("batch_scheduler_tpu_torch", req)
    return CoalesceJob(tenant=tenant, n=req.alloc.shape[0], g=req.group_req.shape[0],
                       r=req.alloc.shape[1], padded_args=args, progress_args=progress,
                       raw_fn=lambda req=req: _raw(req))


def _close(srv):
    srv.shutdown()
    srv.server_close()


def _port_server(coalesce, **kw):
    from batch_scheduler_tpu_torch.service import serve_background

    return serve_background(device="cpu", coalesce=coalesce, **kw)


def _ref_coalescing_server():
    """The JAX package's sidecar pinned to one device (the coalescer's
    deployment shape: the conftest's 8-device mesh would make the
    reference skip its coalescer), with a live coalescer — the reference
    test's own arrangement."""
    from batch_scheduler_tpu.service.coalescer import OracleCoalescer
    from batch_scheduler_tpu.service.server import _capacity_tenant_shares, serve_background

    srv = serve_background()
    srv.scan_mesh = None
    srv.executor.scan_mesh = None
    if srv.coalescer is None:
        srv.coalescer = OracleCoalescer(srv.executor, weights_fn=_capacity_tenant_shares)
    return srv


class _Exchange:
    """One raw connection: annotation frames are written without an
    answer, every other frame's answer is read back as ``(type, bytes)``."""

    ANNOTATIONS = (tproto.MsgType.TENANT, tproto.MsgType.TRACE, tproto.MsgType.DEADLINE,
                   tproto.MsgType.AUDIT_ID, tproto.MsgType.POLICY_INFO)

    def __init__(self, srv):
        self.sock = socket.create_connection(srv.address, timeout=120)

    def send(self, msg_type, payload):
        tproto.write_frame(self.sock, msg_type, payload)
        if msg_type in self.ANNOTATIONS:
            return None
        return tproto.read_frame(self.sock)

    def close(self):
        self.sock.close()


# -- the demux's host twins and the merge -----------------------------------


def test_find_max_group_host_matches_reference_and_device():
    from batch_scheduler_tpu.ops.oracle import find_max_group_host as jhost
    from batch_scheduler_tpu_torch.ops.oracle import find_max_group, find_max_group_host

    r = np.random.RandomState(7)
    for trial in range(20):
        g = int(r.randint(2, 40))
        cols = (r.randint(1, 9, size=g).astype(np.int32),
                r.randint(0, 9, size=g).astype(np.int32),
                r.randint(0, 9, size=g).astype(np.int32),
                r.rand(g) < 0.3,
                r.permutation(g).astype(np.int32))
        hb, he, hp = find_max_group_host(*cols)
        jb, je, jp = jhost(*cols)
        db, de, dp = find_max_group(*(torch.from_numpy(c) for c in cols))
        assert (hb, he) == (jb, je) == (int(db), bool(de)), trial
        np.testing.assert_array_equal(hp, jp)
        np.testing.assert_array_equal(hp, dp.numpy())


def test_repack_assignment_span_matches_reference_and_compaction():
    """The demux's backfill rule equals the port's compaction
    (``_top_k_ties_by_index``) of the dedicated take vector — the
    ascending zero-count tail included — and the JAX repack, when the
    merged row comes from the same compaction of the wider space."""
    from batch_scheduler_tpu.ops.oracle import repack_assignment_span as jrepack
    from batch_scheduler_tpu_torch.ops.oracle import _top_k_ties_by_index, repack_assignment_span

    r = np.random.RandomState(3)
    for trial in range(10):
        nb, offset, k = 16, 32, 8
        local = np.zeros(nb, np.int32)
        for _ in range(int(r.randint(0, 5))):
            local[r.randint(nb)] = r.randint(1, 9)
        ded_counts, ded_nodes = _top_k_ties_by_index(torch.from_numpy(local)[None], k)
        mega = np.zeros(96, np.int32)
        mega[offset:offset + nb] = local
        mega_counts, mega_nodes = _top_k_ties_by_index(torch.from_numpy(mega)[None], k)
        got = repack_assignment_span(mega_nodes[0].numpy(), mega_counts[0].numpy(),
                                     offset, nb, k)
        want = jrepack(mega_nodes[0].numpy(), mega_counts[0].numpy(), offset, nb, k)
        for a, b, c in zip(got, want, (ded_nodes[0].numpy(), ded_counts[0].numpy())):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_build_mega_batch_matches_reference():
    from batch_scheduler_tpu.service.coalescer import build_mega_batch as jbuild
    from batch_scheduler_tpu_torch.service.coalescer import build_mega_batch

    raws = [_raw(_request(1, n=16, g=4)), _raw(_request(2, n=40, g=7, per_group=True)),
            _raw(_request(3, n=8, g=3))]
    got, want = build_mega_batch(raws), jbuild(raws)
    assert got[2:] == want[2:] == ([0, 16, 56], [0, 4, 11])
    for part in (0, 1):
        assert len(got[part]) == len(want[part])
        for a, b in zip(got[part], want[part]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- coalesced wire bit identity --------------------------------------------

TENANTS = 3
ROUNDS = 3


def _tenant_frames(i, kind):
    """Tenant ``i``'s request script: its TENANT announcement, then ROUNDS
    schedule requests (full, or a keyframe and row deltas), each followed
    by two row fetches. Tenants differ in shape and mask mode."""
    n, g = 24 + 8 * i, 4 + i
    P, T = tproto, tproto.MsgType
    rounds = []
    for b in range(ROUNDS):
        req = _request(100 * i + b, n=n, g=g, per_group=(i % 2 == 0))
        if kind == "full":
            frame = (T.SCHEDULE_REQ, P.pack_schedule_request(req))
        elif b == 0:
            frame = (T.DELTA_SCHEDULE_REQ, P.pack_delta_keyframe(1, req))
            base = req
        else:
            # churn two node rows and one gang row of the keyframe's state
            node_idx = np.array([b, n - 1 - b], np.int32)
            group_idx = np.array([b % g], np.int32)
            rows = P.DeltaScheduleRequest(
                node_idx=node_idx, node_rows=(base.requested[node_idx] + b).astype(np.int32),
                group_idx=group_idx, group_rows=(base.group_req[group_idx] + 1).astype(np.int32),
                remaining=req.remaining, fit_mask=base.fit_mask,
                group_valid=req.group_valid, order=req.order, min_member=req.min_member,
                scheduled=req.scheduled, matched=req.matched, ineligible=req.ineligible,
                creation_rank=req.creation_rank, n=n, g=g, r=req.alloc.shape[1],
            )
            frame = (T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(b, b + 1, rows))
        rounds.append([frame] + [
            (T.ROW_REQ, P.pack_row_request(kind_, gidx, b + 1))
            for kind_, gidx in (("capacity", 0), ("scores", g - 1))
        ])
    return [(T.TENANT, P.pack_tenant(f"t{i}"))], rounds


def _gate_selection(coal, k):
    """Hold the coalescer's group selection until ``k`` jobs are pending,
    so each lockstep round of ``k`` tenants forms ONE group of width
    ``k``. Waits on queue state, never on a timing. Returns a function
    that lifts the gate."""
    real = coal._select_group_locked

    def select():  # lock-held: _cv
        if coal._pending < k:
            coal._cv.wait(0.01)  # releases the lock; the worker loops back
            return []
        return real()

    coal._select_group_locked = select
    return lambda: setattr(coal, "_select_group_locked", real)


def _run_script(srv, kind):
    """Every tenant's script on its own connection, all tenants at once,
    in lockstep rounds (a barrier between rounds): the answers per
    tenant."""
    barrier = threading.Barrier(TENANTS)
    answers = [None] * TENANTS
    errors = []

    def tenant(i):
        try:
            conn = _Exchange(srv)
            head, rounds = _tenant_frames(i, kind)
            out = [conn.send(*f) for f in head]
            for frames in rounds:
                barrier.wait(120)
                out += [conn.send(*f) for f in frames]
            conn.close()
            answers[i] = [a for a in out if a is not None]
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(TENANTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    return answers


@pytest.mark.parametrize("kind", ["full", "delta"])
@pytest.mark.parametrize("mode", ["span", "mega"])
def test_coalesced_wire_bit_identity(mode, kind):
    """K tenants' scripts through one coalescing port sidecar get the
    bytes of the port's dedicated sidecar and of the JAX package's
    coalescing sidecar: every SCHEDULE_RESP and every ROW_RESP."""
    coal_srv = _port_server(True)
    ded_srv = _port_server(False)
    ref_srv = _ref_coalescing_server()
    try:
        coal = coal_srv.coalescer
        coal.mode = mode
        ref_srv.coalescer.mode = mode
        _gate_selection(coal, TENANTS)
        got = _run_script(coal_srv, kind)
        dedicated = _run_script(ded_srv, kind)
        reference = _run_script(ref_srv, kind)
        T = tproto.MsgType
        for i in range(TENANTS):
            kinds = [t for t, _ in got[i]]
            assert kinds == [T.SCHEDULE_RESP, T.ROW_RESP, T.ROW_RESP] * ROUNDS, got[i][:3]
            assert got[i] == dedicated[i], f"tenant {i}: coalesced != dedicated"
            assert got[i] == reference[i], f"tenant {i}: port != reference coalescer"
        stats = coal.stats()
        assert stats["groups_run"] == ROUNDS and stats["mega_failures"] == 0
        assert stats["mega_groups"] == (ROUNDS if mode == "mega" else 0)
    finally:
        for srv in (coal_srv, ded_srv, ref_srv):
            _close(srv)


def test_mega_demux_identity_direct():
    """One forced block-diagonal mega group: every field of every tenant's
    demuxed result equals its own dedicated batch (mixed shapes and mask
    modes), and its row views read the tenant's own capacity rows."""
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.service.coalescer import OracleCoalescer
    from batch_scheduler_tpu_torch.service.server import DeviceExecutor

    executor = DeviceExecutor("cpu")
    coal = OracleCoalescer(executor, mode="mega", mega_cells=1 << 30)
    try:
        jobs = [_job("alpha", _request(1, n=16, g=4)),
                _job("beta", _request(2, n=40, g=7, per_group=True)),
                _job("gamma", _request(3, n=8, g=3))]
        coal._run_mega(jobs)
        for job in jobs:
            res = job.wait(timeout=60)
            want, want_dev = execute_batch_host(job.padded_args, job.progress_args,
                                                device="cpu")
            g = job.g
            for key in ("gang_feasible", "placed", "progress",
                        "assignment_nodes", "assignment_counts"):
                np.testing.assert_array_equal(np.asarray(res.host[key]),
                                              np.asarray(want[key])[:g], err_msg=key)
            assert int(res.host["best"]) == int(want["best"])
            assert bool(res.host["best_exists"]) == bool(want["best_exists"])
            assert res.host["telemetry"]["coalesce"]["mode"] == "mega"
            for gidx in (0, g - 1):
                np.testing.assert_array_equal(
                    res.rows.gather("capacity", gidx),
                    want_dev["capacity"][gidx][:job.n].numpy())
    finally:
        coal.stop()
        executor.stop()


# -- DRF order --------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_drf_order_reads_served_share_and_observatory_weights(pkg):
    """``_tenant_order_locked`` with fixed served shares and observatory
    weights: lowest share first, FIFO aging on ties; both packages give
    the same order."""
    cmod = _pkg(pkg, "service.coalescer")

    class _Idle:
        pass

    coal = cmod.OracleCoalescer(
        _Idle(), weights_fn=lambda: {"hog": 0.9, "lean": 0.0, "mid": 0.25})
    coal.stop()
    req = _request(5)
    args, progress = _padded(pkg, req)

    def job(tenant, enqueued):
        j = cmod.CoalesceJob(tenant=tenant, n=32, g=8, r=4, padded_args=args,
                             progress_args=progress, raw_fn=lambda: _raw(req))
        j.enqueued = enqueued
        return j

    with coal._cv:
        coal._stopped = False
        for tenant, enq in (("hog", 1.0), ("lean", 5.0), ("mid", 2.0),
                            ("whale", 3.0), ("fresh", 4.0), ("fifo", 0.5)):
            coal._queues.setdefault(tenant, cmod.deque()).append(job(tenant, enq))
            coal._pending += 1
        # served work: the whale has had 3/4 of it, mid 1/4
        coal._served = {"whale": 300.0, "mid": 100.0}
        coal._served_at = time.monotonic()
        order = coal._tenant_order_locked()
    # shares: fifo 0 (t=0.5), fresh 0 (t=4), lean 0 (t=5), mid .25+.25,
    # whale .75, hog .9
    assert order == ["fifo", "fresh", "lean", "mid", "whale", "hog"], order
    with coal._cv:
        group = coal._select_group_locked()
    assert [j.tenant for j in group] == order


# -- admission control: BUSY -------------------------------------------------


def test_busy_when_saturated_over_wire_and_resilient_retry(monkeypatch):
    """``BST_COALESCE_DEPTH=2`` with the executor parked: the queue fills
    deterministically; a full request and a wire delta are both answered
    BUSY (the delta's mirror generation unchanged: the same delta
    succeeds once the queue drains), and the resilient client waits out
    the hint and succeeds with its breaker closed."""
    from batch_scheduler_tpu_torch.service import client as tclient
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    monkeypatch.setenv("BST_COALESCE_DEPTH", "2")
    monkeypatch.setenv("BST_COALESCE_MODE", "span")
    srv = _port_server(True)
    coal = srv.coalescer
    T, P = tproto.MsgType, tproto
    req = _request(5)
    try:
        assert coal.depth == 2
        # a delta connection with a mirror, before the park
        delta = _Exchange(srv)
        assert delta.send(T.DELTA_SCHEDULE_REQ, P.pack_delta_keyframe(1, req))[0] \
            == T.SCHEDULE_RESP
        rows = P.DeltaScheduleRequest(
            node_idx=np.array([3], np.int32), node_rows=req.requested[[3]] + 1,
            group_idx=np.zeros(0, np.int32), group_rows=np.zeros((0, 4), np.int32),
            remaining=req.remaining, fit_mask=req.fit_mask, group_valid=req.group_valid,
            order=req.order, min_member=req.min_member, scheduled=req.scheduled,
            matched=req.matched, ineligible=req.ineligible,
            creation_rank=req.creation_rank, n=32, g=8, r=4)
        # park the executor, then fill the queue: one job taken by the
        # worker (waiting on the executor), two pending
        gate, parked = threading.Event(), threading.Event()

        def park():
            parked.set()
            gate.wait(120)

        threading.Thread(target=srv.executor.run, args=(park,), daemon=True).start()
        assert parked.wait(60)
        answers = []

        def fill():
            c = _Exchange(srv)
            answers.append(c.send(T.SCHEDULE_REQ, P.pack_schedule_request(req)))
            c.close()

        fillers = [threading.Thread(target=fill) for _ in range(3)]
        fillers[0].start()
        deadline = time.monotonic() + 60
        while srv.executor._q.qsize() < 1:  # the worker's job reached the executor
            assert time.monotonic() < deadline
            time.sleep(0.001)
        for t in fillers[1:]:
            t.start()
        while coal.stats()["pending"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        busy = _Exchange(srv)
        t_full, b_full = busy.send(T.SCHEDULE_REQ, P.pack_schedule_request(req))
        t_delta, b_delta = delta.send(T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(1, 2, rows))
        assert (t_full, t_delta) == (T.BUSY, T.BUSY)
        for body in (b_full, b_delta):
            ms, msg = P.unpack_busy(body)
            assert 25 <= ms <= 5000 and "saturated" in msg
        # the resilient client: its hint-sleep opens the gate and waits
        # for the queue to drain, so its retry finds room
        busy_answers = DEFAULT_REGISTRY.counter("bst_oracle_busy_total")
        busy_before = sum(busy_answers.values().values())

        def drained_sleep(seconds):
            gate.set()
            for t in fillers:
                t.join(60)
            while coal.stats()["pending"]:
                time.sleep(0.001)

        fake_time = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                             if not k.startswith("_")})
        fake_time.sleep = drained_sleep
        monkeypatch.setattr(tclient, "time", fake_time)
        rc = tclient.ResilientOracleClient(*srv.address, timeout=60)
        resp = rc.schedule(req, tenant="retrier")
        monkeypatch.undo()
        assert resp.gang_feasible.shape[0] == 8
        assert rc.breaker.state == "closed"
        rc.close()
        assert len(answers) == 3 and all(t == T.SCHEDULE_RESP for t, _ in answers)
        assert sum(busy_answers.values().values()) == busy_before + 1
        # the refused delta left the mirror at generation 1: it now applies
        t, _ = delta.send(T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(1, 2, rows))
        assert t == T.SCHEDULE_RESP
        assert coal._busy.value() >= 2
        busy.close()
        delta.close()
    finally:
        _close(srv)


# -- chaos, attribution, knobs ----------------------------------------------


def test_disconnect_mid_merge_drops_only_that_span():
    """Two tenants merged into one mega group; one hangs up before its
    answer. The other's answer equals its dedicated run, and the server
    keeps serving."""
    srv = _port_server(True)
    ded = _port_server(False)
    T, P = tproto.MsgType, tproto
    try:
        srv.coalescer.mode = "mega"
        lift = _gate_selection(srv.coalescer, 2)
        dead = _Exchange(srv)
        dead.send(T.TENANT, P.pack_tenant("vanisher"))
        tproto.write_frame(dead.sock, T.SCHEDULE_REQ,
                           P.pack_schedule_request(_request(11)))
        dead.close()
        live = _Exchange(srv)
        live.send(T.TENANT, P.pack_tenant("survivor"))
        got = live.send(T.SCHEDULE_REQ, P.pack_schedule_request(_request(12)))
        other = _Exchange(ded)
        want = other.send(T.SCHEDULE_REQ, P.pack_schedule_request(_request(12)))
        other.close()
        assert got == want
        assert srv.coalescer.stats()["mega_groups"] == 1
        lift()
        again = live.send(T.SCHEDULE_REQ, P.pack_schedule_request(_request(13)))
        assert again[0] == T.SCHEDULE_RESP
        assert P.unpack_schedule_response(again[1]).batch_seq == 2
        live.close()
    finally:
        _close(srv)
        _close(ded)


def test_tenant_annotation_attributes_scan_counter():
    from batch_scheduler_tpu_torch.service import OracleClient
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    srv = _port_server(True)
    try:
        counter = DEFAULT_REGISTRY.counter("bst_scan_batches_total")
        before = counter.value(path="serial", tenant="acme")
        anonymous = counter.value(path="serial", tenant="-")
        c = OracleClient(*srv.address)
        c.schedule(_request(21), tenant="acme")
        c.close()
        # the executor collects (and counts) before the answer is sent
        assert counter.value(path="serial", tenant="acme") == before + 1
        c = OracleClient(*srv.address)
        c.schedule(_request(22))
        c.close()
        assert counter.value(path="serial", tenant="-") == anonymous + 1
    finally:
        _close(srv)


def test_knob_parse_guards(monkeypatch):
    from batch_scheduler_tpu_torch.service.coalescer import (
        coalesce_depth, coalesce_enabled, coalesce_fair_halflife, coalesce_mega_cells,
        coalesce_mode, coalesce_span_max)

    monkeypatch.setenv("BST_COALESCE", "bananas")
    assert coalesce_enabled() is False
    monkeypatch.setenv("BST_COALESCE", "1")
    assert coalesce_enabled() is True
    monkeypatch.setenv("BST_COALESCE_DEPTH", "not-an-int")
    assert coalesce_depth() == 64
    monkeypatch.setenv("BST_COALESCE_SPAN_MAX", "9999")
    assert coalesce_span_max() == 64  # clamped
    monkeypatch.setenv("BST_COALESCE_MODE", "warp")
    assert coalesce_mode() == "auto"
    monkeypatch.setenv("BST_COALESCE_MEGA_CELLS", "12")
    assert coalesce_mega_cells() == 1 << 10
    monkeypatch.setenv("BST_COALESCE_FAIR_HALFLIFE_S", "soon")
    assert coalesce_fair_halflife() == 10.0
    # a server with the knob on builds a coalescer; coalesce= overrides
    srv = _port_server(None)
    try:
        assert srv.coalescer is not None
    finally:
        _close(srv)
    srv = _port_server(False)
    try:
        assert srv.coalescer is None
    finally:
        _close(srv)


@pytest.mark.cuda
def test_cuda_coalescing_server_answers_equal_cpu():
    """On the card: the coalescing server on cuda (both lowerings, full
    and delta scripts) answers with the bytes of the CPU dedicated
    server, every batch one launch of the serial kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda
    from batch_scheduler_tpu_torch.service import serve_background

    for mode in ("span", "mega"):
        for kind in ("full", "delta"):
            srv = serve_background(device="cuda", coalesce=True)
            ded = _port_server(False)
            try:
                srv.coalescer.mode = mode
                _gate_selection(srv.coalescer, TENANTS)
                before = assign_gangs_cuda.launches
                got = _run_script(srv, kind)
                want = _run_script(ded, kind)
                assert got == want, (mode, kind)
                stats = srv.coalescer.stats()
                launches = assign_gangs_cuda.launches - before
                assert stats["mega_failures"] == 0
                if mode == "span":
                    assert launches == TENANTS * ROUNDS
                else:
                    assert stats["mega_groups"] == ROUNDS and launches == ROUNDS
            finally:
                _close(srv)
                _close(ded)
