"""The port's bucket warmer (``ops/bucketing.py``: ``adjacent_bucket_shapes``,
``CompileWarmer``, ``maybe_compile_warmer``) against the JAX package's, on
the CPU: ``tests/test_pipeline.py``'s warmer case mirrored (the adjacent
shapes over a grid of buckets; real batches: two adjacent shapes warmed, the
transition batch not ``compiled`` and a hit, steady batches not further
hits), the hit / miss / warm accounting of both packages' warmers on the
same sequence of served batches with a fake batch runner, warmth
replication to a standby, the sidecar's warmer (``serve_background(
compile_warmer=True)``, ``warmth_snapshot`` / ``replicate_warmth``) and the
scorer's. Exact equality throughout (shapes, counters, plans)."""

import importlib
import threading
import time

import numpy as np
import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


def _wait(predicate, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


@pytest.mark.parametrize("g_bucket", [8, 16, 64, 1024])
def test_adjacent_bucket_shapes_equal_reference(g_bucket):
    ref = _m(PACKAGES[0], "ops.bucketing").adjacent_bucket_shapes
    port = _m(PACKAGES[1], "ops.bucketing").adjacent_bucket_shapes
    for n_bucket in (8, 16, 512, 8192, 16384, 2**21):
        assert port(g_bucket, n_bucket) == ref(g_bucket, n_bucket)
    assert port(16, 32) == [(8, 32), (32, 32), (16, 16), (16, 64)]
    assert port(8, 8) == [(16, 8), (8, 16)]


def _args_for(pkg, g, n, r=2):
    return _m(pkg, "ops.bucketing").pad_oracle_batch(
        alloc=np.full((n, r), 32, np.int32),
        requested=np.zeros((n, r), np.int32),
        group_req=np.ones((g, r), np.int32),
        remaining=np.full(g, 2, np.int32),
        fit_mask=np.ones((1, n), bool),
        group_valid=np.ones(g, bool),
        order=np.arange(g, dtype=np.int32),
        min_member=np.full(g, 2, np.int32),
        scheduled=np.zeros(g, np.int32),
        matched=np.zeros(g, np.int32),
        ineligible=np.zeros(g, bool),
        creation_rank=np.arange(g, dtype=np.int32),
    )


def test_compile_warmer_precompiles_adjacent_shapes():
    """test_pipeline.py's case on the port's batch path: the warmer runs
    the two adjacent shapes of the served one, the transition
    batch finds its shape warm (not ``compiled``, a hit) and queues its own
    new adjacents, and a steady batch there is no further hit. The plans
    equal the JAX package's."""
    bucketing = _m(PACKAGES[1], "ops.bucketing")
    oracle = _m(PACKAGES[1], "ops.oracle")
    reg = _m(PACKAGES[1], "utils.metrics").Registry()
    warmer = bucketing.CompileWarmer(device="cpu", registry=reg)
    try:
        base = _args_for(PACKAGES[1], 8, 8, r=3)
        host, _ = oracle.execute_batch_host(*base, device="cpu")
        cold = int(host["telemetry"]["compiled"])
        warmer.note_batch(base[0], base[1], host["telemetry"])
        assert _wait(lambda: len(warmer.warmed_shapes()) == 2)
        assert warmer.warmed_shapes() == {(16, 8, 3, False, 0), (8, 16, 3, False, 0)}
        trans = _args_for(PACKAGES[1], 16, 8, r=3)
        host, _ = oracle.execute_batch_host(*trans, device="cpu")
        assert host["telemetry"]["compiled"] is False
        warmer.note_batch(trans[0], trans[1], host["telemetry"])
        assert warmer.stats()["warmer_hits"] == 1
        host2, _ = oracle.execute_batch_host(*trans, device="cpu")
        warmer.note_batch(trans[0], trans[1], host2["telemetry"])
        # the transition queued the new shape's adjacents (its other
        # neighbour, 8x8, was served): the worker warms them in turn
        assert _wait(lambda: len(warmer.warmed_shapes()) == 4)
        assert warmer.warmed_shapes() == {(16, 8, 3, False, 0), (8, 16, 3, False, 0),
                                          (32, 8, 3, False, 0), (16, 16, 3, False, 0)}
        # the base batch is a miss when it was this process's first there
        assert warmer.stats() == {"warmer_hits": 1, "warmer_misses": cold,
                                  "warmer_shapes": 4}
        ref_oracle = _m(PACKAGES[0], "ops.oracle")
        ref_host, _ = ref_oracle.collect_batch(ref_oracle.dispatch_batch(
            *_args_for(PACKAGES[0], 16, 8, r=3)))
        for k in ("placed", "gang_feasible", "progress", "assignment_nodes",
                  "assignment_counts"):
            assert np.array_equal(np.asarray(host[k]), np.asarray(ref_host[k])), k
    finally:
        assert warmer.stop()


def test_first_batch_at_a_key_is_compiled():
    """The telemetry flag the warmer reads: True for this process's first
    batch at a shape key, False after; a different lane count, mask mode
    or wave width is a different key."""
    oracle = _m(PACKAGES[1], "ops.oracle")
    args = _args_for(PACKAGES[1], 8, 8, r=13)
    flags = [oracle.execute_batch_host(*args, device="cpu")[0]["telemetry"]["compiled"]
             for _ in range(2)]
    with oracle.forced_scan_rung(8):
        flags += [oracle.execute_batch_host(*args, device="cpu")[0]["telemetry"]["compiled"]
                  for _ in range(2)]
    assert flags == [True, False, True, False]


def _fake_sequence(pkg, monkeypatch):
    """One sequence of served batches through ``pkg``'s warmer, its batch
    runner replaced by a recorder: returns the counters and warmed shapes
    after each step and the shapes the runner was asked for."""
    bucketing = _m(pkg, "ops.bucketing")
    reg = _m(pkg, "utils.metrics").Registry()
    ran = []
    gate = threading.Event()

    def record(vbatch, *rest, **kw):
        ran.append((int(vbatch[2].shape[0]), int(vbatch[0].shape[0])))
        gate.wait(30)
        return None

    if pkg.endswith("_torch"):
        monkeypatch.setattr(bucketing.CompileWarmer, "_warm_one",
                            lambda self, vb, vp, wave, topk: record(vb))
        warmer = bucketing.CompileWarmer(device="cpu", registry=reg)
    else:
        oracle = _m(pkg, "ops.oracle")
        monkeypatch.setattr(oracle, "dispatch_batch", record)
        monkeypatch.setattr(oracle, "collect_batch", lambda pending: None)
        warmer = bucketing.CompileWarmer(registry=reg)
    steps = []

    def idle():
        # nothing queued, and every warm the runner began has landed
        return warmer._q.empty() and len(ran) == len(warmer.warmed_shapes())

    try:
        # (G, N, telemetry of the served batch); the gate holds the worker
        # until the first shape's adjacents are queued
        sequence = [(8, 16, {"compiled": True}), (8, 16, {}), (16, 16, {}),
                    (8, 16, {}), (16, 32, {"compiled": True}), (16, 32, {}),
                    (8, 8, {"wave_width": 8, "compiled": True})]
        for i, (g, n, tel) in enumerate(sequence):
            args = _args_for(pkg, g, n)
            warmer.note_batch(args[0], args[1], tel)
            if i == 0:
                gate.set()
                assert _wait(lambda: len(warmer.warmed_shapes()) == 3)
            # the worker settles before the next served batch: whether it
            # warms a shape before or after that batch is noted decides
            # whether the shape is warmed at all
            assert _wait(idle, 30)
            time.sleep(0.05)
            assert _wait(idle, 30)
            stats = warmer.stats()
            steps.append({k: stats[k] for k in ("warmer_hits", "warmer_misses")})
        return steps, sorted(warmer.warmed_shapes()), sorted(ran), len(warmer.warmth_snapshot())
    finally:
        gate.set()
        assert warmer.stop()


def test_hits_misses_and_warms_equal_reference(monkeypatch):
    ref_steps, ref_shapes, ref_ran, ref_protos = _fake_sequence(PACKAGES[0], monkeypatch)
    port = _fake_sequence(PACKAGES[1], monkeypatch)
    # the reference's key ends in its donate flag, always False here; the
    # port donates nothing and its key stops before it
    assert all(k[-1] is False for k in ref_shapes)
    assert port == (ref_steps, [k[:-1] for k in ref_shapes], ref_ran, ref_protos)
    steps = port[0]
    assert steps[0]["warmer_misses"] == 1 and steps[2]["warmer_hits"] == 1
    assert steps[-1]["warmer_misses"] == 3


def test_warmth_replicates_to_a_standby():
    """A primary's observed shapes replicated to a standby's warmer: the
    standby warms each prototype's own shape and its adjacents, and its
    first batch at the replicated shape is a hit, not a cold batch."""
    bucketing = _m(PACKAGES[1], "ops.bucketing")
    oracle = _m(PACKAGES[1], "ops.oracle")
    registry = _m(PACKAGES[1], "utils.metrics").Registry
    primary = bucketing.CompileWarmer(device="cpu", registry=registry())
    standby = bucketing.CompileWarmer(device="cpu", registry=registry())
    try:
        args = _args_for(PACKAGES[1], 8, 8, r=4)
        host, _ = oracle.execute_batch_host(*args, device="cpu")
        primary.note_batch(args[0], args[1], host["telemetry"])
        protos = primary.warmth_snapshot()
        assert len(protos) == 1
        assert standby.replicate(protos) == 1
        assert _wait(lambda: len(standby.warmed_shapes()) >= 1)
        assert (8, 8, 4, False, 0) in standby.warmed_shapes()
        host, _ = oracle.execute_batch_host(*args, device="cpu")
        assert host["telemetry"]["compiled"] is False
        standby.note_batch(args[0], args[1], host["telemetry"])
        assert standby.stats()["warmer_hits"] == 1
    finally:
        assert primary.stop() and standby.stop()


def test_maybe_compile_warmer_single_device_rule(capsys):
    bucketing = _m(PACKAGES[1], "ops.bucketing")
    warmer = bucketing.maybe_compile_warmer("cpu")
    assert isinstance(warmer, bucketing.CompileWarmer)
    assert warmer.stop()
    assert bucketing.maybe_compile_warmer("cpu", scan_mesh=object()) is None
    assert "compile warmer skipped" in capsys.readouterr().err


def test_sidecar_warmer_snapshot_and_replication():
    """``serve_background(device="cpu", compile_warmer=True)``: served
    batches feed the warmer, its counters ride back in the traced
    telemetry, ``warmth_snapshot`` hands the shapes to a second sidecar's
    ``replicate_warmth``, and that standby answers the same plan."""
    service = _m(PACKAGES[1], "service")
    proto = service.protocol
    trace = _m(PACKAGES[1], "utils.trace")

    def request():
        n, g, r = 6, 3, 5
        alloc = np.zeros((n, r), np.int32)
        alloc[:, 0] = 8000
        alloc[:, 3] = 20
        req = np.zeros((g, r), np.int32)
        req[:, 0] = 1000
        req[:, 3] = 1
        return proto.ScheduleRequest(
            alloc=alloc, requested=np.zeros((n, r), np.int32), group_req=req,
            remaining=np.full(g, 2, np.int32), fit_mask=np.ones((g, n), bool),
            group_valid=np.ones(g, bool), order=np.arange(g, dtype=np.int32),
            min_member=np.full(g, 2, np.int32), scheduled=np.zeros(g, np.int32),
            matched=np.zeros(g, np.int32), ineligible=np.zeros(g, bool),
            creation_rank=np.arange(g, dtype=np.int32))

    primary = service.serve_background(device="cpu", compile_warmer=True)
    standby = service.serve_background(device="cpu", compile_warmer=True)
    off = service.serve_background(device="cpu")
    try:
        assert off.warmer is None and off.warmth_snapshot() == []
        assert off.replicate_warmth([object()]) == 0
        client = service.OracleClient(*primary.address)
        client._round_trip(proto.MsgType.SCHEDULE_REQ,
                           proto.pack_schedule_request(request()),
                           trace_ctx=(trace.new_trace_id(), ""))
        assert {"warmer_hits", "warmer_misses", "warmer_shapes"} <= set(
            client.last_telemetry)
        want = client.schedule(request())
        client.close()
        protos = primary.warmth_snapshot()
        assert len(protos) == 1
        assert standby.replicate_warmth(protos) == 1
        assert _wait(lambda: len(standby.warmer.warmed_shapes()) >= 1)
        sclient = service.OracleClient(*standby.address)
        got = sclient.schedule(request())
        sclient.close()
        for k in ("placed", "gang_feasible", "progress", "assignment_nodes",
                  "assignment_counts"):
            assert np.array_equal(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)))
        assert standby.warmer.stats()["warmer_hits"] == 1
    finally:
        for srv in (primary, standby, off):
            srv.shutdown()
            srv.server_close()
        assert primary.warmer._thread.is_alive() is False
