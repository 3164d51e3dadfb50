"""The churn re-scorer (``batch_scheduler_tpu_torch/ops/rescore.py``) on the
CPU against the JAX package's (``batch_scheduler_tpu/ops/rescore.py``),
tick by tick: the same seeded nodes (a GPU lane, a few node shapes) and
gangs go through both, and every host dict, the occupancy mirror, the
running set and the summary's shape counters must be equal (integers and
booleans: tolerance zero). Covers every behaviour tests/test_rescore.py
covers, plus the in-place scatter's duplicate rows."""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from batch_scheduler_tpu.ops import rescore as jax_rescore
from batch_scheduler_tpu.ops.snapshot import GroupDemand as JaxDemand
from batch_scheduler_tpu.sim.scenarios import make_sim_node as jax_node
from batch_scheduler_tpu_torch.ops import rescore as port_rescore
from batch_scheduler_tpu_torch.ops.snapshot import GroupDemand as PortDemand
from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node as port_node

GPU = "nvidia.com/gpu"
HOST_KEYS = ("placed", "gang_feasible", "progress", "best", "best_exists",
             "assignment_nodes", "assignment_counts")
SUMMARY_KEYS = ("ticks", "bucket_shapes", "recompiles", "reupload_fallbacks")
SHAPES = (
    {"cpu": "8", "memory": "32Gi", "pods": "110", GPU: "4"},
    {"cpu": "16", "memory": "64Gi", "pods": "110"},
    {"cpu": "4", "memory": "16Gi", "pods": "32", GPU: "1"},
)


def _specs(n, seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [(f"n{i:03d}", shapes[int(k)]) for i, k in enumerate(rng.integers(0, len(shapes), n))]


def _uniform_specs(n, cpu="8"):
    return [(f"n{i:03d}", {"cpu": cpu, "memory": "32Gi", "pods": "110"}) for i in range(n)]


def _gang(name, members, cpu_milli=1000, ts=0.0, gpu=0, **extra):
    """(name, kwargs) of one gang, built in either package by ``_demands``."""
    req = {"cpu": cpu_milli}
    if gpu:
        req[GPU] = gpu
    return dict(full_name=f"default/{name}", min_member=members, member_request=req,
                creation_ts=ts, has_pod=True, **extra)


def _demands(kind, gangs):
    cls = JaxDemand if kind == "jax" else PortDemand
    return [cls(**{**g, "member_request": dict(g["member_request"])}) for g in gangs]


def _seeded_gangs(count, seed, prefix="g"):
    rng = np.random.default_rng(seed)
    return [_gang(f"{prefix}{i}", int(rng.integers(1, 6)), int(rng.integers(1, 5)) * 500,
                  ts=float(i), gpu=int(rng.integers(0, 2)), priority=int(rng.integers(0, 2)))
            for i in range(count)]


class Pair:
    """One ChurnRescorer of each package on the same nodes, driven in
    lockstep; every tick's results are compared as they come."""

    def __init__(self, specs, **kwargs):
        self.jax = jax_rescore.ChurnRescorer([jax_node(n, s) for n, s in specs], **kwargs)
        self.port = port_rescore.ChurnRescorer([port_node(n, s) for n, s in specs],
                                               device="cpu", **kwargs)
        self.num_nodes = len(specs)

    def both(self):
        return (("jax", self.jax), ("port", self.port))

    def tick(self, node_requested, gangs):
        outs = [r.tick(node_requested, _demands(kind, gangs)) for kind, r in self.both()]
        assert_same_tick(*outs)
        return outs

    def admit(self, outs, name, verified=False):
        got = []
        for (_, r), out in zip(self.both(), outs):
            got.append(r.admit_verified(out, name) if verified else r.admit(out, name))
        assert got[0] == got[1], (name, got)
        self.assert_same_state()
        return got[0]

    def release(self, name):
        for _, r in self.both():
            r.release(name)
        self.assert_same_state()

    def assert_same_state(self):
        np.testing.assert_array_equal(self.port.requested_lanes, self.jax.requested_lanes)
        assert self.port.running == self.jax.running
        js, ps = self.jax.summary(), self.port.summary()
        assert {k: ps[k] for k in SUMMARY_KEYS} == {k: js[k] for k in SUMMARY_KEYS}

    def assert_resident_matches_mirror(self):
        """The port's resident occupancy equals the padded mirror (right
        after a dispatch drained every queued delta)."""
        with self.port._state_lock:
            dev = self.port._req_dev.numpy().copy()
            mirror = self.port.requested_lanes.copy()
        padded = np.zeros_like(dev)
        padded[:len(mirror)] = mirror
        np.testing.assert_array_equal(dev, padded)


def assert_same_tick(a, b):
    for k in HOST_KEYS:
        np.testing.assert_array_equal(np.asarray(b.host[k]), np.asarray(a.host[k]), err_msg=k)
    assert b.placed_groups() == a.placed_groups()
    assert tuple(b.bucket_shape) == tuple(a.bucket_shape)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_rescore.ChurnRescorer([port_node("n0", SHAPES[0])])


def test_steady_bucket_matches_reference():
    """Group counts varying inside one bucket keep one padded shape."""
    pair = Pair(_specs(12), extra_resources=[GPU])  # node bucket 16
    for t, g in enumerate([3, 5, 8, 6, 4, 7, 2, 8]):  # all <= bucket 8
        pair.tick({}, _seeded_gangs(g, t, prefix=f"t{t}-"))
    pair.assert_same_state()
    assert pair.port.recompiles == 1 and len(pair.port._shapes_seen) == 1


def test_boundary_crossing_matches_reference():
    pair = Pair(_specs(4))
    pair.tick({}, [_gang("a", 2)])  # 1 group -> bucket 8
    pair.tick({}, [_gang(f"g{i}", 2, ts=float(i)) for i in range(9)])  # -> 16
    pair.assert_same_state()
    assert pair.port.recompiles == 2


def test_pinned_schema_matches_reference():
    """A declared extended resource keeps R when it appears; an undeclared
    one raises in both packages."""
    pair = Pair(_uniform_specs(4), extra_resources=[GPU])
    (_, t1), (_, t2) = pair.tick({}, [_gang("plain", 2)]), pair.tick({}, [_gang("gpu", 2, gpu=1)])
    assert t1.bucket_shape == t2.bucket_shape and pair.port.recompiles == 1
    bad = _gang("bad", 2)
    bad["member_request"]["vendor.example/fpga"] = 1
    for kind, r in pair.both():
        with pytest.raises(KeyError):
            r.tick({}, _demands(kind, [bad]))


def test_backfill_after_release_matches_reference():
    """A gang denied for capacity places once the occupancy frees."""
    specs = _uniform_specs(4, cpu="4")  # 16 cpus
    pair = Pair(specs)
    requested = {name: {"cpu": 3000, "pods": 3} for name, _ in specs}
    waiting = _gang("waiting", 10, ts=1.0)
    (_, out) = pair.tick(requested, [waiting])
    assert "default/waiting" not in out.placed_groups()
    (_, out2) = pair.tick({}, [waiting])
    assert out2.placed_groups() == ["default/waiting"]
    assert pair.port.recompiles == 1


def test_guards_match_reference():
    """Snapshots do not alias the occupancy mirror; a node override needs a
    dict; a double admit raises; an oversubscribing admit rolls back."""
    specs = _uniform_specs(8, cpu="4")
    pair = Pair(specs)
    outs = pair.tick(None, [_gang("g", 4)])
    before = outs[1].snapshot.requested.copy()
    pair.admit(outs, "default/g")
    assert (outs[1].snapshot.requested == before).all()
    assert pair.port.requested_lanes.sum() > 0
    for _, r in pair.both():
        with pytest.raises(ValueError, match="already admitted"):
            r.admit(outs[0] if r is pair.jax else outs[1], "default/g")
    pair.release("default/g")
    assert pair.port.requested_lanes.sum() == 0
    for kind, r in pair.both():
        node = jax_node if kind == "jax" else port_node
        with pytest.raises(ValueError, match="node_requested"):
            r.tick(None, _demands(kind, [_gang("g", 4)]),
                   nodes=[node(n, s) for n, s in specs[:6]])
    # two plans of 20 cpus against the same empty cluster: the second
    # admit would oversubscribe and must leave no charge behind
    outs = pair.tick(None, [_gang("x", 20, ts=0.0)])
    outs2 = pair.tick(None, [_gang("y", 20, ts=1.0)])
    pair.admit(outs, "default/x")
    mirror = pair.port.requested_lanes.copy()
    for (_, r), out in zip(pair.both(), outs2):
        with pytest.raises(RuntimeError, match="oversubscribes"):
            r.admit(out, "default/y")
    pair.assert_same_state()
    np.testing.assert_array_equal(pair.port.requested_lanes, mirror)


def test_summary_matches_reference():
    pair = Pair(_specs(4))
    for i in range(5):
        pair.tick({}, [_gang(f"g{i}", 2)])
    js, ps = pair.jax.summary(), pair.port.summary()
    assert set(ps) == set(js)
    assert ps["ticks"] == 5 and ps["p50_s"] > 0 and ps["p95_s"] >= ps["p50_s"]
    assert ps["p50_collect_s"] >= 0 and ps["p50_dispatch_s"] >= 0


def _drive_pipelined(kind, pipelined):
    """tests/test_rescore.py's one-tick-deep loop: the admits in order."""
    mod, node = (jax_rescore, jax_node) if kind == "jax" else (port_rescore, port_node)
    kwargs = {} if kind == "jax" else {"device": "cpu"}
    r = mod.ChurnRescorer([node(n, s) for n, s in _uniform_specs(4, cpu="4")], **kwargs)
    mk = lambda gangs: _demands(kind, gangs)  # noqa: E731
    out = r.tick(None, mk([_gang("filler", 12)]))
    r.admit(out, "default/filler")
    admitted = []
    pending = [_gang("w1", 10, ts=1.0), _gang("w2", 2, ts=2.0)]
    inflight = list(pending)
    pend = r.tick_dispatch(None, mk(inflight)) if pipelined else None
    for _ in range(3):
        if pipelined:
            out = r.tick_collect(pend)
        else:
            inflight = list(pending)
            out = r.tick(None, mk(inflight))
        placed = set(out.placed_groups())
        for g in inflight:
            if g["full_name"] in placed:
                r.admit(out, g["full_name"])
                admitted.append(g["full_name"])
        pending = [g for g in pending if g["full_name"] not in placed]
        if "default/filler" in r.running:
            r.release("default/filler")
        if pipelined:
            inflight = list(pending)
            pend = r.tick_dispatch(None, mk(inflight))
    if pipelined:
        r.tick_collect(pend)
    return admitted


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_one_tick_pipeline_matches_reference(pipelined):
    got = _drive_pipelined("port", pipelined)
    assert got == _drive_pipelined("jax", pipelined)
    assert set(got) == {"default/w1", "default/w2"}


def test_pipelined_stats_recorded_per_collect():
    r = port_rescore.ChurnRescorer([port_node(n, s) for n, s in _specs(4)], device="cpu")
    pend = r.tick_dispatch(None, _demands("port", [_gang("a", 2)]))
    assert r.latencies == []  # dispatch alone records nothing
    r.tick_collect(pend)
    assert len(r.latencies) == len(r.dispatch_times) == len(r.collect_times) == 1


@pytest.mark.parametrize("force_reupload", [False, True], ids=["resident", "reupload"])
def test_resident_occupancy_matches_reupload(force_reupload):
    """Admits, releases and arrivals through the in-place delta scatter
    equal a re-upload of the mirror every tick, and both equal the JAX
    re-scorer tick by tick."""
    pair = Pair(_specs(6, seed=3), extra_resources=[GPU])
    pending = _seeded_gangs(6, 5)
    for t in range(6):
        if force_reupload:
            with pair.port._state_lock:
                pair.port._req_dev = None
                pair.port._req_deltas.clear()  # the mirror is ground truth
        outs = pair.tick(None, pending)
        if not force_reupload:
            pair.assert_resident_matches_mirror()
        placed = set(outs[1].placed_groups())
        for g in list(pending):
            if g["full_name"] in placed:
                pair.admit(outs, g["full_name"])
                pending.remove(g)
        if t == 2 and pair.port.running:
            pair.release(sorted(pair.port.running)[0])
            pending.append(_gang(f"h{t}", 2, ts=10.0 + t, gpu=1))
    pair.assert_same_state()


def test_scatter_adds_duplicate_rows():
    """A node named twice in one drain is added twice, as ``.at[].add``."""
    req = torch.zeros((8, 3), dtype=torch.int32)
    rows = np.array([2, 5, 2, 7, 2], np.int32)
    ups = np.arange(15, dtype=np.int32).reshape(5, 3) - 4
    port_rescore._scatter_add_rows(req, rows, ups)
    want = np.zeros((8, 3), np.int32)
    np.add.at(want, rows, ups)
    np.testing.assert_array_equal(req.numpy(), want)
    with pytest.raises(IndexError):
        port_rescore._scatter_add_rows(req, np.array([8], np.int32), ups[:1])


def test_one_drain_with_a_node_twice_matches_reference():
    """Two gangs admitted on the same node and one released from it, all in
    one drain: the resident occupancy sums the node's three deltas."""
    pair = Pair(_uniform_specs(4, cpu="8"))
    pair.tick(None, [_gang("seed", 1)])  # the resident copy exists
    outs = pair.tick(None, [_gang("a", 3, ts=0.0), _gang("b", 3, ts=1.0)])
    pair.admit(outs, "default/a")
    pair.admit(outs, "default/b")
    rows = np.concatenate([d[0] for d in pair.port._req_deltas])
    assert len(rows) > len(np.unique(rows)), "both gangs sit on one node"
    outs = pair.tick(None, [_gang("c", 2, ts=2.0)])
    pair.admit(outs, "default/c")
    pair.release("default/a")
    pair.tick(None, [_gang("d", 30, ts=3.0)])  # drains all four deltas at once
    pair.assert_resident_matches_mirror()
    pair.assert_same_state()


def test_drain_of_only_empty_deltas_matches_reference():
    """A gang placed with no member left to seat (remaining 0) admits and
    releases an empty delta; a drain made only of such deltas scatters
    nothing and scores as the reference."""
    pair = Pair(_uniform_specs(4))
    pair.tick(None, [_gang("seed", 1)])  # the resident copy exists
    outs = pair.tick(None, [_gang("done", 2, scheduled=2)])
    assert outs[1].placed_groups() == ["default/done"]
    pair.admit(outs, "default/done")
    assert pair.port._req_deltas and all(len(d[0]) == 0 for d in pair.port._req_deltas)
    pair.tick(None, [_gang("a", 1)])
    pair.assert_resident_matches_mirror()
    pair.release("default/done")
    pair.tick(None, [_gang("b", 1, ts=1.0)])
    pair.assert_resident_matches_mirror()
    pair.assert_same_state()
    assert pair.port.reupload_fallbacks == 0 and pair.port._req_deltas == []


def test_resync_after_failure_matches_reference():
    """A failed delta application drops the resident copy in both packages;
    the next tick re-uploads the mirror and scores as the reference."""
    pair = Pair(_uniform_specs(4, cpu="4"))
    outs = pair.tick(None, [_gang("a", 4)])
    pair.admit(outs, "default/a")
    for kind, r in pair.both():
        r._req_deltas.append(("not-an-array", "nope"))
        with pytest.raises(Exception):
            r.tick(None, _demands(kind, [_gang("b", 2, ts=1.0)]))
        assert r._req_dev is None and r._req_deltas == []
    (_, out) = pair.tick(None, [_gang("big", 16, ts=2.0), _gang("small", 2, ts=3.0)])
    assert "default/big" not in out.placed_groups()
    assert "default/small" in out.placed_groups()
    pair.assert_resident_matches_mirror()
    pair.assert_same_state()


def test_sticky_buckets_match_reference():
    sticky = Pair(_specs(4), sticky_buckets=True)
    plain = Pair(_specs(4))
    big = [_gang(f"b{i}", 1, ts=float(i)) for i in range(9)]  # bucket 16
    small = [_gang("s0", 2, ts=100.0)]  # bucket 8 unpinned
    for pair in (sticky, plain):
        for gangs in (big, small, big):
            pair.tick(None, gangs)
        pair.assert_same_state()
    assert plain.port.recompiles == 2 and sticky.port.recompiles == 1
    assert {s[0] for s in sticky.port._shapes_seen} == {16}
    (_, a), (_, b) = sticky.tick(None, small), plain.tick(None, small)
    assert a.placed_groups() == b.placed_groups()


def test_admit_verified_depth2_matches_reference():
    """Two dispatches in flight on the same occupancy: the stale overlapping
    placement is skipped with a clean rollback, a double offer commits
    once, and the skipped gang places on a fresh dispatch."""
    pair = Pair(_uniform_specs(4, cpu="4"))  # 16 cpus
    x, y = _gang("x", 10, ts=0.0), _gang("y", 10, ts=1.0)
    p1 = [r.tick_dispatch(None, _demands(k, [x])) for k, r in pair.both()]
    p2 = [r.tick_dispatch(None, _demands(k, [y])) for k, r in pair.both()]
    out1 = [r.tick_collect(p) for (_, r), p in zip(pair.both(), p1)]
    assert_same_tick(*out1)
    assert pair.admit(out1, "default/x", verified=True) is True
    assert pair.admit(out1, "default/x", verified=True) is False
    out2 = [r.tick_collect(p) for (_, r), p in zip(pair.both(), p2)]
    assert_same_tick(*out2)
    assert "default/y" in out2[1].placed_groups()
    assert pair.admit(out2, "default/y", verified=True) is False
    assert pair.port.running == ["default/x"]
    pair.release("default/x")
    out3 = pair.tick(None, [y])
    assert pair.admit(out3, "default/y", verified=True) is True


def _concurrent_rounds(r, rng):
    """20 rounds: a dispatch on a helper thread while this thread releases
    gangs, then the collect and verified admits; after each, the mirror
    must be the sum of the running gangs' charges."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        out = r.tick(None, _demands("port", [_gang("seed", 2)]))
        r.admit(out, "default/seed")
        for round_i in range(20):
            gangs = _demands("port", [_gang(f"r{round_i}-{j}", int(rng.integers(1, 4)),
                                            ts=float(j)) for j in range(4)])
            fut = pool.submit(r.tick_dispatch, None, gangs)
            for g in list(r.running):
                if rng.random() < 0.3 and g != "default/seed":
                    r.release(g)
            out = r.tick_collect(fut.result(timeout=60))
            for g in gangs:
                if g.full_name in out.placed_groups():
                    r.admit_verified(out, g.full_name)
            with r._state_lock:
                lanes = r.requested_lanes.copy()
                running = dict(r._running)
            expect = np.zeros_like(lanes)
            for idx, update in running.values():
                np.add.at(expect, idx, update)
            assert (lanes == expect).all(), f"mirror diverged at round {round_i}"


def test_concurrent_dispatch_admit_consistency():
    """Dispatches on a helper thread while the loop thread admits and
    releases never lose a queued delta: after every round the mirror is
    the sum of the running gangs' charges, the resident copy follows it,
    and a final tick scores like the JAX re-scorer on the same occupancy."""
    specs = _uniform_specs(8, cpu="8")  # 64 cpus
    r = port_rescore.ChurnRescorer([port_node(n, s) for n, s in specs], device="cpu")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: interleave packs and admits
    try:
        _concurrent_rounds(r, np.random.default_rng(7))
    finally:
        sys.setswitchinterval(switch)
    probe = _gang("probe", 60, ts=999.0)  # needs most of the cluster
    out_dev = r.tick(None, _demands("port", [probe]))
    with r._state_lock:
        lanes = r.requested_lanes.copy()
        dev = r._req_dev.numpy()[:len(lanes)].copy()
    np.testing.assert_array_equal(dev, lanes)
    ref = jax_rescore.ChurnRescorer([jax_node(n, s) for n, s in specs])
    as_dicts = {name: {res: int(v) for res, v in zip(r.schema.names, lanes[i]) if v}
                for i, (name, _) in enumerate(specs)}
    out_ref = ref.tick(as_dicts, _demands("jax", [probe]))
    assert out_dev.placed_groups() == out_ref.placed_groups()
    for k in HOST_KEYS:
        np.testing.assert_array_equal(np.asarray(out_dev.host[k]), np.asarray(out_ref.host[k]))


def _drive_tick_pipeline(kind, depth=2, ticks=6, window=8):
    """ladder.py config 5's loop shape in miniature through TickPipeline at
    ``depth``: whole-batch verified admits and a release each tick; the
    fill batches take disjoint windows, planned on the same empty cluster,
    so the later ones collide with the first one's seats and skip; then
    same-prefix windows. Each collect waits until every in-flight dispatch
    has packed, so each batch sees the occupancy of the same step in both
    packages. Returns the (admitted, skips) of every collect."""
    mod, node = (jax_rescore, jax_node) if kind == "jax" else (port_rescore, port_node)
    kwargs = {} if kind == "jax" else {"device": "cpu"}
    r = mod.ChurnRescorer([node(n, s) for n, s in _specs(8, seed=9)],
                          extra_resources=[GPU], **kwargs)
    pending = _demands(kind, _seeded_gangs(24, 11, prefix="p"))
    width = window * depth
    per_collect = []
    with mod.TickPipeline(r, depth) as pipe:
        for i in range(depth):
            pipe.submit(pending[i * window:(i + 1) * window])
        for t in range(ticks):
            for fut, _ in pipe._inflight:
                fut.result(timeout=60)
            out, tick_groups = pipe.collect()
            admitted, skips = pipe.admit_all(out, tick_groups)
            per_collect.append((sorted(admitted), skips))
            pending = [g for g in pending if g.full_name not in pipe.placed_ever]
            running = sorted(r.running)
            if running:
                r.release(running[t % len(running)])
            pipe.submit(pending[:width])
    # guarded state (the pipeline's helper thread wrote it), read under its
    # lock: the reference's lock-discipline instrumentation, which earlier
    # suites leave installed in the process, checks this access
    with r._state_lock:
        lanes = r.requested_lanes.copy()
    return per_collect, lanes, pipe.admit_skips


def test_tick_pipeline_depth2_matches_reference():
    got, lanes, skips = _drive_tick_pipeline("port")
    want, want_lanes, want_skips = _drive_tick_pipeline("jax")
    assert got == want
    np.testing.assert_array_equal(lanes, want_lanes)
    assert skips == want_skips
    assert sum(len(a) for a, _ in got) > 0 and skips > 0


def test_pipeline_depth_hides_simulated_link_rtt(monkeypatch):
    """tests/test_rescore.py's depth mechanism on the port: with an injected
    200 ms dispatch->collect latency a depth-1 loop misses the 100 ms tick
    every time, while a depth-2 loop of the same code absorbs it into two
    intervals and holds it."""
    rtt, interval, ticks, window = 0.2, 0.1, 6, 8
    stamps = {}
    real_dispatch, real_collect = port_rescore.dispatch_batch, port_rescore.collect_batch

    def slow_dispatch(*args):
        p = real_dispatch(*args)
        stamps[id(p)] = time.perf_counter()
        return p

    def slow_collect(p):
        dt = time.perf_counter() - stamps.pop(id(p))
        if dt < rtt:
            time.sleep(rtt - dt)
        return real_collect(p)

    monkeypatch.setattr(port_rescore, "dispatch_batch", slow_dispatch)
    monkeypatch.setattr(port_rescore, "collect_batch", slow_collect)

    def drive(depth):
        r = port_rescore.ChurnRescorer([port_node(n, s) for n, s in _uniform_specs(8)],
                                       device="cpu")
        r.warm([8, window * depth])
        r.clear_stats()
        pending = _demands("port", [_gang(f"d{depth}-{i}", 2, ts=float(i)) for i in range(24)])
        overruns = 0
        with port_rescore.TickPipeline(r, depth) as pipe:
            for _ in range(depth):
                pipe.submit(pending[:window * depth])
                time.sleep(interval)
            for _ in range(ticks):
                t0 = time.perf_counter()
                out, tick_groups = pipe.collect()
                pipe.admit_all(out, tick_groups)
                pending = [g for g in pending if g.full_name not in pipe.placed_ever]
                pipe.submit(pending[:window * depth])
                elapsed = time.perf_counter() - t0
                if elapsed > interval:
                    overruns += 1
                else:
                    time.sleep(interval - elapsed)
        return overruns, len(pipe.placed_ever)

    overruns_d1, placed_d1 = drive(1)
    overruns_d2, placed_d2 = drive(2)
    assert overruns_d1 >= ticks - 1, (overruns_d1, "depth 1 should miss")
    # the same wall-clock tolerance as the reference's test
    assert overruns_d2 <= ticks // 3, (overruns_d2, "depth 2 should hold the budget")
    assert placed_d1 > 0 and placed_d2 >= placed_d1


def test_pipeline_exit_cancels_on_failure():
    """A failure inside the loop cancels the queued dispatches and does not
    join the worker; the clean path drains every in-flight batch."""
    r = port_rescore.ChurnRescorer([port_node(n, s) for n, s in _specs(4)], device="cpu")
    gangs = _demands("port", [_gang("a", 1)])
    with port_rescore.TickPipeline(r, 2) as pipe:
        pipe.submit(gangs)
        pipe.submit(gangs)
    assert pipe.in_flight == 0 and r.latencies == []  # drained, unrecorded
    with pytest.raises(KeyError):
        with port_rescore.TickPipeline(r, 2) as pipe:
            pipe.submit(gangs)
            raise KeyError("loop failure")
    with pytest.raises(RuntimeError, match="shut down"):
        pipe.submit(gangs)
