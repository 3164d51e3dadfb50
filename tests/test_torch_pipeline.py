"""The port's OracleScorer off the scheduling cycle's critical path, on the
CPU, against the reference's rules (tests/test_operation.py,
tests/test_pipeline.py): ``min_batch_interval`` serves a merely-stale
batch, the background refresh re-batches on a daemon thread and surfaces
its failure in a later cycle, a mark landing mid-batch survives, credits
die with the batch they offset, a transport without a second lane is left
blocking with a warning, and dispatch-ahead publishes its speculative
batch (enqueued with ``dispatch_batch``, collected when consumed) iff
nothing changed since it was packed, with plans equal to the JAX scorer's
and no batch left in flight after ``drain_background``. Exact equality.
"""

import importlib
import time
import warnings

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


class _Cluster:
    """Static nodes plus bound pods, with a settable version counter."""

    def __init__(self, pkg, nodes):
        self.snapshot = _m(pkg, "ops.snapshot")
        self.nodes = list(nodes)
        self.bound = {n.metadata.name: [] for n in self.nodes}

    def list_nodes(self):
        return list(self.nodes)

    def node_requested(self, name):
        return self.snapshot.node_requested_from_pods(self.bound.get(name, []))

    def bind(self, pod, name):
        pod.spec.node_name = name
        self.bound[name].append(pod)


def _world(pkg, n_nodes=5, n_gangs=3):
    scen = _m(pkg, "sim.scenarios")
    cm = _m(pkg, "cache.pg_cache")
    phase = _m(pkg, "api.types").PodGroupPhase
    cluster = _Cluster(pkg, [scen.make_sim_node(f"n{i:03d}", {"cpu": "8", "memory": "32Gi",
                                                                "pods": "110"})
                             for i in range(n_nodes)])
    cache = cm.PGStatusCache()
    names = []
    for i in range(n_gangs):
        pg = scen.make_sim_group(f"gang{i}", 3, creation_ts=float(i))
        pg.status.phase = phase.PENDING
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang{i}", 1, {"cpu": "1"})[0]
        pg.spec.min_resources = pgs.pod.resource_require()
        cache.set(pg.full_name(), pgs)
        names.append(f"default/gang{i}")
    return scen, cluster, cache, names


def _scorer(pkg, **kw):
    mod = _m(pkg, "core.oracle_scorer")
    if pkg.endswith("_torch"):
        kw["device"] = "cpu"
    return mod.OracleScorer(**kw)


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


PORT = PACKAGES[1]


def test_background_refresh_serves_stale_then_recovers():
    scen, cluster, cache, names = _world(PORT)
    oracle = _scorer(PORT, background_refresh=True)
    try:
        oracle.ensure_fresh(cluster, cache, group=names[0])  # no state: blocking
        assert oracle.batches_run == 1
        oracle.mark_dirty()
        oracle.ensure_fresh(cluster, cache, group=names[0])
        assert oracle.gang_feasible(names[0])  # served without blocking
        assert _wait(lambda: oracle.batches_run == 2)  # the daemon re-batched
        # a group missing from the snapshot takes the blocking path
        cm = _m(PORT, "cache.pg_cache")
        pg = scen.make_sim_group("late", 1, creation_ts=9.0)
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods("late", 1, {"cpu": "1"})[0]
        pg.spec.min_resources = pgs.pod.resource_require()
        cache.set(pg.full_name(), pgs)
        oracle.mark_dirty()
        oracle.ensure_fresh(cluster, cache, group="default/late")
        assert oracle.batches_run == 3 and oracle.gang_feasible("default/late")
        # a background failure is consumed by the next blocking refresh
        oracle._bg_error = RuntimeError("link down")
        oracle.mark_dirty()
        oracle.ensure_fresh(cluster, cache, group=names[0])
        assert oracle._bg_error is None and oracle.batches_run == 4
    finally:
        assert oracle.drain_background()


def test_min_batch_interval_serves_stale_batch_until_it_elapses():
    scen, cluster, cache, names = _world(PORT)
    oracle = _scorer(PORT, min_batch_interval=3600.0)
    oracle.ensure_fresh(cluster, cache, group=names[0])
    oracle.mark_dirty()
    oracle.ensure_fresh(cluster, cache, group=names[0])
    assert oracle.batches_run == 1 and oracle._stale(cluster)
    oracle._last_batch_t -= 7200.0  # the interval has elapsed
    oracle.ensure_fresh(cluster, cache, group=names[0])
    assert oracle.batches_run == 2 and not oracle._stale(cluster)


def test_mark_dirty_during_refresh_survives():
    scen, cluster, cache, names = _world(PORT)
    oracle = _scorer(PORT)
    real = oracle._execute

    def execute_and_invalidate(snap):
        out = real(snap)
        oracle.mark_dirty()  # a gang completed while the batch ran
        return out

    oracle._execute = execute_and_invalidate
    oracle.ensure_fresh(cluster, cache, group=names[0])
    oracle._execute = real
    assert oracle._stale(cluster)
    oracle.ensure_fresh(cluster, cache, group=names[0])
    assert not oracle._stale(cluster) and oracle.batches_run == 2


def test_credits_issued_during_refresh_die_with_old_batch():
    scen, cluster, cache, names = _world(PORT)
    cluster.version_counter = 7
    cluster.version = lambda: cluster.version_counter
    oracle = _scorer(PORT)
    oracle.ensure_fresh(cluster, cache, group=names[0])
    assert not oracle._stale(cluster)
    real = oracle._execute

    def execute_with_interleaved_assume(snap):
        out = real(snap)
        cluster.version_counter += 1
        oracle.credit_expected_change(1)
        return out

    oracle.mark_dirty()
    oracle._execute = execute_with_interleaved_assume
    oracle.ensure_fresh(cluster, cache, group=names[0])
    oracle._execute = real
    assert oracle._stale(cluster)
    oracle.ensure_fresh(cluster, cache, group=names[0])
    assert not oracle._stale(cluster)


def test_off_cycle_modes_refused_on_single_lane_scorer():
    mod = _m(PORT, "core.oracle_scorer")

    class SingleConn(mod.OracleScorer):
        supports_background_refresh = False
        supports_dispatch_ahead = False

    scen, cluster, cache, names = _world(PORT)
    scorer = SingleConn(device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _m(PORT, "core.operation").ScheduleOperation(
            cache, cluster, scorer=scorer, background_refresh=True, dispatch_ahead=True,
            min_batch_interval=0.5, device="cpu")
    assert scorer.background_refresh is False and scorer.dispatch_ahead is False
    assert scorer.min_batch_interval == 0.5
    assert {m for m in ("background_refresh", "dispatch_ahead")
            if any(m in str(x.message) for x in w)} == {"background_refresh", "dispatch_ahead"}


def _wait_for_spec(scorer, timeout=15.0):
    def banked():
        with scorer._refresh_lock:
            return scorer._spec is not None

    assert _wait(lambda: banked() or scorer._spec_error is not None, timeout)
    assert scorer._spec_error is None, scorer._spec_error
    assert banked(), "speculative batch never banked"


def _drive_dispatch_ahead(pkg):
    """The reference's bit-identity round: each round the speculative
    batch (packed before the round's mutation) is discarded, and the plans
    equal a blocking scorer's."""
    scen, cluster, cache, names = _world(pkg)
    serial = _scorer(pkg)
    ahead = _scorer(pkg, dispatch_ahead=True)
    plans = []
    try:
        for round_no in range(3):
            serial.mark_dirty()
            serial.ensure_fresh(cluster, cache, group=names[0])
            if round_no:
                _wait_for_spec(ahead)
            ahead.mark_dirty()
            ahead.ensure_fresh(cluster, cache, group=names[0])
            for name in names:
                assert ahead.placed(name) == serial.placed(name), name
                assert ahead.assignment(name) == serial.assignment(name), name
            plans.append([(serial.placed(n), serial.assignment(n)) for n in names])
            cluster.bind(scen.make_member_pods("filler", 1, {"cpu": "4"})[0],
                         f"n{round_no:03d}")
        assert ahead.spec_served == 0 and ahead.spec_discarded >= 1
    finally:
        assert ahead.drain_background()
    return plans


def test_dispatch_ahead_bit_identical_and_equal_to_reference():
    ref, port = (_drive_dispatch_ahead(pkg) for pkg in PACKAGES)
    assert port == ref
    assert _m(PORT, "ops.oracle").inflight_batches() == 0


def test_dispatch_ahead_serves_speculative_batch_when_state_unchanged():
    scen, cluster, cache, names = _world(PORT)
    ahead = _scorer(PORT, dispatch_ahead=True)
    try:
        ahead.ensure_fresh(cluster, cache, group=names[0])
        _wait_for_spec(ahead)
        # staleness whose cause PREDATES the speculative pack: drop the
        # banked batch (collected, so nothing stays in flight), mark
        # dirty, re-kick (packs at the new generation), then consume
        with ahead._refresh_lock:
            spec, ahead._spec = ahead._spec, None
        spec[1]()
        with ahead._spec_lock:
            spec_thread = ahead._spec_thread
        if spec_thread is not None:
            spec_thread.join(15.0)
        ahead.mark_dirty()
        ahead._kick_speculative(cluster, cache)
        _wait_for_spec(ahead)
        before = ahead.batches_run
        ahead.ensure_fresh(cluster, cache, group=names[0])
        assert ahead.spec_served == 1 and ahead.batches_run == before + 1
        stats = ahead.stats()
        assert stats["spec_served"] == 1 and stats["spec_dispatched"] >= 2
    finally:
        assert ahead.drain_background()
    # the drain collected the batch banked after the last publish
    assert _m(PORT, "ops.oracle").inflight_batches() == 0
    with ahead._refresh_lock:
        assert ahead._spec is None
