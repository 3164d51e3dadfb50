"""The port's SLO health model and pending-gang tracker
(``batch_scheduler_tpu_torch/utils/health.py``) against the JAX
package's: the same observations, on the same injected clock, into a
fresh registry of each package give the same ``evaluate()`` payloads —
every quantile signal (the ones with no data included), every burn signal
(``burn:capacity`` from the same sampler series, ``burn:ttp`` from the
same TTP series), the structural states and the breach counters — and
the same ``PendingGangTracker`` reports. The clock is injected by
replacing each module's ``time``, so the payloads are held to exact
equality. An injected identity mismatch reaches ``note_identity`` and
breaches ``DEFAULT_HEALTH`` in both packages."""

import importlib
import weakref

import pytest

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")


class _Clock:
    def __init__(self, t0=1_700_000_000.0):
        self.t = t0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Sampler:
    """A capacity sampler stand-in: ``series()`` is what the health
    model's ``burn:capacity`` reads."""

    def __init__(self, clock):
        self.clock = clock
        self.entries = []

    def add(self, violation, merged=1, span_s=0.0, legacy=False):
        data = (
            {"pending": {"unplaceable_gangs": int(violation)}} if legacy
            else {"capacity_violation": float(violation)}
        )
        self.entries.append({"ts": self.clock.t, "span_s": span_s,
                             "merged": merged, "data": data})

    def series(self, max_points=None):
        return [dict(e) for e in self.entries]


class _World:
    """One package's health model on its own registry, clock, pending
    tracker and capacity sampler (the process-wide registrations are
    restored on close)."""

    def __init__(self, name, monkeypatch):
        self.health = importlib.import_module(f"{name}.utils.health")
        metrics = importlib.import_module(f"{name}.utils.metrics")
        self.capacity = importlib.import_module(f"{name}.ops.capacity")
        self.clock = _Clock()
        monkeypatch.setattr(self.health, "time", self.clock)
        # the failover signal reads the process-wide pool registry: a
        # pooled client another test left alive must not reach this world
        client = importlib.import_module(f"{name}.service.client")
        monkeypatch.setattr(client, "_POOLED_CLIENTS", weakref.WeakSet())
        self.reg = metrics.Registry()
        self.long = metrics.LONG_OP_BUCKETS
        self.model = self.health.HealthModel(registry=self.reg)
        self.pending = self.health.PendingGangTracker(registry=self.reg)
        self.sampler = _Sampler(self.clock)
        self._saved = (self.health.active_pending(), self.capacity.active_sampler())
        self.health.set_active_pending(self.pending)
        self.capacity.set_active_sampler(self.sampler)

    def close(self):
        self.health.set_active_pending(self._saved[0])
        self.capacity.set_active_sampler(self._saved[1])

    def observe(self, metric, value, n=1, long=False, **labels):
        hist = (self.reg.histogram(metric, buckets=self.long) if long
                else self.reg.histogram(metric))
        for _ in range(n):
            hist.observe(value, **labels)


def _script(w):
    """Yield after each stage; the caller evaluates there."""
    yield "empty"
    w.observe("bst_oracle_pack_seconds", 0.01, n=20)
    w.observe("bst_oracle_batch_seconds", 0.05, n=20, long=True)
    w.sampler.add(0)
    w.clock.advance(10)
    yield "healthy"
    w.observe("bst_oracle_pack_seconds", 2.0, n=60)
    w.observe("bst_oracle_batch_seconds", 37.0, n=30, long=True)
    w.sampler.add(1, merged=3, span_s=5.0)
    w.sampler.add(1, legacy=True)
    w.pending.note_deny("ns/starved")
    w.pending.note_deny("ns/starved")
    w.pending.note_deny("ns/other")
    w.clock.advance(30)
    yield "burning"
    w.observe("bst_gang_ttp_seconds", 30.0, n=10, long=True, tenant="ns", tier="0")
    w.observe("bst_gang_ttp_seconds", 300.0, n=4, long=True, tenant="ns", tier="1")
    w.observe("bst_gang_ttp_seconds", 6.0, n=4, long=True, tenant="other", tier="2")
    w.pending.note_placed("ns/other")
    w.clock.advance(200)
    yield "ttp-and-starvation"
    w.clock.advance(400)  # past the fast window
    w.observe("bst_oracle_pack_seconds", 0.01, n=40)
    w.sampler.add(0, merged=50)
    w.pending.note_evicted("ns/other")
    w.reg.gauge("bst_oracle_degraded").set(1)
    w.reg.gauge("bst_oracle_breaker_state").set(2, client="c0")
    yield "recovered-but-degraded"
    w.reg.gauge("bst_oracle_degraded").set(0)
    w.reg.gauge("bst_oracle_breaker_state").set(1, client="c1")
    w.model.note_identity(False, audit_id="aid-9", expected="x", got="y")
    w.pending.forget("ns/starved")
    w.clock.advance(5000)  # past the slow window
    yield "identity-and-breaker"
    w.model.reset()
    w.pending.reset()
    w.clock.advance(1)
    yield "after-reset"


@pytest.mark.parametrize("env", [
    {},
    {"BST_SLO_PACK_P95_S": "0.005", "BST_SLO_WINDOW_S": "60",
     "BST_SLO_BURN_WINDOW_S": "120", "BST_SLO_TTP_P99_T2_S": "5",
     "BST_SLO_PENDING_P95_S": "15"},
    {"BST_SLO_BURN_FAST": "junk", "BST_SLO_BURN_SLOW": "2",
     "BST_SLO_TTP_P99_S": "nope", "BST_SLO_BATCH_P95_S": ""},
], ids=["defaults", "tightened", "malformed"])
def test_same_observations_same_verdicts(monkeypatch, env):
    _same_observations_same_verdicts(monkeypatch, env)


def _same_observations_same_verdicts(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    worlds = [_World(n, monkeypatch) for n in PACKAGES]
    try:
        stages = [_script(w) for w in worlds]
        for steps in zip(*stages):
            assert steps[0] == steps[1]
            payloads = [w.model.evaluate() for w in worlds]
            assert payloads[0] == payloads[1], steps[0]
            for sig in ("cycle", "device"):
                # no package observes these in process here: no data,
                # no verdict invented
                assert payloads[1]["signals"][sig]["observations"] == 0
                assert payloads[1]["signals"][sig]["verdict"] == "ok"
            assert "burn:capacity" in payloads[1]["signals"]
            assert [w.pending.report() for w in worlds][0] == worlds[1].pending.report()
        counters = [
            (w.reg.counter("bst_slo_breach_total").values(),
             w.reg.gauge("bst_slo_burn_rate").values(),
             w.reg.gauge("bst_gang_pending_oldest_seconds").values(),
             w.reg.histogram("bst_gang_pending_seconds").snapshots())
            for w in worlds
        ]
        assert counters[0] == counters[1]
    finally:
        for w in worlds:
            w.close()


def test_a_leftover_pooled_client_stays_out(monkeypatch):
    """A multi-address client with a recent standby promotion, left alive
    in each package by earlier work in the process, reaches neither
    world: the parity script runs as on a clean process, with no failover
    signal in any payload."""
    left = []
    for name in PACKAGES:
        client = importlib.import_module(f"{name}.service.client")
        c = client.ResilientOracleClient("127.0.0.1:1,127.0.0.1:2", name="left")
        assert c._promote("crash")
        left.append(c)
    seen = []
    for name in PACKAGES:
        health = importlib.import_module(f"{name}.utils.health")
        real = health.HealthModel.evaluate

        def evaluate(self, _real=real):
            payload = _real(self)
            seen.append(payload)
            return payload

        monkeypatch.setattr(health.HealthModel, "evaluate", evaluate)
    _same_observations_same_verdicts(monkeypatch, {})
    assert seen and all("failover" not in p["signals"] for p in seen)
    for c in left:
        c.close()


def test_verdicts_move_as_the_reference_says(monkeypatch):
    """The port's model on its own, at the defaults: a healthy window is
    ok, a burst of slow packs breaches ``pack`` and ``burn:pack``, the
    capacity violations breach ``burn:capacity``, and a sticky identity
    mismatch breaches until ``reset``."""
    w = _World("batch_scheduler_tpu_torch", monkeypatch)
    try:
        verdicts = {}
        for stage in _script(w):
            verdicts[stage] = w.model.evaluate()
        assert verdicts["empty"]["verdict"] == "ok"
        assert verdicts["healthy"]["verdict"] == "ok"
        burning = verdicts["burning"]["signals"]
        assert burning["pack"]["verdict"] == "breach"
        assert burning["burn:pack"]["verdict"] == "breach"
        assert burning["batch"]["verdict"] == "warn"  # 37 s of a 45 s target
        assert burning["burn:capacity"]["verdict"] == "breach"
        assert burning["burn:capacity"]["observations"] == 5
        starve = verdicts["ttp-and-starvation"]["signals"]
        assert starve["pending"]["verdict"] == "warn"
        assert starve["pending"]["oldest_gang"] == "ns/starved"
        assert starve["burn:ttp"]["tiers"]["1"]["observations"] == 4
        rec = verdicts["recovered-but-degraded"]["signals"]
        assert rec["degraded"]["verdict"] == "breach"
        assert rec["breaker"]["verdict"] == "warn"
        assert rec["burn:pack"]["verdict"] == "warn"  # burned EARLIER
        ident = verdicts["identity-and-breaker"]["signals"]
        assert ident["identity"]["verdict"] == "breach"
        assert ident["identity"]["mismatch"]["audit_id"] == "aid-9"
        assert ident["breaker"]["open_clients"] == ["c1"]
        assert verdicts["after-reset"]["signals"]["identity"]["verdict"] == "ok"
        assert w.reg.counter("bst_slo_breach_total").value(signal="identity") == 1
    finally:
        w.close()


def test_pending_tracker_matches_reference(monkeypatch):
    reports = []
    for name in PACKAGES:
        health = importlib.import_module(f"{name}.utils.health")
        metrics = importlib.import_module(f"{name}.utils.metrics")
        clock = _Clock()
        monkeypatch.setattr(health, "time", clock)
        reg = metrics.Registry()
        t = health.PendingGangTracker(registry=reg)
        out = [t.report()]
        for gang, dt in (("a", 1), ("b", 2), ("a", 3), ("c", 5)):
            t.note_deny(gang)
            clock.advance(dt)
        out.append(t.report())
        t.note_placed("a")
        t.note_placed("never-denied")
        clock.advance(7)
        t.note_evicted("a")  # re-armed at its ORIGINAL first denial
        t.note_evicted("b")  # still pending: clock untouched
        t.note_evicted("z")  # never seen: pending from now
        out.append(t.report())
        t.forget("b")
        clock.advance(1)
        out.append(t.report())
        out.append(reg.histogram("bst_gang_pending_seconds").snapshots())
        out.append((reg.gauge("bst_gang_pending_oldest_seconds").value(),
                    reg.gauge("bst_gang_deny_streak_max").value()))
        t.reset()
        out.append(t.report())
        reports.append(out)
    assert reports[0] == reports[1]
    assert reports[1][3]["oldest_gang"] == "a"


def _small_batch(name):
    """One CPU batch's exact packed inputs."""
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cm = importlib.import_module(f"{name}.cache.pg_cache")
    cluster = importlib.import_module(f"{name}.framework.cluster").ClusterState()
    for i in range(6):
        cluster.add_node(scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "110"}))
    cache = cm.PGStatusCache()
    for j in range(4):
        pg = scen.make_sim_group(f"g{j}", 2 + j % 2, creation_ts=float(j))
        pg.spec.min_resources = {"cpu": 2000}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"g{j}", 1, {"cpu": "2"})[0]
        cache.set(pg.full_name(), pgs)
    mod = importlib.import_module(f"{name}.core.oracle_scorer")
    scorer = (mod.OracleScorer(device="cpu") if name.endswith("_torch")
              else mod.OracleScorer())
    scorer.refresh(cluster, cache)
    snap = scorer.snapshot
    return snap.device_args(), snap.progress_args()


def test_identity_mismatch_reaches_the_health_model():
    """A verification whose served digest was forged: the auditor counts a
    mismatch and ``DEFAULT_HEALTH.note_identity`` turns the ``identity``
    signal to a sticky breach carrying both digests, in both packages."""
    seen = []
    for name in PACKAGES:
        health = importlib.import_module(f"{name}.utils.health")
        health.DEFAULT_HEALTH.reset()
        try:
            batch_args, progress = _small_batch(name)
            auditor = health.IdentityAuditor(1)
            auditor.note_batch(batch_args, progress, "f" * 16, "aid-forged")
            assert auditor.drain(60.0)
            assert auditor.stats() == {"identity_audits": 1,
                                       "identity_mismatches": 1,
                                       "identity_errors": 0}
            sig = health.DEFAULT_HEALTH.evaluate()["signals"]["identity"]
            mismatch = dict(sig["mismatch"])
            assert mismatch.pop("ts") > 0
            seen.append((sig["verdict"], sig["reason"], sorted(mismatch),
                         mismatch["audit_id"], mismatch["expected"],
                         mismatch["rung"], len(mismatch["got"])))
        finally:
            health.DEFAULT_HEALTH.reset()
        assert health.DEFAULT_HEALTH.evaluate()["signals"]["identity"]["verdict"] == "ok"
    assert seen[0] == seen[1]
    assert seen[1][0] == "breach" and seen[1][3] == "aid-forged"


def test_worst_and_signal_catalog():
    for name in PACKAGES:
        health = importlib.import_module(f"{name}.utils.health")
        assert health.worst([]) == "ok"
        assert health.worst(["ok", "warn", "ok"]) == "warn"
        assert health.worst(["warn", "breach", "bogus"]) == "breach"
    ref, port = (importlib.import_module(f"{n}.utils.health") for n in PACKAGES)
    assert ref.QUANTILE_SIGNALS == port.QUANTILE_SIGNALS
