"""The port's runtime lock checker (``BST_LOCKCHECK=1``,
``batch_scheduler_tpu_torch/analysis/lockcheck.py``) on the port's own
classes: the counterparts of the JAX package's lockcheck tests
(``tests/test_analysis.py``), the coalescer submit storm of
``tests/test_coalescer.py::test_lockcheck_armed_submit_storm`` over a
fake executor, and a scorer that refreshes on one thread while others
read its ``stats()``.

Each storm runs in a child process with ``BST_LOCKCHECK=1`` set, so the
package's import installs the instrumentation there and nowhere else:
an instrumented class would otherwise stay instrumented in whichever
test worker ran the test, for every later test of that worker. Each
child has its own timeout, well under a minute. The child prints ``OK``
as its last line; any ``LockDisciplineError`` (with both stacks) is in
its output."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 45


def _run_armed(body: str) -> str:
    """Run ``body`` in a child interpreter with BST_LOCKCHECK=1 from the
    repo root; return its output, asserting it ended with ``OK``."""
    env = dict(os.environ, BST_LOCKCHECK="1", BST_CAPACITY="0")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(body)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert proc.stdout.strip().splitlines()[-1] == "OK", out
    return proc.stdout


def test_lockcheck_installs_from_the_package_import():
    out = _run_armed("""
        import batch_scheduler_tpu_torch
        from batch_scheduler_tpu_torch.analysis import lockcheck
        from batch_scheduler_tpu_torch.framework.cluster import ClusterState
        from batch_scheduler_tpu_torch.service.coalescer import OracleCoalescer

        assert lockcheck._installed[0]
        assert ClusterState.__dict__.get("_lockcheck_instrumented")
        assert OracleCoalescer.__dict__.get("_lockcheck_instrumented")
        # a second install is a no-op that names the same classes
        names = lockcheck.install()
        assert "batch_scheduler_tpu_torch.core.oracle_scorer:OracleScorer" in names
        print(len(names))
        print("OK")
    """)
    assert int(out.split()[0]) >= 15


def test_lockcheck_reproduces_unguarded_race_deterministically():
    _run_armed("""
        import threading

        from batch_scheduler_tpu_torch.analysis import lockcheck
        from batch_scheduler_tpu_torch.framework.cluster import ClusterState

        lockcheck.install(modules=["batch_scheduler_tpu_torch/framework/cluster.py"])
        cs = ClusterState()
        t = threading.Thread(target=cs.version)
        t.start()
        t.join()
        # deterministic: the instance is provably shared, the lock is not held
        for _ in range(3):
            try:
                _ = cs._nodes
            except lockcheck.LockDisciplineError as e:
                msg = str(e)
            else:
                raise AssertionError("unguarded read did not raise")
            assert "this access" in msg and "lock NOT held" in msg, msg
            assert "most recent guarded-state access by thread" in msg, msg
        print("OK")
    """)


def test_lockcheck_guarded_and_lock_held_paths_stay_quiet():
    _run_armed("""
        import threading

        from batch_scheduler_tpu_torch.analysis import lockcheck
        from batch_scheduler_tpu_torch.framework.cluster import ClusterState
        from batch_scheduler_tpu_torch.utils.ttl_cache import TTLCache

        lockcheck.install(modules=[
            "batch_scheduler_tpu_torch/framework/cluster.py",
            "batch_scheduler_tpu_torch/utils/ttl_cache.py",
        ])
        cs = ClusterState()
        errors = []

        def worker():
            try:
                for _ in range(100):
                    cs.version()
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        # explicit guarded access from a second thread is fine too
        with cs._lock:
            assert cs._nodes == {}

        # _get_locked is annotated lock-held and called under the RLock: the
        # frame walk must honor it across threads
        c = TTLCache()
        c.set("k", 41)

        def getter():
            try:
                assert c.get("k") == 41
            except Exception as e:
                errors.append(e)

        t = threading.Thread(target=getter)
        t.start()
        t.join()
        assert not errors, errors
        print("OK")
    """)


def test_lockcheck_armed_coalescer_submit_storm():
    """8 threads hammer schedule()/check_admission()/stats() against a
    live coalescer (its queue guarded by a Condition) over a fake
    executor, with the instrumentation installed."""
    _run_armed("""
        import threading
        import time

        import numpy as np

        from batch_scheduler_tpu_torch.ops.bucketing import pad_oracle_batch
        from batch_scheduler_tpu_torch.service.coalescer import (
            CoalesceJob, CoalesceSaturated, OracleCoalescer)

        class FakeExecJob:
            def __init__(self, host, delay):
                self._host, self._delay = host, delay
                self.queue_wait = 0.0
                self.run_seconds = delay

            def wait(self, timeout=None):
                time.sleep(self._delay)
                return self._host, {"capacity": None}

        class FakeExecutor:
            def __init__(self, delay):
                self.delay = delay

            def submit_batch(self, batch_args, progress_args, donate=None, tenant=None):
                g = int(np.asarray(batch_args[2]).shape[0])
                host = {
                    "gang_feasible": np.ones(g, bool), "placed": np.zeros(g, bool),
                    "progress": np.zeros(g, np.int32), "best": 0, "best_exists": False,
                    "assignment_nodes": np.zeros((g, 4), np.int32),
                    "assignment_counts": np.zeros((g, 4), np.int32), "telemetry": {},
                }
                return FakeExecJob(host, self.delay)

            def run_batch(self, batch_args, progress_args, donate=None, tenant=None):
                host, batch = self.submit_batch(batch_args, progress_args).wait()
                return host, batch, 0.0, self.delay

            def run(self, fn):
                return fn()

        def make_job(tenant, seed, n=8, g=4):
            r = np.random.RandomState(seed)
            remaining = r.randint(1, 4, size=g).astype(np.int32)
            raw = dict(
                alloc=r.randint(4, 16, size=(n, 3)).astype(np.int32),
                requested=r.randint(0, 4, size=(n, 3)).astype(np.int32),
                group_req=r.randint(1, 3, size=(g, 3)).astype(np.int32),
                remaining=remaining, fit_mask=np.ones((1, n), bool),
                group_valid=np.ones(g, bool), order=np.arange(g, dtype=np.int32),
                min_member=remaining.copy(), scheduled=np.zeros(g, np.int32),
                matched=np.zeros(g, np.int32), ineligible=np.zeros(g, bool),
                creation_rank=np.arange(g, dtype=np.int32),
            )
            args, progress = pad_oracle_batch(**raw)
            return CoalesceJob(tenant=tenant, n=n, g=g, r=3, padded_args=args,
                               progress_args=progress,
                               raw_fn=lambda raw=raw: tuple(raw.values()))

        coal = OracleCoalescer(FakeExecutor(0.002), depth=32, span_max=4, mode="span")
        errors = []

        def storm(i):
            try:
                for b in range(6):
                    try:
                        coal.check_admission()
                        coal.schedule(make_job(f"t{i % 3}", seed=i * 10 + b))
                    except CoalesceSaturated:
                        time.sleep(0.005)
                    coal.stats()
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=storm, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert coal.stop()
        assert not errors, errors
        assert coal.stats()["groups_run"] >= 1
        print("OK")
    """)


def test_lockcheck_scorer_stats_during_refresh():
    """A scorer refreshing on one thread (``ensure_fresh`` under its
    refresh lock, churn folded every time) while three threads read
    ``stats()``: every guarded read in ``stats()`` takes its lock, so the
    instrumented scorer, packer, holder and event log stay quiet."""
    _run_armed("""
        import threading

        from batch_scheduler_tpu_torch.cache.pg_cache import (
            PGStatusCache, PodGroupMatchStatus)
        from batch_scheduler_tpu_torch.core.oracle_scorer import OracleScorer
        from batch_scheduler_tpu_torch.framework.cluster import ClusterState
        from batch_scheduler_tpu_torch.sim import scenarios as scen

        cluster = ClusterState()
        for i in range(16):
            cluster.add_node(scen.make_sim_node(
                f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"}))
        cache = PGStatusCache()
        for j in range(6):
            pg = scen.make_sim_group(f"gang-{j}", 2 + j % 4, creation_ts=float(j))
            pg.spec.min_resources = {"cpu": 3000, "memory": 2**30}
            pgs = PodGroupMatchStatus(pg)
            pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"})[0]
            cache.set(pg.full_name(), pgs)
        pods = scen.make_member_pods("churn", 40, {"cpu": "1", "memory": "1Gi"})
        scorer = OracleScorer(device="cpu")
        scorer.ensure_fresh(cluster, cache)
        errors = []
        done = threading.Event()

        def refresher():
            try:
                for k in range(40):
                    cluster.assume(pods[k], f"n{k % 16:02d}")
                    scorer.ensure_fresh(cluster, cache)
            except Exception as e:
                errors.append(e)
            finally:
                done.set()

        def reader():
            try:
                while not done.is_set():
                    scorer.stats()
                scorer.stats()
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=refresher)]
        threads += [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, "\\n\\n".join(f"{type(e).__name__}: {e}" for e in errors)
        stats = scorer.stats()
        assert stats["batches_run"] == 41, stats
        assert stats["fold_outcomes"].get("folded", 0) == 40, stats
        print("OK")
    """)


def test_lockcheck_debug_scrape_storm_during_traced_refresh():
    """A scorer refreshing under a live trace (spans, ``_batch`` flight
    records, the ledger's batch context, denials in the flight recorder,
    the ledger and the pending tracker) while three threads scrape every
    ported route of ``serve_metrics``: every view copies under its owner's
    lock, so the instrumented recorders, ledger, health model and tracker
    stay quiet and every route answers 200."""
    _run_armed("""
        import threading
        import urllib.request

        from batch_scheduler_tpu_torch.cache.pg_cache import (
            PGStatusCache, PodGroupMatchStatus)
        from batch_scheduler_tpu_torch.core.oracle_scorer import OracleScorer
        from batch_scheduler_tpu_torch.framework.cluster import ClusterState
        from batch_scheduler_tpu_torch.sim import scenarios as scen
        from batch_scheduler_tpu_torch.utils import health, lifecycle, metrics, trace

        trace.configure(enabled=True, sample=1.0)
        cluster = ClusterState()
        for i in range(16):
            cluster.add_node(scen.make_sim_node(
                f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"}))
        cache = PGStatusCache()
        for j in range(6):
            pg = scen.make_sim_group(f"gang-{j}", 2 + j % 4, creation_ts=float(j))
            pg.spec.min_resources = {"cpu": 3000, "memory": 2**30}
            pgs = PodGroupMatchStatus(pg)
            pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"})[0]
            cache.set(pg.full_name(), pgs)
        pods = scen.make_member_pods("churn", 40, {"cpu": "1", "memory": "1Gi"})
        tracker = health.PendingGangTracker()
        health.set_active_pending(tracker)
        scorer = OracleScorer(device="cpu")
        srv = metrics.serve_metrics(port=0)
        host, port = srv.server_address
        routes = [r for r in metrics.DEBUG_ENDPOINTS if r != "/debug/events"]
        routes += ["/debug/events?since=0&limit=16", "/debug/decisions?limit=2",
                   "/debug/gangs?tenant=default", "/debug/capacity?points=4"]
        errors = []
        statuses = []
        done = threading.Event()

        def refresher():
            try:
                for k in range(30):
                    cluster.assume(pods[k], f"n{k % 16:02d}")
                    gang = f"default/gang-{k % 6}"
                    with trace.start_trace("cycle"):
                        scorer.ensure_fresh(cluster, cache)
                        trace.DEFAULT_FLIGHT_RECORDER.record(
                            gang, phase="pre_filter", verdict="denied",
                            reason="r", coalesce=True, batch=k)
                        lifecycle.DEFAULT_LEDGER.note_deny(gang, "r")
                        tracker.note_deny(gang)
                    if k % 5 == 4:
                        tracker.note_placed(gang)
                        lifecycle.DEFAULT_LEDGER.note_permit(gang)
            except Exception as e:
                errors.append(e)
            finally:
                done.set()

        def scraper():
            try:
                while not done.is_set():
                    for r in routes:
                        with urllib.request.urlopen(
                                f"http://{host}:{port}{r}", timeout=20) as resp:
                            resp.read()
                            statuses.append(resp.status)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=refresher)]
        threads += [threading.Thread(target=scraper) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
        srv.shutdown()
        srv.server_close()
        assert not errors, "\\n\\n".join(f"{type(e).__name__}: {e}" for e in errors)
        assert statuses and set(statuses) == {200}, set(statuses)
        assert scorer.stats()["batches_run"] == 30
        assert len(trace.DEFAULT_RECORDER.snapshot()) >= 30 * 5
        print("OK")
    """)


def test_lockcheck_whatif_storm_against_live_holder():
    """Four threads run what-if queries through one ``WhatIfEngine`` (its
    baseline cache and fork chain under ``_lock``) while the main thread
    syncs churn into the live holder it forks and runs batches from it:
    the instrumented engine, holder and forks stay quiet, and every live
    batch's digest equals a fork-free control pipeline's."""
    _run_armed("""
        import threading

        from batch_scheduler_tpu_torch.core.explain import WhatIfEngine
        from batch_scheduler_tpu_torch.ops.device_state import DeviceStateHolder
        from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
        from batch_scheduler_tpu_torch.ops.snapshot import DeltaSnapshotPacker, GroupDemand
        from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node
        from batch_scheduler_tpu_torch.utils.audit import plan_digest

        assert WhatIfEngine.__dict__.get("_lockcheck_instrumented")
        assert DeviceStateHolder.__dict__.get("_lockcheck_instrumented")
        nodes = [make_sim_node(f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"})
                 for i in range(16)]
        node_req = {f"n{i:02d}": {"cpu": 1000 * i, "pods": 1} for i in range(8)}
        demands = [GroupDemand(f"default/gang-{j}", 3, member_request={"cpu": 2000 + 500 * j},
                               priority=j % 3, creation_ts=float(j)) for j in range(8)]
        holder = DeviceStateHolder("cpu", label="live")
        packer, control = DeltaSnapshotPacker(), DeltaSnapshotPacker()
        engine = WhatIfEngine(holder_source=lambda: holder, device="cpu")
        cfs = [{"kind": "drain", "node": "n03"},
               {"kind": "add-nodes", "count": 20,
                "shape": {"cpu": "16", "memory": "64Gi", "pods": "110"}},
               {"kind": "remove-gang", "gang": "default/gang-1"}]
        errors = []

        def storm(w):
            try:
                for i in range(5):
                    engine.query_on(nodes, node_req, demands, cfs[(w + i) % 3],
                                    baseline_key="storm")
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=storm, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        live_req = dict(node_req)
        for tick in range(6):
            live_req["n09"] = {"cpu": 500 + tick, "pods": 1}
            snap = packer.pack(nodes, live_req, demands)
            host, _ = execute_batch_host(holder.sync(snap), snap.progress_args(), device="cpu")
            csnap = control.pack(nodes, live_req, demands)
            chost, _ = execute_batch_host(csnap.device_args(), csnap.progress_args(),
                                          device="cpu")
            assert plan_digest(host) == plan_digest(chost), tick
            holder.stats()
        for t in threads:
            t.join(timeout=30)
        assert not errors, "\\n\\n".join(f"{type(e).__name__}: {e}" for e in errors)
        assert holder.current_generation() == packer.generation
        assert holder.stats()["keyframes"] == {"first": 1}
        print("OK")
    """)
