"""The two scenarios of tests/test_sim_e2e.py whose wall time is the
reference's own backoff (the 20 s deny stickiness, the gang TTL abort),
through the port's ``SimCluster`` on the CPU and the JAX reference's side by
side, held to the same outcomes — split from tests/test_torch_sim_e2e.py
(whose ``run`` fixture and summaries they share) to keep each file's time
short on one worker."""

import time

from test_torch_sim_e2e import TIMEOUT, _summary, run  # noqa: F401 — run is a fixture


def test_gang_granular_admission_batches_scale_with_gangs(run):
    n_gangs, members = 6, 8

    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node(f"n{i}", {"cpu": "16", "pods": "64"})
                     for i in range(4)])
        for g in range(n_gangs):
            c.create_group(m.scen.make_sim_group(f"gang{g}", members, creation_ts=float(g)))
        c.start()
        for g in range(n_gangs):
            c.create_pods(m.scen.make_member_pods(f"gang{g}", members, {"cpu": "1"}))
        for g in range(n_gangs):
            assert c.wait_for_bound(f"gang{g}", members, timeout=TIMEOUT), c.scheduler.stats
        oracle = c.runtime.operation.oracle
        assert oracle.batches_run <= 3 * n_gangs, oracle.batches_run
        assert oracle.batches_run < n_gangs * members // 2
        for g in range(n_gangs):
            pgs = c.runtime.operation.status_cache.get(f"default/gang{g}")
            assert pgs is not None and pgs.plan_batch_seq >= 1, g
        return {g: (s["bound"], s["admitted"]) for g, s in
                _summary(m, c, [f"gang{g}" for g in range(n_gangs)]).items()}

    ref, port = run(scenario, scorer="oracle")
    assert port == ref


def test_prescheduling_gang_with_lost_bind_responses_recovers(run):
    def scenario(m, c):
        c.add_nodes([m.scen.make_sim_node("n1", {"cpu": "16", "pods": "64"})])
        pg = m.scen.make_sim_group("lost", 4, creation_ts=time.time())
        pg.spec.min_resources = {"cpu": 1000}
        c.create_group(pg)
        c.start()
        pods = m.scen.make_member_pods("lost", 4, {"cpu": "1"})
        for p in pods[:2]:
            c.clientset.pods().create(p)
            c.clientset.pods().bind(p.metadata.name, "n1")
        op = c.runtime.operation
        assert c.wait_for(lambda: op.status_cache.get("default/lost") is not None,
                          timeout=TIMEOUT)
        pgs = op.status_cache.get("default/lost")
        pgs.pod_group.status.phase = m.types.PodGroupPhase.PRE_SCHEDULING
        pgs.scheduled = True
        c.create_pods(pods[2:])
        assert c.wait_for(lambda: all(c.clientset.pods().get(p.metadata.name).spec.node_name
                                      for p in pods), timeout=TIMEOUT), c.scheduler.stats
        return sorted(c.clientset.pods().get(p.metadata.name).spec.node_name for p in pods)

    ref, port = run(scenario, scorer="oracle", max_schedule_minutes=0.05,
                    backoff_base=0.1, backoff_cap=0.5, kubelet_start_delay=0.01)
    assert port == ref == ["n1"] * 4
