"""The policy engine's preemption through the port's scheduler loop on the
CPU, side by side with the JAX reference's (tests/test_policy.py's
spot-vs-guaranteed e2e): the spot gangs fill the cluster, the guaranteed
gang is denied, and ``Scheduler._policy_preempt`` plans the victims,
re-verifies them against the live cluster and commits through
``_evict_gang_plan`` (eviction, ``note_gang_evicted``, the respawn). Both
packages must place the guaranteed gang, count one priority-tier
preemption, respawn a spot gang under new uids and record its eviction
before its respawn in the ledger. Its wall time is the reference's own
20 s deny stickiness, so it has a file of its own."""

import importlib

from test_torch_sim_e2e import run  # noqa: F401 — a fixture


def test_spot_vs_guaranteed_preempts_through_the_scheduler(run, monkeypatch):
    monkeypatch.setenv("BST_POLICY", "preempt")

    def scenario(m, c):
        reg = importlib.import_module(f"{m.name}.utils.metrics").DEFAULT_REGISTRY
        preempts = reg.counter("bst_preemptions_total", "")
        before = preempts.value(reason="priority-tier")
        assert c.runtime.operation.preempt_planner is not None
        nodes, groups, pods = m.scen.spot_vs_guaranteed_scenario()
        c.add_nodes(nodes)
        spot = [g.metadata.name for g in groups if g.metadata.name.startswith("spot")]
        for g in groups:
            if g.metadata.name in spot:
                c.create_group(g)
        c.start()
        for name in spot:
            c.create_pods(pods[name])
        assert all(c.wait_for_bound(name, 4, timeout=120.0) for name in spot)
        uids = {name: {p.metadata.uid for p in c.member_pods(name)} for name in spot}
        for g in groups:
            if g.metadata.name.startswith("guaranteed"):
                c.create_group(g)
        c.create_pods(pods["guaranteed-000"])
        assert c.wait_for_bound("guaranteed-000", 4, timeout=120.0), c.scheduler.stats

        def evicted_respawned():
            out = []
            for g, tv in m.ledger.snapshot()["gangs"].items():
                evs = [e["event"] for e in tv["events"]]
                if "evicted" in evs and "respawn" in evs:
                    assert evs.index("evicted") < evs.index("respawn"), (g, evs)
                    out.append(g)
            return out

        assert c.wait_for(lambda: bool(evicted_respawned()), timeout=30.0)
        respawned = sorted(n for n in spot if not ({p.metadata.uid for p in c.member_pods(n)}
                                                    & uids[n]))
        return {
            "guaranteed_bound": sum(1 for p in c.member_pods("guaranteed-000")
                                    if p.spec.node_name),
            "members": {n: len(c.member_pods(n)) for n in spot},
            "respawned": respawned,
            "evicted_respawned": sorted(evicted_respawned()),
            "priority_tier": preempts.value(reason="priority-tier") - before >= 1,
            "preempted": c.scheduler.stats["preemptions"] >= 1,
        }

    ref, port = run(scenario, scorer="oracle", kubelet_start_delay=0.01)
    assert port == ref
    assert port["guaranteed_bound"] == 4 and port["respawned"] == ["spot-000"]
    assert port["members"] == {"spot-000": 4, "spot-001": 4}
