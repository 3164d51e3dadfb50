"""The port's preemption (batch_scheduler_tpu_torch.policy.preempt,
framework.ClusterState.pods_on, sim.scenarios.spot_vs_guaranteed_scenario
and ScheduleOperation's preempt hooks) against the JAX package on the
CPU: plan_victims on the reference's 25 seeded cases, the planner's plan
and verify, the preempt_remove_pod rules over a matrix of cases, and the
whole deny -> plan -> verify -> evict -> re-admit path. Inputs come from
numpy seeds or the shared scenario; every comparison is exact."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from batch_scheduler_tpu.policy import engine as jax_engine
from batch_scheduler_tpu.policy.preempt import plan_victims as jax_plan_victims
from batch_scheduler_tpu_torch.policy import engine as port_engine
from batch_scheduler_tpu_torch.policy.preempt import _v_bucket, plan_victims

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
VN, VR, VV = 8, 2, 8  # tests/test_policy.py's bucket


@pytest.fixture(autouse=True)
def _restore_active_engines():
    saved = (jax_engine._active[0], port_engine._active[0])
    yield
    jax_engine._active[0], port_engine._active[0] = saved


def _random_preempt_case(seed):
    """tests/test_policy.py:183's seeded case, verbatim."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 3, (VN, VR)).astype(np.int32)
    fit = np.ones(VN, np.int32)
    req = np.array([2, 1], np.int32)
    need = int(rng.integers(1, 7))
    prio = int(rng.integers(1, 5))
    valloc = rng.integers(0, 3, (VV, VN)).astype(np.int32)
    vreq = np.stack(
        [np.array([int(rng.integers(1, 4)), 1], np.int32) for _ in range(VV)]
    )
    vprio = rng.integers(0, 6, VV).astype(np.int32)
    vvalid = (rng.random(VV) < 0.8).astype(np.int32)
    order = np.array(
        sorted(range(VV), key=lambda i: (-vvalid[i], int(vprio[i]), int(valloc[i].sum()))),
        np.int32,
    )
    return left, fit, req, need, prio, valloc, vreq, vprio, vvalid, order


def _pooled(left, fit, req, need):
    safe = np.maximum(req, 1)
    per = np.where(req[None, :] > 0, np.clip(left, 0, None) // safe, 2**30)
    cap = per.min(axis=1) * fit
    return int(np.minimum(cap, need).sum())


@pytest.mark.parametrize("seed", range(25))
def test_plan_victims_matches_reference(seed):
    """The same taken set, feasibility and pooled capacity as the
    reference's plan_victims, and its invariants: never an equal-or-higher
    tier, enough capacity freed, inclusion-minimal, nothing taken when
    infeasible."""
    left, fit, req, need, prio, valloc, vreq, vprio, vvalid, order = _random_preempt_case(seed)
    jt, jf, jp = jax_plan_victims(left, fit, req, np.int32(need), np.int32(prio),
                                  valloc, vreq, vprio, vvalid, order)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    taken, feasible, pooled = plan_victims(t(left), t(fit), t(req), need, prio, t(valloc),
                                           t(vreq), t(vprio), t(vvalid), t(order))
    assert taken.dtype == torch.bool and pooled.dtype == torch.int32
    np.testing.assert_array_equal(taken.numpy(), np.asarray(jt))
    assert bool(feasible) == bool(jf) and int(pooled) == int(jp)
    taken = taken.numpy()

    def freed(sel):
        out = left.astype(np.int64).copy()
        for v in range(VV):
            if sel[v]:
                out += valloc[v][:, None].astype(np.int64) * vreq[v][None, :]
        return out.astype(np.int32)

    assert all(vvalid[v] and vprio[v] < prio for v in range(VV) if taken[v])
    if bool(feasible) and taken.any():
        assert _pooled(freed(taken), fit, req, need) >= need
        for v in np.flatnonzero(taken):
            reduced = taken.copy()
            reduced[v] = False
            assert _pooled(freed(reduced), fit, req, need) < need
    if not bool(feasible):
        assert not taken.any()


def test_victim_buckets():
    assert [_v_bucket(v) for v in (0, 1, 8, 9, 100, 512, 513, 5000)] == [
        8, 8, 8, 16, 128, 512, 512, 512]


# -- the spot-vs-guaranteed scenario in each package ---------------------------

def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "sim.scenarios", "cache.pg_cache", "framework.cluster", "core.operation",
        "policy.engine", "api.types", "utils.errors")}


def _world(pkg, **scenario):
    """spot_vs_guaranteed_scenario's nodes in a ClusterState, every group in
    a status cache (phase Pending), and the member pods by group."""
    m = _mods(pkg)
    nodes, groups, pods = m["sim.scenarios"].spot_vs_guaranteed_scenario(**scenario)
    # the scenario stamps wall-clock creation times; pin them so both
    # packages see one queue order
    for i, pg in enumerate(groups):
        pg.metadata.creation_timestamp = float(i)
    cluster = m["framework.cluster"].ClusterState()
    for node in nodes:
        cluster.add_node(node)
    cache = m["cache.pg_cache"].PGStatusCache()
    for pg in groups:
        pg.status.phase = m["api.types"].PodGroupPhase.PENDING
        cache.set(pg.full_name(), m["cache.pg_cache"].PodGroupMatchStatus(pg))
    return m, cluster, cache, pods


def _operation(pkg, m, cluster, cache, terms=("preempt",), **cfg):
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    policy = m["policy.engine"].PolicyConfig(terms=terms, **cfg)
    return m["core.operation"].ScheduleOperation(cache, cluster, scorer="oracle",
                                                 policy=policy, **kw)


def _admit(op, cluster, pods):
    """One gang through PreFilter, Permit, assume and bind on the nodes of
    its batch plan (the framework's steps for a placed gang)."""
    op.pre_filter(pods[0])
    pgs = op.status_cache.get(f"{pods[0].metadata.namespace}/"
                              f"{pods[0].metadata.labels['group.batch.scheduler.tpu']}")
    seats = [node for node, count in sorted(pgs.placement_plan.items())
             for _ in range(count)]
    for pod, node in zip(pods, seats):
        op.pre_filter(pod)
        op.permit(pod, node)
        cluster.assume(pod, node)
    for pod, node in zip(pods, seats):
        pod.spec.node_name = node
        cluster.observe_pod(pod)
        op.post_bind(pod, node)


def _spot_filled(pkg, **cfg):
    m, cluster, cache, pods = _world(pkg)
    op = _operation(pkg, m, cluster, cache, **cfg)
    for name in sorted(pods):
        if name.startswith("spot"):
            _admit(op, cluster, pods[name])
    return m, op, cluster, cache, pods


def _plan_summary(plan):
    if plan is None:
        return None
    return (plan.preemptor, plan.need, list(plan.gangs),
            {g: sorted(p.metadata.name for p in pods) for g, pods in plan.pods_by_gang.items()},
            plan.feasible, plan.pooled_after, plan.evicted_pods)


def test_planner_plan_and_verify_match_reference():
    """With the spot gangs bound and filling the cluster, the guaranteed
    gang's plan (victim gangs and pods, need, pooled capacity after) is the
    reference planner's, and both verify it against the live cluster."""
    out = []
    for pkg in PACKAGES:
        m, op, cluster, cache, pods = _spot_filled(pkg)
        pod = pods["guaranteed-000"][0]
        assert [p.metadata.name for p in cluster.pods_on("node-000")] == sorted(
            p.metadata.name for p in cluster.pods_on("node-000"))
        plan = op.preempt_planner.plan(pod, cluster, cache, "default/guaranteed-000", 4)
        assert plan is not None and op.preempt_planner.verify(plan, pod, cluster)
        # a need nothing can cover: no plan
        assert op.preempt_planner.plan(pod, cluster, cache, "default/guaranteed-000",
                                       10**6) is None
        out.append(_plan_summary(plan))
    assert out[1] == out[0]
    assert out[1][2] == ["default/spot-000"] and out[1][-1] == 4


def test_pods_on_follows_the_pod_lifecycle():
    m, cluster, cache, pods = _world(PACKAGES[1])
    a, b = pods["spot-000"][:2]
    cluster.assume(a, "node-000")
    cluster.assume(b, "node-000")
    assert [p.metadata.name for p in cluster.pods_on("node-000")] == [a.metadata.name,
                                                                        b.metadata.name]
    cluster.forget(a.metadata.uid)
    b.spec.node_name = "node-000"
    cluster.observe_pod(b)
    assert cluster.pods_on("node-000") == [b]
    cluster.remove_pod(b)
    assert cluster.pods_on("node-000") == [] and cluster.pods_on("nope") == []


# -- preempt_remove_pod's rules ----------------------------------------------

CONFIGS = {"phase": None, "tiered": {}, "tiered_protect": {"protect_running": True}}
# (preemptor, victim): a gang member of group (name, phase) or an online pod
# ("online"), with a priority
PAIRS = [
    (("online", 5), ("online", 0)),
    (("gang-a", 5), ("online", 0)),
    (("online", 5), ("gang-b", 0, "Pending")),
    (("online", 5), ("gang-b", 0, "Running")),
    (("online", 5), ("missing", 0, None)),
    (("gang-a", 5), ("gang-a", 0, "Pending")),
    (("gang-a", 5), ("gang-b", 0, "Pending")),
    (("gang-a", 5), ("gang-b", 0, "Scheduled")),
    (("gang-a", 5), ("gang-b", 5, "Pending")),
    (("gang-a", 5), ("gang-b", 7, "Running")),
    (("gang-a", 0), ("gang-b", 0, "Pending")),
    (("gang-a", 5), ("missing", 0, None)),
    (("online", 0), ("gang-b", 3, "Scheduled")),
]


def _pair_pods(pkg, pair):
    m = _mods(pkg)
    scen, cm, types = m["sim.scenarios"], m["cache.pg_cache"], m["api.types"]
    cache = cm.PGStatusCache()
    out = []
    for spec in pair:
        name, prio = spec[0], spec[1]
        pod = scen.make_member_pods(name, 1, {"cpu": "1"}, priority=prio)[0]
        if name == "online":
            pod.metadata.labels = {}
        elif name != "missing" and cache.get(f"default/{name}") is None:
            pg = scen.make_sim_group(name, 2)
            phase = spec[2] if len(spec) > 2 else "Pending"
            pg.status.phase = types.PodGroupPhase(phase or "Pending")
            cache.set(pg.full_name(), cm.PodGroupMatchStatus(pg))
        out.append(pod)
    return m, cache, out


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0][0]}{p[0][1]}-{p[1][0]}{p[1][1]}"
                         + (p[1][2] or "none" if len(p[1]) > 2 else ""))
def test_preempt_remove_pod_rules_match_reference(config, pair):
    """The reference's phase rules (no policy) and the priority-tier rules
    (the "preempt" term, with and without protect_running) give the same
    verdict in both packages: the same SchedulingError class and message,
    or none."""
    verdicts = []
    for pkg in PACKAGES:
        m, cache, (pod_s, pod_r) = _pair_pods(pkg, pair)
        kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
        cfg = CONFIGS[config]
        policy = (m["policy.engine"].PolicyConfig() if cfg is None
                  else m["policy.engine"].PolicyConfig(terms=("preempt",), **cfg))
        op = m["core.operation"].ScheduleOperation(
            cache, m["framework.cluster"].ClusterState(), scorer="serial", policy=policy, **kw)
        try:
            op.preempt_remove_pod(pod_s, pod_r)
            verdicts.append(None)
        except m["utils.errors"].SchedulingError as e:
            verdicts.append((type(e).__name__, str(e)))
        assert op.preempt_add_pod(pod_s, "node") is None
    assert verdicts[1] == verdicts[0]


# -- the whole path ----------------------------------------------------------

def _preempt_path(pkg):
    """The guaranteed gang into the spot-filled cluster: denied at
    PreFilter, a victim plan, its verification against the live cluster,
    then the framework's commit steps in its order (remove every victim
    member, note_gang_evicted, forget_denied, a blind mark), and PreFilter
    again. Returns what each step showed."""
    m, op, cluster, cache, pods = _spot_filled(pkg)
    errs = m["utils.errors"]
    guaranteed = pods["guaranteed-000"]
    before = [op.oracle.placed(f"default/spot-{i:03d}") for i in range(2)]
    try:
        op.pre_filter(guaranteed[0])
        denied = None
    except errs.SchedulingError as e:
        denied = type(e).__name__
    plan = op.preempt_victim_plan(guaranteed[0])
    verified = op.preempt_planner.verify(plan, guaranteed[0], cluster)
    for victim_gang in plan.gangs:
        for victim in plan.pods_by_gang[victim_gang]:
            cluster.remove_pod(victim)
        op.note_gang_evicted(victim_gang)
    op.forget_denied("default/guaranteed-000")
    op.mark_dirty()
    op.pre_filter(guaranteed[0])
    placed = op.oracle.placed("default/guaranteed-000")
    victim_pgs = cache.get(plan.gangs[0])
    return {
        "spot_placed_before": before, "denied": denied, "plan": _plan_summary(plan),
        "verified": verified, "placed": placed,
        "assignment": op.oracle.assignment("default/guaranteed-000"),
        "victim_reset": (victim_pgs.pod_group.status.phase.value,
                         victim_pgs.pod_group.status.scheduled, victim_pgs.scheduled,
                         victim_pgs.placement_plan),
        "plans_counted": (op.policy.preempt_plans, op.policy.preempt_no_plan),
    }


def test_preempt_victim_plan_end_to_end_matches_reference():
    ref, port = (_preempt_path(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port["denied"] == "ResourceNotEnoughError" and port["verified"]
    assert port["placed"] and sum(port["assignment"].values()) == 4
    assert port["victim_reset"] == ("Pending", 0, False, None)
    assert port["plans_counted"] == (1, 0)


def test_no_plan_without_the_preempt_term_or_for_tier_zero():
    for terms, who in ((("affinity",), "guaranteed-000"), (("preempt",), "spot-001")):
        m, cluster, cache, pods = _world(PACKAGES[1])
        op = _operation(PACKAGES[1], m, cluster, cache, terms=terms)
        assert op.preempt_victim_plan(pods[who][0]) is None
    m, cluster, cache, pods = _world(PACKAGES[1])
    op = _operation(PACKAGES[1], m, cluster, cache, terms=())
    assert op.policy is None and op.preempt_planner is None
    assert op.oracle.policy_engine is None
