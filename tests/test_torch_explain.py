"""The port's gang observatory (``batch_scheduler_tpu_torch/ops/explain.py``,
``core/explain.py``, the holder's ``fork`` / ``apply_batch``) held against
the JAX package's on the CPU.

- ``explain_gang`` field by field on seeded numpy batches: both mask
  modes, with and without the policy composite, a padded bucket
  (``n_real < N``), target gangs first / middle / last in the queue and
  one the scan leaves unplaced, nodes with tied near-miss scores. Every
  int and bool field and ``near_idx`` exact; the headroom sums (exact
  int64 in the port, float32 in the reference) within ``rtol=1e-5``.
- The kernel route's identity: the need-masked prefix scan
  (``prefix_leftover``, the plain serial scan here) gives the capture
  scan's entry leftover at every position.
- ``explain_arrays`` payloads equal across the packages; offline lane
  names degrade to ``lane<i>``.
- ``WhatIfEngine.query_on`` for the five counterfactual kinds, with and
  without policy: equal answers across the packages (times and the cache
  flag aside) on every port rung, plan digests equal to a cluster that
  applied the change.
- The reference's unit cases (``tests/test_explain.py``) against the
  reference's answers, the fork's copy-on-write by values and
  ``data_ptr``, and the live observatory on the README race scenario
  through both packages' ``ScheduleOperation``, served by the port's
  ``serve_metrics``.

The JAX side runs jitted on the CPU (explain is ``lax``); the port side
with ``device="cpu"``, where every scan is its plain version."""

import importlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
PORT = "batch_scheduler_tpu_torch"
REF = "batch_scheduler_tpu"
HEADROOM = ("headroom_entry", "headroom_after")
RTOL = 1e-5


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _restore_registrations():
    """ScheduleOperation and an enabled PolicyEngine register themselves
    process-wide: put every registration back after each test."""
    saved = []
    for pkg in PACKAGES:
        exp = _mod(pkg, "core.explain")
        eng = _mod(pkg, "policy.engine")
        health = _mod(pkg, "utils.health")
        saved.append((exp, exp.active_observatory(), eng, eng._active[0],
                      health, health.active_pending()))
    yield
    for exp, obs, eng, active, health, pending in saved:
        exp.set_active_observatory(obs)
        eng._active[0] = active
        health.set_active_pending(pending)


# ---------------------------------------------------------------------------
# explain_gang on seeded numpy batches
# ---------------------------------------------------------------------------

NB, N_REAL, GB, R = 32, 27, 16, 3


def _batch(per_group: bool, seed: int = 3):
    """A padded batch: 27 real nodes of three shapes (so many near-miss
    scores tie) in a 32-node bucket, 14 real gangs in a 16-gang bucket,
    enough demand that some gangs stay unplaced, a random queue order."""
    rng = np.random.default_rng(seed)
    shapes = np.array([[16000, 64, 8], [8000, 32, 0], [32000, 128, 4]], np.int32)
    alloc = np.zeros((NB, R), np.int32)
    alloc[:N_REAL] = shapes[rng.integers(0, 3, N_REAL)]
    requested = np.zeros((NB, R), np.int32)
    requested[:N_REAL] = (alloc[:N_REAL] * rng.uniform(0, 0.6, (N_REAL, 1))).astype(np.int32)
    requested[3] = alloc[3] + 5  # an over-committed node: negative leftover
    group_req = np.zeros((GB, R), np.int32)
    group_req[:14, 0] = rng.choice([1000, 2000, 4000, 6000], 14)
    group_req[:14, 1] = rng.choice([1, 2, 4], 14)
    group_req[:14, 2] = rng.choice([0, 0, 1], 14)
    remaining = np.zeros(GB, np.int32)
    remaining[:14] = rng.integers(2, 40, 14)
    remaining[5] = 0  # a gang already whole: a need-0 step mid-queue
    group_valid = np.zeros(GB, bool)
    group_valid[:14] = True
    order = np.concatenate([rng.permutation(14), [14, 15]]).astype(np.int32)
    if per_group:
        fit_mask = rng.random((GB, NB)) > 0.25
        fit_mask[:, N_REAL:] = False
    else:
        fit_mask = np.zeros((1, NB), bool)
        fit_mask[0, :N_REAL] = True
        fit_mask[0, 7] = False  # a cordoned node
    return (alloc, requested, group_req, remaining, fit_mask, group_valid, order)


def _policy_cols(seed: int = 4):
    from batch_scheduler_tpu_torch.policy.terms import DOMAIN_BUCKETS, HASH_LANES, label_hash

    rng = np.random.default_rng(seed)
    hashes = [label_hash("pool", f"p{i}") for i in range(3)]
    node_hash = np.zeros((NB, HASH_LANES), np.int32)
    node_hash[:N_REAL, 0] = np.array(hashes, np.int32)[rng.integers(0, 3, N_REAL)]
    node_dom = np.zeros(NB, np.int32)
    node_dom[:N_REAL] = rng.integers(0, 4, N_REAL)
    prio = rng.integers(0, 3, GB).astype(np.int32)
    aff = np.where(rng.random(GB) < 0.4, np.array(hashes, np.int32)[rng.integers(0, 3, GB)], 0)
    anti = np.where(rng.random(GB) < 0.3, np.array(hashes, np.int32)[rng.integers(0, 3, GB)], 0)
    gang_dom = np.zeros((GB, DOMAIN_BUCKETS), np.int32)
    gang_dom[:, :4] = rng.integers(0, 3, (GB, 4))
    return (prio, aff.astype(np.int32), anti.astype(np.int32), gang_dom, node_hash, node_dom)


TERMS = ("affinity", "anti-affinity", "spread")
WEIGHTS = (32, 8, 3)


def _placed_plain(args):
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs, left_resources

    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return assign_gangs(left_resources(t[0], t[1]), t[2], t[3], t[4], t[6])[1].numpy()


def _targets(args):
    """Gang indices: first, middle and last real gang in queue order, and
    one the plain scan leaves unplaced."""
    order = [int(x) for x in args[6] if x < 14]
    placed = _placed_plain(args)
    unplaced = [g for g in order if not placed[g] and args[3][g] > 0]
    assert unplaced, "the seeded batch must leave a gang unplaced"
    return {"first": order[0], "middle": order[len(order) // 2], "last": order[-1],
            "unplaced": unplaced[0]}


def _ref_explain(args, g, policy):
    from batch_scheduler_tpu.ops.explain import explain_gang

    kw = {}
    if policy is not None:
        kw = {"policy_cols": policy, "policy_terms": TERMS, "policy_weights": WEIGHTS}
    out = explain_gang(*args, np.int32(g), np.int32(N_REAL), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_explain(args, g, policy, fn="explain_gang"):
    ex = _mod(PORT, "ops.explain")
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    kw = {}
    if policy is not None:
        kw = {"policy_cols": tuple(torch.from_numpy(c) for c in policy),
              "policy_terms": TERMS, "policy_weights": WEIGHTS}
    out = getattr(ex, fn)(*t, g, N_REAL, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_breakdowns_equal(ref, port):
    assert set(ref) == set(port)
    for key in ref:
        if key in HEADROOM:
            np.testing.assert_allclose(port[key], ref[key], rtol=RTOL, err_msg=key)
        else:
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


@pytest.mark.parametrize("target", ["first", "middle", "last", "unplaced"])
@pytest.mark.parametrize("policy_on", [False, True], ids=["base", "policy"])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per_group"])
def test_explain_gang_field_by_field(per_group, policy_on, target):
    args = _batch(per_group)
    policy = _policy_cols() if policy_on else None
    g = _targets(args)[target]
    ref = _ref_explain(args, g, policy)
    port = _port_explain(args, g, policy)
    _assert_breakdowns_equal(ref, port)
    # the padded rows never count, and the over-committed node is clipped
    assert int(port["nodes_indep"]) <= N_REAL
    assert all(int(i) < NB for i in port["near_idx"])


def test_near_miss_ties_follow_ascending_node_index():
    """Identical nodes tie on the near-miss score: both packages rank them
    by ascending node index (``lax.top_k``'s rule)."""
    args = list(_batch(False))
    alloc = np.zeros((NB, R), np.int32)
    alloc[:N_REAL] = [8000, 32, 2]
    args[0], args[1] = alloc, np.zeros((NB, R), np.int32)
    args[1][N_REAL - 1] = [7000, 0, 0]  # one node tighter, ranked last
    g = _targets(tuple(args))["last"]
    ref = _ref_explain(tuple(args), g, None)
    port = _port_explain(tuple(args), g, None)
    _assert_breakdowns_equal(ref, port)
    scores = port["near_cap"]
    assert len(set(scores.tolist())) < len(scores)  # ties were ranked
    tied = [int(i) for i, c in zip(port["near_idx"], scores) if c == scores[0]]
    assert tied == sorted(tied)


@pytest.mark.parametrize("policy_on", [False, True], ids=["base", "policy"])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per_group"])
def test_prefix_scan_gives_the_capture_leftover_at_every_position(per_group, policy_on):
    """The kernel route's identity, with the plain serial scan standing in
    for the kernel: zeroing the needs at and after a gang's position leaves
    exactly the leftover the capture scan carried into its step."""
    ex = _mod(PORT, "ops.explain")
    from batch_scheduler_tpu_torch.ops.oracle import left_resources

    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _batch(per_group)]
    left0 = left_resources(args[0], args[1])
    policy = pen_keep = None
    if policy_on:
        cols = tuple(torch.from_numpy(c) for c in _policy_cols())
        policy = (cols, TERMS, WEIGHTS)
        pen_keep = ex._policy_fn(cols, TERMS, WEIGHTS)
    for g in args[6].tolist():
        want, fin = ex._capture_scan(left0, args[2], args[3], args[4], args[6], g, pen_keep)
        got = ex.prefix_leftover(left0, args[2], args[3], args[4], args[6], g, policy)
        assert torch.equal(got, want), g
    assert torch.equal(ex._scan(left0, args[2], args[3], args[4], args[6], policy), fin)


def test_explain_gang_rejects_out_of_range_gang():
    ex = _mod(PORT, "ops.explain")
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in _batch(False)]
    with pytest.raises(ValueError):
        ex.explain_gang(*t, GB, N_REAL)
    with pytest.raises(ValueError):
        ex.explain_gang(*t, 0, NB + 1)


# ---------------------------------------------------------------------------
# explain_arrays payloads (the reference's TestExplainKernel cases)
# ---------------------------------------------------------------------------


def _node(pkg, name, alloc=None, unschedulable=False, labels=None):
    node = _mod(pkg, "sim.scenarios").make_sim_node(
        name, alloc or {"cpu": "8", "memory": "16Gi", "pods": 110}, labels=labels)
    node.spec.unschedulable = unschedulable
    return node


def _demand(pkg, name, members, cpu, prio=0, ts=0.0, **kw):
    return _mod(pkg, "ops.snapshot").GroupDemand(
        name, members, member_request={"cpu": cpu}, priority=prio, creation_ts=ts, **kw)


def _kernel_snap(pkg):
    """n0 cordoned, n1 nearly full (1 cpu left), n2/n3 empty 8-cpu nodes;
    an early 2 x 4-cpu gang and a late 5 x 2-cpu one."""
    shape = {"cpu": "8", "memory": "16Gi", "pods": 110}
    nodes = [_node(pkg, f"n{i}", shape, unschedulable=i == 0) for i in range(4)]
    demands = [_demand(pkg, "default/early", 2, 4000, ts=1.0),
               _demand(pkg, "default/late", 5, 2000, ts=2.0)]
    return _mod(pkg, "ops.snapshot").ClusterSnapshot(
        nodes, {"n1": {"cpu": 7000, "pods": 1}}, demands)


def _explain_arrays(pkg, *args, **kw):
    fn = _mod(pkg, "core.explain").explain_arrays
    if pkg == PORT:
        kw["device"] = "cpu"
    return fn(*args, **kw)


def _assert_payloads_equal(ref, port):
    for key in ("headroom_entry", "headroom_after_batch"):
        r, p = ref.pop(key), port.pop(key)
        assert set(r) == set(p)
        for lane in r:
            assert p[lane] == pytest.approx(r[lane], rel=RTOL), (key, lane)
    assert port == ref


@pytest.mark.parametrize("gang", ["default/late", "default/early"])
def test_explain_arrays_payload_matches_reference(gang):
    out = {}
    for pkg in PACKAGES:
        snap = _kernel_snap(pkg)
        out[pkg] = _explain_arrays(pkg, snap.device_args(), snap.group_index(gang),
                                   node_names=snap.node_names, lane_names=snap.schema.names)
    port = dict(out[PORT])
    _assert_payloads_equal(out[REF], out[PORT])
    if gang == "default/late":
        # the reference's hand-computed breakdown (tests/test_explain.py)
        assert port["excluded"] == {"fit_mask": 1, "policy_mask": 0, "capacity": 2}
        assert port["binding_lane"] == "cpu" and port["blocked_by_lane"] == {"cpu": 2}
        assert (port["nodes_indep"], port["nodes_entry"], port["need"]) == (2, 1, 5)
        assert port["feasible_alone"] is True and port["feasible_at_entry"] is False
        by_node = {e["node"]: e for e in port["near_miss"]}
        assert by_node["n1"]["deficit"] == {"cpu": 1000}
        assert by_node["n1"]["capacity_entry"] == 0


def test_explain_verdict_matches_batch_result():
    snap = _kernel_snap(PORT)
    host, _ = _mod(PORT, "ops.oracle").execute_batch_host(
        snap.device_args(), snap.progress_args(), device="cpu")
    g_late, g_early = snap.group_index("default/late"), snap.group_index("default/early")
    assert bool(host["placed"][g_early]) and not bool(host["placed"][g_late])
    out = _explain_arrays(PORT, snap.device_args(), g_late, node_names=snap.node_names,
                          lane_names=snap.schema.names)
    assert out["feasible_alone"] == bool(host["gang_feasible"][g_late])
    assert out["feasible_at_entry"] is False


def test_explain_arrays_policy_hard_mask_matches_reference():
    out = {}
    for pkg in PACKAGES:
        terms = _mod(pkg, "policy.terms")
        snap = _kernel_snap(pkg)
        g = snap.group_index("default/late")
        nb, gb = snap.alloc.shape[0], snap.group_req.shape[0]
        h = terms.label_hash("team", "red")
        anti = np.zeros(gb, np.int32)
        anti[g] = h
        node_hash = np.zeros((nb, terms.HASH_LANES), np.int32)
        node_hash[3, 0] = h  # n3 carries the anti-affinity target
        cols = (np.zeros(gb, np.int32), np.zeros(gb, np.int32), anti,
                np.zeros((gb, terms.DOMAIN_BUCKETS), np.int32), node_hash,
                np.zeros(nb, np.int32))
        out[pkg] = _explain_arrays(pkg, snap.device_args(), g, node_names=snap.node_names,
                                   lane_names=snap.schema.names,
                                   policy=(cols, ("anti-affinity",), WEIGHTS))
    port = dict(out[PORT])
    _assert_payloads_equal(out[REF], out[PORT])
    assert port["excluded"]["policy_mask"] == 1 and port["excluded"]["fit_mask"] == 1
    assert port["nodes_indep"] == 1
    assert all("policy_penalty" in e for e in port["near_miss"])


def test_explain_arrays_offline_lane_names_degrade():
    out = {pkg: _explain_arrays(pkg, _kernel_snap(pkg).device_args(), 0) for pkg in PACKAGES}
    assert all(k.startswith("lane") for k in out[PORT]["headroom_entry"])
    _assert_payloads_equal(out[REF], out[PORT])


def test_explain_arrays_seeded_batch_matches_reference():
    """The seeded padded batch through both hosts' assembly, policy on."""
    args = _batch(True)
    g = _targets(args)["unplaced"]
    names = [f"node-{i}" for i in range(N_REAL)]
    out = {pkg: _explain_arrays(pkg, args, g, node_names=names,
                                policy=(_policy_cols(), TERMS, WEIGHTS))
           for pkg in PACKAGES}
    _assert_payloads_equal(out[REF], out[PORT])


# ---------------------------------------------------------------------------
# counterfactuals: grammar and application
# ---------------------------------------------------------------------------


def _both(fn_name, *args):
    """(ok, value or exception type) of one core.explain function in each
    package."""
    out = []
    for pkg in PACKAGES:
        try:
            out.append((True, getattr(_mod(pkg, "core.explain"), fn_name)(*args)))
        except ValueError as e:
            out.append((False, type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("params", [
    {"drain": "n1"}, {"cordon": "n2"}, {"add_nodes": "4", "node_cpu": "16"},
    {"add_nodes": "3", "node_memory": "64Gi", "node_pods": "64"},
    {"bump_gang": "d/g", "tier": "7"}, {"remove_gang": "d/g"},
])
def test_parse_grammar_matches_reference(params):
    ref, port = _both("parse_counterfactual", params)
    assert ref == port and ref[0]


@pytest.mark.parametrize("params", [
    {}, {"drain": "a", "cordon": "b"}, {"add_nodes": "zap"}, {"add_nodes": "0"},
    {"add_nodes": "5000"}, {"bump_gang": "d/g"}, {"bump_gang": "d/g", "tier": "x"},
])
def test_parse_rejects_like_reference(params):
    ref, port = _both("parse_counterfactual", params)
    assert not ref[0] and ref == port


def test_apply_unknown_targets_raise_like_reference():
    for cf in ({"kind": "drain", "node": "ghost"}, {"kind": "cordon", "node": "ghost"},
               {"kind": "bump-gang", "gang": "ghost", "tier": 1},
               {"kind": "remove-gang", "gang": "ghost"}, {"kind": "warp"}):
        got = [
            _both("apply_counterfactual", [_node(pkg, "n0")], {},
                  [_demand(pkg, "default/g", 1, 1000)], cf)[i]
            for i, pkg in enumerate(PACKAGES)
        ]
        assert not got[0][0] and got[0] == got[1], cf


def test_cordon_never_mutates_live_node():
    nodes = [_node(PORT, "n0"), _node(PORT, "n1")]
    out, _, _ = _mod(PORT, "core.explain").apply_counterfactual(
        nodes, {}, [], {"kind": "cordon", "node": "n1"})
    assert out[1].spec.unschedulable is True
    assert nodes[1].spec.unschedulable is False


# ---------------------------------------------------------------------------
# what-if: identity across packages and against an applied cluster
# ---------------------------------------------------------------------------

CFS = {
    "drain": {"kind": "drain", "node": "n01"},
    "cordon": {"kind": "cordon", "node": "n02"},
    "add-nodes": {"kind": "add-nodes", "count": 6,
                  "shape": {"cpu": "16", "memory": "64Gi", "pods": "110"}},
    "bump-gang": {"kind": "bump-gang", "gang": "default/gang-05", "tier": 9},
    "remove-gang": {"kind": "remove-gang", "gang": "default/gang-00"},
}
VOLATILE = ("elapsed_s", "baseline_cached")


def _inputs(pkg, n=12, g=6, seed=5, policy=False):
    """The reference's what-if inputs (tests/test_explain.py ``_inputs``),
    with zone/pool labels and policy demands when ``policy``."""
    rng = np.random.default_rng(seed)
    nodes = [
        _node(pkg, f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": 110},
              labels={"zone": f"z{i % 3}", "pool": f"p{i % 2}"} if policy else None)
        for i in range(n)
    ]
    node_req = {f"n{i:02d}": {"cpu": int(rng.integers(0, 8000)), "pods": 1}
                for i in range(n // 2)}
    label_hash = _mod(pkg, "policy.terms").label_hash
    demands = []
    for i in range(g):
        kw = {}
        if policy:
            kw = {"affinity_hash": label_hash("pool", "p1") if i % 3 == 0 else 0,
                  "anti_hash": label_hash("pool", "p0") if i % 3 == 1 else 0,
                  "spread": i % 2 == 0}
        demands.append(_demand(pkg, f"default/gang-{i:02d}", 3, int(rng.integers(1000, 6000)),
                               prio=int(rng.integers(0, 3)), ts=float(i), **kw))
    return nodes, node_req, demands


def _engine(pkg, policy=False, **kw):
    exp = _mod(pkg, "core.explain")
    eng = None
    if policy:
        pe = _mod(pkg, "policy.engine")
        eng = pe.PolicyEngine(pe.PolicyConfig(terms=TERMS, spread_node_key="zone"))
    if pkg == PORT:
        kw["device"] = "cpu"
    return exp.WhatIfEngine(policy_engine=eng, **kw)


def _direct_digest(pkg, nodes, node_req, demands, policy_engine=None):
    snap = _mod(pkg, "ops.snapshot").ClusterSnapshot(nodes, node_req, demands,
                                                     policy_engine=policy_engine)
    kw = {"device": "cpu"} if pkg == PORT else {}
    host, _ = _mod(pkg, "ops.oracle").execute_batch_host(
        snap.device_args(), snap.progress_args(), policy=snap.policy_payload(), **kw)
    return _mod(pkg, "utils.audit").plan_digest(host)


@pytest.mark.parametrize("rung", ["steady", "wavefront", "cpu-ladder", "topk"])
@pytest.mark.parametrize("policy", [False, True], ids=["base", "policy"])
@pytest.mark.parametrize("kind", list(CFS))
def test_whatif_matches_reference_and_applied_cluster(kind, policy, rung):
    answers = {}
    for pkg in PACKAGES:
        nodes, node_req, demands = _inputs(pkg, policy=policy)
        engine = _engine(pkg, policy)
        kw = {"rung": rung} if pkg == PORT else {}
        answers[pkg] = engine.query_on(nodes, node_req, demands, CFS[kind],
                                       baseline_key="t", **kw)
        if pkg == PORT:
            applied = _mod(pkg, "core.explain").apply_counterfactual(
                nodes, node_req, demands, CFS[kind])
            assert answers[pkg]["whatif"]["plan_digest"] == _direct_digest(
                pkg, *applied, engine.policy_engine)
            assert answers[pkg]["base"]["plan_digest"] == _direct_digest(
                pkg, nodes, node_req, demands, engine.policy_engine)
    ref, port = ({k: v for k, v in a.items() if k not in VOLATILE + ("rung",)}
                 for a in answers.values())
    assert port == ref
    assert answers[PORT]["rung"] == rung


def test_whatif_cached_baseline_and_fork_shape_keyframe():
    """A second query with the same key reuses the baseline (and its
    fork); add-nodes past the node bucket keyframes the child fork."""
    nodes, node_req, demands = _inputs(PORT, n=16)
    engine = _engine(PORT)
    first = engine.query_on(nodes, node_req, demands, CFS["drain"], baseline_key="k")
    base_fork = engine._baseline[4]
    before = {n: getattr(base_fork, n).clone() for n in ("_alloc", "_requested", "_group_req")}
    ptrs = {n: t.data_ptr() for n, t in ((n, getattr(base_fork, n)) for n in before)}
    second = engine.query_on(nodes, node_req, demands, CFS["add-nodes"], baseline_key="k")
    third = engine.query_on(nodes, node_req, demands, CFS["cordon"], baseline_key="k")
    assert not first["baseline_cached"] and second["baseline_cached"] and third["baseline_cached"]
    assert second["whatif"]["nodes"] == 22 and second["base"]["plan_digest"] == first["base"][
        "plan_digest"]
    for name, want in before.items():
        assert torch.equal(getattr(base_fork, name), want), name
        assert getattr(base_fork, name).data_ptr() == ptrs[name], name
    assert engine.queries == 3


def test_bump_gang_reorders_queue():
    answers = {}
    for pkg in PACKAGES:
        nodes = [_node(pkg, f"n{i}", {"cpu": "8", "memory": "32Gi", "pods": 110})
                 for i in range(2)]
        demands = [_demand(pkg, "default/whale", 4, 4000, prio=5, ts=1.0),
                   _demand(pkg, "default/starved", 4, 4000, prio=0, ts=2.0)]
        answers[pkg] = _engine(pkg).query_on(
            nodes, {}, demands, {"kind": "bump-gang", "gang": "default/starved", "tier": 9})
    for res in answers.values():
        assert "default/starved" in res["newly_placeable"]
        assert "default/whale" in res["no_longer_placeable"]
    assert answers[PORT]["moved"] == answers[REF]["moved"]


@pytest.mark.parametrize("rung", ["warp-speed", "topk"])
def test_rung_rejected(rung):
    """An unknown rung is refused by both packages. ``topk`` was refused by
    the port until it had the top-K scan; now both packages answer it, with
    the same plans."""
    nodes, node_req, demands = _inputs(PORT, 4, 2)
    if rung == "topk":
        got = _engine(PORT).query_on(nodes, node_req, demands, CFS["drain"], rung=rung)
        want = _engine(REF).query_on(*_inputs(REF, 4, 2), CFS["drain"], rung=rung)
        assert got["rung"] == "topk"
        for side in ("base", "whatif"):
            assert got[side]["plan_digest"] == want[side]["plan_digest"], side
        return
    with pytest.raises(ValueError, match="unknown what-if rung"):
        _engine(PORT).query_on(nodes, node_req, demands, CFS["drain"], rung=rung)
    nodes, node_req, demands = _inputs(REF, 4, 2)
    with pytest.raises(ValueError, match="unknown what-if rung"):
        _engine(REF).query_on(nodes, node_req, demands, CFS["drain"], rung=rung)


def test_whatif_engine_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _mod(PORT, "core.explain").WhatIfEngine()


# ---------------------------------------------------------------------------
# fork isolation
# ---------------------------------------------------------------------------


def _live_holder(n=12, g=6, seed=5):
    snapshot = _mod(PORT, "ops.snapshot")
    nodes, node_req, demands = _inputs(PORT, n, g, seed)
    packer = snapshot.DeltaSnapshotPacker()
    holder = _mod(PORT, "ops.device_state").DeviceStateHolder("cpu", label="live-t")
    snap = packer.pack(nodes, node_req, demands)
    return holder, holder.sync(snap), snap, (nodes, node_req, demands), packer


def test_fork_is_copy_on_write():
    """A scatter through a fork clones first: the live holder's tensors
    keep their values AND their storage; its generation and counters stay."""
    holder, live_args, snap, (nodes, node_req, demands), _ = _live_holder()
    names = ("_alloc", "_requested", "_group_req")
    values = {n: getattr(holder, n).clone() for n in names}
    ptrs = {n: getattr(holder, n).data_ptr() for n in names}
    stats0 = holder.stats()
    fork = holder.fork()
    assert fork.current_generation() == holder.current_generation()
    assert fork._requested.data_ptr() == ptrs["_requested"]  # shared until written
    cf_nodes, cf_req, cf_dem = _mod(PORT, "core.explain").apply_counterfactual(
        nodes, node_req, demands, {"kind": "cordon", "node": "n01"})
    cf_req = dict(cf_req, n03={"cpu": 9000, "pods": 2})
    cf_dem = [d if d.full_name != "default/gang-02" else
              _demand(PORT, d.full_name, 3, 7000, prio=d.priority, ts=d.creation_ts)
              for d in cf_dem]
    cf_snap = _mod(PORT, "ops.snapshot").ClusterSnapshot(
        cf_nodes, cf_req, cf_dem, schema=snap.schema)
    out = fork.apply_batch(cf_snap.device_args(), snap.device_args())
    assert fork.stats()["rows_scattered"] == 2
    assert not torch.equal(out[1], values["_requested"])
    assert not torch.equal(out[2], values["_group_req"])
    assert out[0].data_ptr() == ptrs["_alloc"]  # an unchanged buffer is still shared
    for n in names:
        assert torch.equal(getattr(holder, n), values[n]), n
        assert getattr(holder, n).data_ptr() == ptrs[n], n
    assert holder.stats() == stats0
    # a fork of the fork leaves the first fork as it was, too
    fork_vals = {n: getattr(fork, n).clone() for n in names}
    fork.fork().apply_batch(snap.device_args(), cf_snap.device_args())
    for n in names:
        assert torch.equal(getattr(fork, n), fork_vals[n]), n


def test_apply_batch_refused_on_live_holder():
    for pkg in PACKAGES:
        ds = _mod(pkg, "ops.device_state")
        holder = (ds.DeviceStateHolder("cpu", label="live-r") if pkg == PORT
                  else ds.DeviceStateHolder(label="live-r"))
        with pytest.raises(RuntimeError, match="fork-only"):
            holder.apply_batch((None,) * 7, (None,) * 7)


def test_storm_leaves_live_state_bit_identical():
    """Four what-if threads fork the live holder while it keeps syncing
    churn deltas and running batches: every live batch's digest equals a
    fork-free control pipeline's, and the live holder's generation,
    counters and tensors are its own syncs' alone."""
    snapshot = _mod(PORT, "ops.snapshot")
    oracle = _mod(PORT, "ops.oracle")
    audit = _mod(PORT, "utils.audit")
    nodes, node_req, demands = _inputs(PORT, 16, 8, seed=9)
    packer, control = snapshot.DeltaSnapshotPacker(), snapshot.DeltaSnapshotPacker()
    holder = _mod(PORT, "ops.device_state").DeviceStateHolder("cpu", label="live-storm")
    engine = _mod(PORT, "core.explain").WhatIfEngine(holder_source=lambda: holder,
                                                     device="cpu")
    cfs = [CFS["drain"], CFS["add-nodes"], CFS["remove-gang"]]
    errors = []

    def storm(w):
        try:
            for i in range(4):
                engine.query_on(nodes, node_req, demands, cfs[(w + i) % 3],
                                baseline_key="storm")
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=storm, args=(w,), daemon=True) for w in range(4)]
    for t in threads:
        t.start()
    live_req = dict(node_req)
    for tick in range(5):
        live_req["n08"] = {"cpu": 1000 + tick, "pods": 1}
        snap = packer.pack(nodes, live_req, demands)
        live_args = holder.sync(snap)
        host, _ = oracle.execute_batch_host(live_args, snap.progress_args(), device="cpu")
        csnap = control.pack(nodes, live_req, demands)
        chost, _ = oracle.execute_batch_host(csnap.device_args(), csnap.progress_args(),
                                             device="cpu")
        assert audit.plan_digest(host) == audit.plan_digest(chost), tick
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert engine.queries == 16
    assert holder.current_generation() == packer.generation
    stats = holder.stats()
    assert stats["keyframes"] == {"first": 1} and stats["deltas_applied"] == 4
    assert torch.equal(holder._requested, torch.from_numpy(snap.requested))


# ---------------------------------------------------------------------------
# the reference's remaining unit cases
# ---------------------------------------------------------------------------


def test_baseline_key_tracks_demand_churn():
    from dataclasses import replace

    for pkg in PACKAGES:
        key = _mod(pkg, "core.explain").baseline_inputs_key
        nodes = [_node(pkg, "n0")]
        demands = [_demand(pkg, "default/a", 2, 1000)]
        k0 = key(7, nodes, demands)
        assert key(7, nodes, demands) == k0
        assert key(8, nodes, demands) != k0
        assert key(7, nodes, demands + [_demand(pkg, "default/b", 1, 1)]) != k0
        assert key(7, nodes, [replace(demands[0], priority=5)]) != k0
    # the same inputs fingerprint the same in both packages
    assert _mod(PORT, "core.explain").baseline_inputs_key(
        3, [_node(PORT, "n0")], [_demand(PORT, "default/a", 2, 1000)]) == \
        _mod(REF, "core.explain").baseline_inputs_key(
            3, [_node(REF, "n0")], [_demand(REF, "default/a", 2, 1000)])


def test_backoff_spam_never_rolls_the_blame_record_out():
    recs = {}
    for pkg in PACKAGES:
        fr = _mod(pkg, "utils.trace").FlightRecorder(per_gang=4)
        fr.record("g", phase="pre_filter", verdict="denied", reason="real blame",
                  coalesce=True, feasible_nodes=2)
        for i in range(100):
            fr.record("g", phase="cycle", verdict="denied", reason="backing off",
                      coalesce=True, batch=i)
        fr.record("g", phase="cycle", verdict="denied", reason="new blame", coalesce=True)
        recs[pkg] = [{k: v for k, v in r.items() if k not in ("ts", "first_ts")}
                     for r in fr.snapshot("g")["g"]]
    port = recs[PORT]
    assert len(port) == 3 and port[0]["reason"] == "real blame"
    assert port[0]["feasible_nodes"] == 2
    assert port[1]["repeats"] == 100 and port[1]["batch"] == 99
    assert port == recs[REF]


class _FakeObservatory:
    def whatif(self, cf, rung="steady"):
        raise RuntimeError("boom")

    def explain(self, gang):
        raise KeyError(gang)


@pytest.mark.parametrize("params", [
    {"drain": "a", "cordon": "b"}, {"add_nodes": "zap"}, {"bump_gang": "d/g"},
])
def test_whatif_debug_view_grammar_errors_answer_400(params):
    out = {}
    for pkg in PACKAGES:
        exp = _mod(pkg, "core.explain")
        exp.set_active_observatory(_FakeObservatory())
        out[pkg] = exp.whatif_debug_view(params)
    assert out[PORT][1] == out[REF][1] == 400
    assert out[PORT] == out[REF]


def test_debug_views_bare_none_and_500_like_reference():
    for pkg in PACKAGES:
        exp = _mod(pkg, "core.explain")
        payload, status = exp.explain_debug_view(None)
        assert status == 200 and "gang" in payload["usage"]
        payload, status = exp.whatif_debug_view({})
        assert status == 200 and payload["kinds"] == list(exp.COUNTERFACTUAL_KINDS)
        exp.set_active_observatory(None)
        assert exp.explain_debug_view("d/g")[1] == 200
        assert "no observatory" in exp.whatif_debug_view({"drain": "n"})[0]["error"]
        exp.set_active_observatory(_FakeObservatory())
        assert exp.explain_debug_view("d/g") == ({"error": "KeyError: 'd/g'"}, 500)
        assert exp.whatif_debug_view({"drain": "n"}) == ({"error": "RuntimeError: boom"}, 500)
    port_usage = _mod(PORT, "core.explain").whatif_debug_view({})[0]["usage"]
    ref_usage = _mod(REF, "core.explain").whatif_debug_view({})[0]["usage"]
    assert port_usage.endswith("[&rung=steady|wavefront|cpu-ladder|topk]")
    assert ref_usage.endswith("[&rung=steady|wavefront|cpu-ladder|topk]")


# ---------------------------------------------------------------------------
# the live observatory: the README race through ScheduleOperation
# ---------------------------------------------------------------------------


def _race(pkg):
    """The README race: one node, two gangs of five one-cpu pods, ~7.1
    free cpus. The first gang places, the second is denied."""
    scen = _mod(pkg, "sim.scenarios")
    cm = _mod(pkg, "cache.pg_cache")
    errs = _mod(pkg, "utils.errors")
    _mod(pkg, "utils.trace").DEFAULT_FLIGHT_RECORDER.clear()
    cluster = _mod(pkg, "framework.cluster").ClusterState()
    nodes, groups, pods = scen.race_scenario()
    for n in nodes:
        cluster.add_node(n)
    sys_pod = scen.make_member_pods("sys", 1, {"cpu": "900m"})[0]
    sys_pod.metadata.labels = {}
    cluster.assume(sys_pod, nodes[0].metadata.name)
    cache = cm.PGStatusCache()
    for pg in groups:
        cache.set(pg.full_name(), cm.PodGroupMatchStatus(pg))
    kw = {"device": "cpu"} if pkg == PORT else {}
    op = _mod(pkg, "core.operation").ScheduleOperation(cache, cluster, scorer="oracle", **kw)
    outcomes = []
    for pod in (pods[pg.metadata.name][0] for pg in groups):
        try:
            op.pre_filter(pod)
            outcomes.append("ok")
        except errs.SchedulingError as e:
            outcomes.append(type(e).__name__)
    return op, [pg.full_name() for pg in groups], outcomes


def _get(addr, path):
    try:
        with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_live_observatory_explain_matches_reference_and_recorded_blame():
    exps, outcomes = {}, {}
    for pkg in PACKAGES:
        op, gangs, outcomes[pkg] = _race(pkg)
        obs = _mod(pkg, "core.explain").active_observatory()
        assert obs is not None and obs.operation is op
        exps[pkg] = {g: obs.explain(g) for g in gangs}
    assert outcomes[PORT] == outcomes[REF] == ["ok", "ResourceNotEnoughError"]
    placed, denied = sorted(exps[PORT])
    for gang in (placed, denied):
        ref, port = exps[REF][gang], exps[PORT][gang]
        for key in ("verdict", "deny_reason", "feasible_nodes", "need", "nodes_entry",
                    "excluded", "binding_lane", "assignment", "preemption"):
            assert port.get(key) == ref.get(key), (gang, key)
    port = exps[PORT][denied]
    assert port["verdict"] == "denied" and port["recorded_agrees"] is True
    assert port["recorded"]["reason"] == port["deny_reason"]
    assert exps[PORT][placed]["verdict"] == "placed"
    unknown = _mod(PORT, "core.explain").active_observatory().explain("default/ghost")
    assert unknown["error"] == "unknown gang 'default/ghost'"


def test_live_observatory_routes_served_by_the_port():
    metrics = _mod(PORT, "utils.metrics")
    op, gangs, _ = _race(PORT)
    srv = metrics.serve_metrics(port=0)
    try:
        addr = srv.server_address
        status, index = _get(addr, "/debug/")
        assert status == 200
        assert {"/debug/explain", "/debug/whatif"} <= set(index["endpoints"])
        status, body = _get(addr, f"/debug/explain?gang={gangs[1]}")
        assert status == 200 and body["verdict"] == "denied" and body["recorded_agrees"]
        node = op.cluster.list_nodes()[0].metadata.name
        status, body = _get(addr, "/debug/whatif?add_nodes=1&node_cpu=8&rung=cpu-ladder")
        assert status == 200 and body["rung"] == "cpu-ladder"
        assert gangs[1] in body["newly_placeable"]
        status, body = _get(addr, f"/debug/whatif?drain={node}")
        assert status == 200 and body["whatif"]["placed"] == 0
        assert body["baseline_cached"] is False
        status, body = _get(addr, f"/debug/whatif?cordon={node}")
        assert status == 200 and body["baseline_cached"] is True
        assert _get(addr, "/debug/whatif?drain=ghost")[0] == 400
        assert _get(addr, "/debug/whatif?drain=a&cordon=b")[0] == 400
        status, body = _get(addr, f"/debug/whatif?drain={node}&rung=topk")
        assert status == 200 and body["rung"] == "topk" and body["whatif"]["placed"] == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_serial_operation_registers_no_observatory():
    exp = _mod(PORT, "core.explain")
    _race(PORT)
    assert exp.active_observatory() is not None
    _mod(PORT, "core.operation").ScheduleOperation(
        _mod(PORT, "cache.pg_cache").PGStatusCache(),
        _mod(PORT, "framework.cluster").ClusterState(), scorer="serial", device="cpu")
    assert exp.active_observatory() is None
