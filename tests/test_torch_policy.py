"""The port's policy engine and policy scan (batch_scheduler_tpu_torch.policy,
ops.oracle.assign_gangs_policy, ops.assign_scan.assign_gangs_policy_cuda,
the packer's policy columns, the holder's resident node columns, the
scorer's policy batches and their audit records) against the JAX package
on the CPU. Inputs are made from numpy seeds and fed to both packages;
every output is an integer or a bool, so every comparison is exact
(tolerance zero). The ``cuda`` cases hold the composite-key kernel
against its plain version on the card."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

try:
    from batch_scheduler_tpu.ops import oracle as jax_oracle
    from batch_scheduler_tpu.policy import engine as jax_engine
    from batch_scheduler_tpu.policy import terms as jax_terms
except ImportError:  # a GPU machine without JAX runs only the `cuda` tests here
    jax_oracle = jax_engine = jax_terms = None
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.assign_scan import (
    assign_gangs_policy_cuda,
    kernel_plan,
)
from batch_scheduler_tpu_torch.policy import engine as port_engine
from batch_scheduler_tpu_torch.policy import terms as port_terms

PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
ALL_TERMS = ("affinity", "anti-affinity", "spread")
WEIGHTS = (32, 8, 3)
TERM_SETS = [("affinity",), ("anti-affinity",), ("spread",), ALL_TERMS]
# the H100's opt-in shared memory a block less the serial kernel's static
# shared memory (tests/test_torch_assign_cluster.py's figure)
H100_SHARED_BUDGET = 232448 - (4 * (128 + 2 * 16 * 128) + 2 * 8 + 4 * 4)


@pytest.fixture(autouse=True)
def _restore_active_engines():
    """An enabled PolicyEngine registers itself process-wide in each
    package; put both registrations back after every test."""
    if jax_engine is None:
        yield
        return
    saved = (jax_engine._active[0], port_engine._active[0])
    yield
    jax_engine._active[0], port_engine._active[0] = saved


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _vocab():
    return [port_terms.label_hash(k, v) for k, v in
            (("pool", "p0"), ("pool", "p1"), ("pool", "p2"), ("team", "red"),
             ("team", "blue"), ("zone", "z3"))]


def _policy_cols(rng, n, g, dense=True):
    """(prio, aff, anti, gang_dom, node_hash, node_dom) int32: label lanes
    from a small vocabulary (so affinity matches and misses), some spread
    domains outside [0, 16) (the clamp), domain counts on half the
    gangs."""
    vocab = np.array([0] + _vocab(), np.int64)
    node_hash = vocab[rng.integers(0, len(vocab), size=(n, 4))].astype(np.int32)
    node_dom = rng.integers(0, 16, size=n).astype(np.int32)
    node_dom[rng.random(n) < 0.1] = 17
    node_dom[rng.random(n) < 0.05] = -1
    aff = np.where(rng.random(g) < 0.5, vocab[rng.integers(1, len(vocab), size=g)], 0)
    anti = np.where(rng.random(g) < 0.3, vocab[rng.integers(1, len(vocab), size=g)], 0)
    gang_dom = rng.integers(0, 5, size=(g, 16)) * (rng.random((g, 1)) < 0.5)
    prio = rng.integers(0, 3, size=g)
    if not dense:
        aff[:] = anti[:] = 0
        gang_dom[:] = 0
    return tuple(np.asarray(c, np.int32) for c in
                 (prio, aff, anti, gang_dom, node_hash, node_dom))


def _scan_inputs(seed, per_group, n=32, g=12, r=3):
    """A scan's inputs with capacities from 0 to past 127 (a few roomy
    nodes), so the penalties move nodes between bins and clip at 127."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 60, size=(n, r)).astype(np.int32)
    left[rng.random(n) < 0.15] = 4000
    req = rng.integers(1, 5, size=(g, r)).astype(np.int32)
    req[0, 1] = 0  # a lane the gang does not request
    rem = rng.integers(1, 14, size=g).astype(np.int32)
    rem[1] = 0
    order = rng.permutation(g).astype(np.int32)
    mask = rng.random((g, n)) < 0.8 if per_group else np.ones((1, n), bool)
    return (left, req, rem, mask, order), _policy_cols(rng, n, g)


# -- label hashing and the terms ---------------------------------------------

@pytest.mark.parametrize("labels,spread_key", [
    ({}, "zone"),
    ({"zone": "z1"}, "zone"),
    ({"zone": "z1", "pool": "gpu", "team": "red", "rack": "r7", "extra": "x"}, "zone"),
    ({"a": "1", "b": "2"}, "rack"),
    ({"zone": ""}, "zone"),
])
def test_label_hash_and_node_policy_row_match_reference(labels, spread_key):
    for k, v in list(labels.items()) + [("zone", "z0"), ("", "")]:
        assert port_terms.label_hash(k, v) == jax_terms.label_hash(k, v)
    row, dom, trunc = port_terms.node_policy_row(labels, spread_key)
    jrow, jdom, jtrunc = jax_terms.node_policy_row(labels, spread_key)
    assert row.dtype == jrow.dtype and np.array_equal(row, jrow)
    assert (dom, trunc) == (jdom, jtrunc)


@pytest.mark.parametrize("raw", ["pool:gpu", "pool=gpu", "zone:a:b", "nope", ":x", "k:", ""])
def test_parse_label_ref_matches_reference(raw):
    assert port_terms.parse_label_ref(raw) == jax_terms.parse_label_ref(raw)


@pytest.mark.parametrize("terms", TERM_SETS + [("spread", "bogus", "preempt"), ()],
                         ids=lambda t: "+".join(t) or "none")
def test_compose_terms_and_keep_dense_match_reference(terms):
    rng = np.random.default_rng(3)
    prio, aff, anti, gang_dom, node_hash, node_dom = _policy_cols(rng, 40, 10)
    weights = (200, 50, 2)
    jfn = jax_terms.compose_terms(terms, weights)
    pfn = port_terms.compose_terms(terms, weights)
    th, tdom = _t(node_hash, node_dom)
    for gi in range(10):
        jpen, jkeep = jfn(aff[gi], anti[gi], gang_dom[gi], node_hash, node_dom)
        ppen, pkeep = pfn(*_t(aff[gi], anti[gi], gang_dom[gi]), th, tdom)
        np.testing.assert_array_equal(ppen.numpy(), np.asarray(jpen))
        np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
    jdense = np.asarray(jax_terms.compose_keep_dense(terms, anti, node_hash))
    pdense = port_terms.compose_keep_dense(terms, *_t(anti, node_hash)).numpy()
    assert pdense.dtype == np.int32 and np.array_equal(pdense, jdense)


# -- the policy scan ---------------------------------------------------------

@pytest.mark.parametrize("weights", [WEIGHTS, (200, 50, 2)], ids=["default", "heavy"])
@pytest.mark.parametrize("terms", TERM_SETS, ids=lambda t: "+".join(t))
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per_group"])
def test_assign_gangs_policy_matches_reference(per_group, terms, weights):
    """The plain policy scan and the kernel's wrapper on CPU tensors
    against the reference's assign_gangs_policy, on broadcast and
    per-group masks, with each term alone and all three; the heavy
    weights push keys past 127 (the clip)."""
    for seed in range(2):
        args, cols = _scan_inputs(seed + (10 if per_group else 0), per_group)
        want = jax_oracle.assign_gangs_policy(*args, *cols, policy_terms=terms,
                                              policy_weights=weights)
        plain = port_oracle.assign_gangs_policy(*_t(*args), *_t(*cols), terms, weights)
        wrapped = assign_gangs_policy_cuda(*_t(*args), *_t(*cols), terms, weights)
        for name, a, b, c in zip(("alloc", "placed", "left"), want, plain, wrapped):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
            assert torch.equal(b, c), name


@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per_group"])
def test_zero_policy_identity(per_group):
    """With every term on and all-zero columns, or with real columns and
    no term, the policy scan equals the base scan (the reference's
    zero-policy identity) in both packages."""
    args, cols = _scan_inputs(5, per_group)
    zero = _policy_cols(np.random.default_rng(0), 32, 12, dense=False)
    zero = zero[:4] + (np.zeros_like(zero[4]), np.zeros_like(zero[5]))
    base = port_oracle.assign_gangs(*_t(*args))
    jbase = jax_oracle.assign_gangs(*args)
    for c, terms in ((zero, ALL_TERMS), (cols, ())):
        got = assign_gangs_policy_cuda(*_t(*args), *_t(*c), terms, WEIGHTS)
        for a, b, j in zip(got, base, jbase):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), np.asarray(j))


def _batch(seed, per_group):
    (left, req, rem, mask, order), cols = _scan_inputs(seed, per_group, n=32, g=16)
    alloc = left + 10
    requested = np.full_like(alloc, 10)
    g = req.shape[0]
    batch_args = (alloc, requested, req, rem, mask, np.ones(g, bool), order)
    rng = np.random.default_rng(seed)
    progress = (rem + 1, rng.integers(0, 2, g).astype(np.int32), np.zeros(g, np.int32),
                rng.random(g) < 0.2, rng.permutation(g).astype(np.int32))
    return batch_args, progress, cols


@pytest.mark.parametrize("wave", [None, "8"], ids=["serial", "wave8"])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per_group"])
def test_policy_batch_host_dicts_match_reference(monkeypatch, per_group, wave):
    """execute_batch_host(policy=...) in both packages: equal host dicts and
    capacity / score rows (the head folds anti-affinity into capacity);
    with BST_SCAN_WAVE=8 as well, the batch still runs the policy scan and
    its telemetry says so (wave width 0, scan_policy)."""
    if wave is None:
        monkeypatch.delenv("BST_SCAN_WAVE", raising=False)
    else:
        monkeypatch.setenv("BST_SCAN_WAVE", wave)
    batch_args, progress, cols = _batch(7 + per_group, per_group)
    policy = (cols, ALL_TERMS, WEIGHTS)
    want, want_dev = jax_oracle.execute_batch_host(batch_args, progress, policy=policy)
    got, got_dev = port_oracle.execute_batch_host(batch_args, progress, device="cpu",
                                                  policy=policy)
    for k in want:
        if k != "telemetry":
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for k in ("capacity", "scores"):
        np.testing.assert_array_equal(got_dev[k].numpy(), np.asarray(want_dev[k]), err_msg=k)
    assert want["telemetry"]["scan_policy"] is True
    assert got["telemetry"]["scan_policy"] is True and got["telemetry"]["wave_width"] == 0
    assert "waves_per_batch" not in got["telemetry"]
    # the policy moved the plan: the base batch differs on these inputs
    base, _ = port_oracle.execute_batch_host(batch_args, progress, device="cpu")
    assert base["telemetry"]["scan_policy"] is False
    assert not all(np.array_equal(base[k], got[k])
                   for k in ("assignment_nodes", "assignment_counts", "placed"))


# -- the engine's configuration ----------------------------------------------

ENVS = [
    {"BST_POLICY": "affinity, bogus-term ,preempt"},
    {"BST_POLICY": "off"},
    {"BST_POLICY": ""},
    {"BST_POLICY": "all", "BST_POLICY_AFFINITY_WEIGHT": "not-a-number"},
    {"BST_POLICY": "spread,anti-affinity", "BST_POLICY_SPREAD_WEIGHT": "-4",
     "BST_POLICY_SPREAD_CAP": "7", "BST_POLICY_SPREAD_KEY": " rack ",
     "BST_POLICY_PROTECT_RUNNING": "yes"},
    {"BST_POLICY": "affinity,anti-affinity,spread,preempt", "BST_POLICY_SPREAD_KEY": " "},
]
POLICY_KNOBS = ("BST_POLICY", "BST_POLICY_AFFINITY_WEIGHT", "BST_POLICY_SPREAD_WEIGHT",
                "BST_POLICY_SPREAD_CAP", "BST_POLICY_SPREAD_KEY", "BST_POLICY_PROTECT_RUNNING")


@pytest.mark.parametrize("env", ENVS, ids=lambda e: e["BST_POLICY"] or "empty")
def test_policy_config_from_env_matches_reference(monkeypatch, env):
    """The parse guard (unknown terms dropped, bad weights kept at their
    default, never an exception) and the fingerprint, key for key."""
    for k in POLICY_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = port_engine.PolicyConfig.from_env(), jax_engine.PolicyConfig.from_env()
    assert (port.terms, port.weights, port.spread_node_key, port.protect_running) == (
        ref.terms, ref.weights, ref.spread_node_key, ref.protect_running)
    assert (port.enabled, port.preemption, port.scoring_terms) == (
        ref.enabled, ref.preemption, ref.scoring_terms)
    assert port.fingerprint() == ref.fingerprint()


def test_engine_registers_and_fingerprints_like_reference():
    from batch_scheduler_tpu_torch.utils.audit import config_fingerprint

    cfg = dict(terms=("affinity",), affinity_weight=64)
    port = port_engine.PolicyEngine(port_engine.PolicyConfig(**cfg))
    jax_engine.PolicyEngine(jax_engine.PolicyConfig(**cfg))
    assert port_engine.active_engine() is port
    assert port_engine.active_fingerprint() == jax_engine.active_fingerprint()
    assert config_fingerprint("cpu")["policy"] == port.config.fingerprint()
    port.note_batch()
    port.note_plan(True)
    port.note_plan(False)
    assert (port.batches_scored, port.preempt_plans, port.preempt_no_plan) == (1, 1, 1)
    port_engine.PolicyEngine(port_engine.PolicyConfig())  # disabled: not registered
    assert port_engine.active_engine() is port


# -- packing, residency and the demand projection -----------------------------

def _nodes(pkg, n=6):
    scen = importlib.import_module(f"{pkg}.sim.scenarios")
    return [scen.make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"},
                               labels={"zone": f"z{i % 3}", "team": "blue",
                                       **({"pool": "gpu"} if i % 2 else {})})
            for i in range(n)]


def _groups(pkg):
    snap_mod = importlib.import_module(f"{pkg}.ops.snapshot")
    blue = jax_terms.label_hash("team", "blue")
    gpu = jax_terms.label_hash("pool", "gpu")
    return [
        snap_mod.GroupDemand(full_name="default/g0", min_member=3,
                             member_request={"cpu": 1000}, affinity_hash=gpu,
                             spread=True, placed_nodes={"n0": 1, "n1": 2}, priority=7),
        snap_mod.GroupDemand(full_name="default/g1", min_member=2,
                             member_request={"cpu": 2000}, anti_hash=blue),
        snap_mod.GroupDemand(full_name="default/g2", min_member=4,
                             member_request={"cpu": 500}, spread=True,
                             placed_nodes={"n5": 3, "gone": 1}),
    ]


def _packers(terms=ALL_TERMS):
    out = []
    for pkg, eng in zip(PACKAGES, (jax_engine, port_engine)):
        snap_mod = importlib.import_module(f"{pkg}.ops.snapshot")
        engine = eng.PolicyEngine(eng.PolicyConfig(terms=terms, spread_node_key="zone"))
        out.append(snap_mod.DeltaSnapshotPacker(policy_engine=engine))
    return out


def _cols_equal(a, b):
    assert len(a) == len(b) == 6
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), i


def test_packer_policy_columns_and_label_churn_match_reference():
    """Both packers pack the same columns; unchanged labels rewrite no node
    policy row, a label change rewrites exactly that row (the delta's
    policy_node_rows), and an enabled engine turns off the lite scan and
    the event fold. The port's holder scatters the rewritten row into its
    resident node columns and they equal the host columns."""
    from batch_scheduler_tpu_torch.ops.device_state import DeviceStateHolder

    packers = _packers()
    worlds = [(_nodes(pkg), _groups(pkg)) for pkg in PACKAGES]
    holder = DeviceStateHolder("cpu")

    def pack_both(label):
        snaps = [p.pack(nodes, {}, groups) for p, (nodes, groups) in zip(packers, worlds)]
        _cols_equal(snaps[0].policy_cols, snaps[1].policy_cols)
        for a, b in zip(snaps[0].device_args(), snaps[1].device_args()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=label)
        assert snaps[1].policy_payload()[1:] == (ALL_TERMS, WEIGHTS)
        holder.sync(snaps[1])
        resident = holder.sync_policy_cols(snaps[1])
        _cols_equal([c.numpy() if hasattr(c, "numpy") else c for c in resident],
                    snaps[1].policy_cols)
        return snaps

    snaps = pack_both("first")
    assert snaps[1].delta.kind == "keyframe"
    snaps = pack_both("unchanged")
    assert [p.policy_rows_rewritten for p in packers] == [0, 0]
    assert snaps[1].delta.kind == "delta" and len(snaps[1].delta.policy_node_rows) == 0
    assert packers[1].stats()["lite"] is False and packers[1].lite_packs == 0
    for nodes, _ in worlds:
        nodes[2].metadata.labels["zone"] = "z9"
    before = holder.rows_scattered
    snaps = pack_both("label churn")
    assert [p.policy_rows_rewritten for p in packers] == [1, 1]
    assert snaps[1].delta.policy_node_rows.tolist() == snaps[0].delta.policy_node_rows.tolist() \
        == [2]
    assert holder.rows_scattered - before == 1
    assert packers[1].pack_fold([], []) is None  # no lite state: the fold is off


def test_preemption_only_config_keeps_base_rungs():
    packer = _packers(("preempt",))[1]
    snap = packer.pack(_nodes(PACKAGES[1], 2), {}, _groups(PACKAGES[1])[:1])
    assert snap.policy_cols is not None and snap.policy_payload() is None


def _status(pkg, labels, matched=()):
    scen = importlib.import_module(f"{pkg}.sim.scenarios")
    cm = importlib.import_module(f"{pkg}.cache.pg_cache")
    pg = scen.make_sim_group("g", 3, creation_ts=2.0)
    pgs = cm.PodGroupMatchStatus(pg)
    pgs.pod = scen.make_member_pods("g", 1, {"cpu": "2"}, priority=4)[0]
    pgs.pod.metadata.labels.update(labels)
    for i, node in enumerate(matched):
        pgs.matched_pod_nodes.set(f"uid-{i}", cm.PodNodePair(f"default/g-{i}", node), 60.0)
    return pgs


@pytest.mark.parametrize("labels", [
    {},
    {"policy.batch.scheduler.tpu/affinity": "pool:gpu"},
    {"policy.batch.scheduler.tpu/anti-affinity": "team=red",
     "policy.batch.scheduler.tpu/spread": "1"},
    {"policy.batch.scheduler.tpu/affinity": "garbage",
     "policy.batch.scheduler.tpu/spread": ""},
    {"policy.batch.scheduler.tpu/spread": "yes"},
], ids=["none", "affinity", "anti+spread", "unparseable", "spread"])
def test_demand_from_status_policy_fields_match_reference(labels):
    from batch_scheduler_tpu.core.oracle_scorer import demand_from_status as jax_demand
    from batch_scheduler_tpu.utils import labels as jax_labels
    from batch_scheduler_tpu_torch.core.oracle_scorer import demand_from_status
    from batch_scheduler_tpu_torch.utils import labels as port_labels

    for name in ("POLICY_AFFINITY_LABEL", "POLICY_ANTI_AFFINITY_LABEL", "POLICY_SPREAD_LABEL"):
        assert getattr(port_labels, name) == getattr(jax_labels, name)
    matched = ("n1", "n1", "n4")
    want = jax_demand("default/g", _status(PACKAGES[0], labels, matched))
    got = demand_from_status("default/g", _status(PACKAGES[1], labels, matched))
    for f in ("affinity_hash", "anti_hash", "spread", "placed_nodes", "priority",
              "matched", "member_request"):
        assert getattr(got, f) == getattr(want, f), f


# -- the kernel's plan -------------------------------------------------------

@pytest.mark.parametrize("n,cluster_max", [(8, 16), (8192, 16), (8192, 8), (262144, 16),
                                           (2**21, 16), (2**21, 8)],
                         ids=lambda v: str(v))
def test_policy_kernel_plan(n, cluster_max):
    """The policy variant's plan takes every bucket the base plan takes
    (past 2^20 nodes its slabs), with room for the 18 policy-row stagers,
    two policy rows, and the node columns beside a shared leftover."""
    r = 5
    base = kernel_plan(n, r, cluster_max, H100_SHARED_BUDGET)
    plan = kernel_plan(n, r, cluster_max, H100_SHARED_BUDGET, policy=True)
    assert (plan.cluster_blocks, plan.block_nodes, plan.per_thread) == (
        base.cluster_blocks, base.block_nodes, base.per_thread)
    assert plan.threads >= 3 * r + 18 and plan.threads % 32 == 0
    fixed = 4 * (8 * r + 40 + 8 * plan.threads)
    if plan.leftover == "shared":
        assert plan.shared_bytes == fixed + 4 * (r + 5) * plan.per_thread * plan.threads
        assert plan.shared_bytes <= H100_SHARED_BUDGET and plan.scratch_ints == 0
    else:
        assert plan.shared_bytes == fixed
        assert plan.scratch_ints == plan.cluster_blocks * r * plan.per_thread * plan.threads
    if n == 8192:
        assert plan.leftover == "shared"
    if n >= 2**21:
        assert plan.per_thread > 64 and plan.leftover == "global"


def test_policy_weights_fold_the_terms():
    from batch_scheduler_tpu_torch.ops.assign_scan import _policy_weights

    assert _policy_weights(ALL_TERMS, WEIGHTS) == (1, 32, 8, 3)
    assert _policy_weights(("spread",), WEIGHTS) == (0, 0, 8, 3)
    assert _policy_weights(("affinity", "affinity", "bogus"), (2**30, 1, 1)) == (
        0, -(2**31), 0, 1)
    with pytest.raises(ValueError, match="outside int32"):
        _policy_weights(ALL_TERMS, (2**31, 0, 0))


# -- the kernel on the card --------------------------------------------------

def _cuda(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)


def _card_cases(n, g, seed):
    rng = np.random.default_rng(seed)
    r = 5
    for per_group in (False, True):
        left = rng.integers(0, 3000, size=(n, r)).astype(np.int32)
        left[rng.random(n) < 0.2] = 10**6
        req = rng.integers(1, 40, size=(g, r)).astype(np.int32)
        rem = rng.integers(1, 300, size=g).astype(np.int32)
        order = rng.permutation(g).astype(np.int32)
        mask = rng.random((g if per_group else 1, n)) < 0.8
        yield per_group, (left, req, rem, mask, order), _policy_cols(rng, n, g)


@pytest.mark.cuda
@pytest.mark.parametrize("n,g", [(5000, 256), (2**21, 16)], ids=["5000", "2^21"])
def test_policy_kernel_matches_plain_on_card(n, g):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for per_group, args, cols in _card_cases(n, g, 31):
        for terms in (ALL_TERMS, ("affinity", "spread")):
            got = assign_gangs_policy_cuda(*_cuda(*args), *_cuda(*cols), terms, WEIGHTS)
            want = port_oracle.assign_gangs_policy(*_cuda(*args), *_cuda(*cols), terms,
                                                   WEIGHTS)
            torch.cuda.synchronize()
            for name, a, b in zip(("alloc", "placed", "left"), got, want):
                assert torch.equal(a, b), (per_group, terms, name)


@pytest.mark.cuda
def test_policy_kernel_zero_policy_identity_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda

    for per_group, args, cols in _card_cases(5000, 256, 32):
        zero = tuple(np.zeros_like(c) for c in cols)
        base = assign_gangs_cuda(*_cuda(*args))
        for c, terms in ((zero, ALL_TERMS), (cols, ())):
            got = assign_gangs_policy_cuda(*_cuda(*args), *_cuda(*c), terms, WEIGHTS)
            torch.cuda.synchronize()
            for a, b in zip(got, base):
                assert torch.equal(a, b), per_group


# -- a policy scorer's churn script and its audit rings ----------------------

def _policy_world(pkg):
    """12 labelled nodes (one with five labels: a truncated lane, one with
    none) and 6 gangs whose representative pods carry the policy labels:
    affinity to a pool, anti-affinity against a team, spread."""
    scen = importlib.import_module(f"{pkg}.sim.scenarios")
    cm = importlib.import_module(f"{pkg}.cache.pg_cache")
    cluster = importlib.import_module(f"{pkg}.framework.cluster").ClusterState()
    for i in range(12):
        labels = {"zone": f"z{i % 4}", "pool": f"p{i % 3}",
                  "team": "red" if i % 2 else "blue"}
        if i == 0:
            labels.update(rack="r0", extra="x")
        cluster.add_node(scen.make_sim_node(
            f"n{i:02d}", {"cpu": "16", "memory": "64Gi", "pods": "110"},
            labels=labels if i != 11 else {}))
    cache = cm.PGStatusCache()
    policy_labels = [
        {"policy.batch.scheduler.tpu/affinity": "pool:p1"},
        {"policy.batch.scheduler.tpu/anti-affinity": "team:red"},
        {"policy.batch.scheduler.tpu/spread": "1"},
        {"policy.batch.scheduler.tpu/spread": "1",
         "policy.batch.scheduler.tpu/affinity": "zone=z2"},
        {},
        {"policy.batch.scheduler.tpu/anti-affinity": "pool:p0"},
    ]
    for j, labels in enumerate(policy_labels):
        pg = scen.make_sim_group(f"gang-{j}", 3 + j % 3, creation_ts=float(j % 3))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang-{j}", 1, {"cpu": "3"}, priority=j % 2)[0]
        pgs.pod.metadata.labels.update(labels)
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 30, {"cpu": "1", "memory": "1Gi"})
    return cm, cluster, cache, pods


def _policy_script(cm, cluster, cache, pods, scorer):
    """Yields after each round: node churn, gang progress marks, matched
    members of the spread gangs (their domain occupancy), and two node
    label changes (policy node rows rewritten and scattered)."""
    names = sorted(cache.snapshot())
    yield
    for r in range(8):
        for k in range(3):
            cluster.assume(pods[3 * r + k], f"n{(5 * r + k) % 12:02d}")
        if r:
            cluster.forget(pods[3 * (r - 1)].metadata.uid)
        name = names[r % len(names)]
        cache.get(name).pod_group.status.scheduled += 1
        scorer.mark_dirty(group=name)
        if r in (2, 5):
            for spread in ("default/gang-2", "default/gang-3"):
                pgs = cache.get(spread)
                pgs.matched_pod_nodes.set(f"{spread}-{r}", cm.PodNodePair(
                    f"{spread}-m{r}", f"n{(r * 7) % 12:02d}"), 600.0)
                scorer.mark_dirty(group=spread)
        if r in (3, 6):
            node = cluster.list_nodes()[r]
            node.metadata.labels["zone"] = f"z{9 - r}"
            cluster.update_node(node)
        yield


def _drive_policy(pkg, directory=None, fmt="array"):
    """The policy script through ``pkg``'s OracleScorer with every scoring
    term and the default weights, optionally into an audit ring: (scorer,
    plan digests a refresh)."""
    scorer_mod = importlib.import_module(f"{pkg}.core.oracle_scorer")
    audit = importlib.import_module(f"{pkg}.utils.audit")
    eng = importlib.import_module(f"{pkg}.policy.engine")
    engine = eng.PolicyEngine(eng.PolicyConfig(terms=ALL_TERMS + ("preempt",)))
    log = audit.AuditLog(directory, fmt=fmt, keyframe_every=4) if directory else None
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    scorer = scorer_mod.OracleScorer(audit_log=log, policy_engine=engine, **kw)
    world = _policy_world(pkg)
    digests = []
    for _ in _policy_script(*world, scorer):
        scorer.refresh(world[1], world[2])
        digests.append(audit.plan_digest(scorer._state.result))
    if log is not None:
        assert log.flush()
        log.stop()
    return scorer, digests


def test_policy_scorer_digest_sequences_match_reference():
    """The same policy churn script through both packages' scorers gives
    equal plan_digest sequences; every port batch ran the policy scan on
    the resident node columns, which followed the label changes."""
    (ref, ref_digests), (port, digests) = (_drive_policy(pkg) for pkg in PACKAGES)
    assert digests == ref_digests and len(digests) == 9
    assert port.last_telemetry["scan_policy"] is True
    assert port.policy_engine.batches_scored == 9
    stats = port.stats()
    assert stats["packer"]["lite_packs"] == 0 and stats["packer"]["fold_packs"] == 0
    assert "folded" not in stats["fold_outcomes"]
    assert stats["device_state"]["policy_resident"]
    # the spread gangs' domain counts reached the columns
    gang_dom = port.snapshot.policy_cols[3]
    assert gang_dom[port.snapshot.group_index("default/gang-2")].sum() == 2


@pytest.fixture(scope="module")
def policy_rings(tmp_path_factory):
    out = {}
    for pkg in PACKAGES:
        for fmt in ("array", "v2"):
            d = str(tmp_path_factory.mktemp(f"policy-{pkg}-{fmt}"))
            saved = (jax_engine._active[0], port_engine._active[0])
            _drive_policy(pkg, d, fmt)
            jax_engine._active[0], port_engine._active[0] = saved
            out[pkg, fmt] = d
    return out


@pytest.mark.parametrize("fmt", ["array", "v2"])
def test_policy_ring_records_match_reference(policy_rings, fmt):
    """Both packages record the same policy ring: digests, record kinds,
    the policy terms and weights, and the packed policy columns."""
    from batch_scheduler_tpu.utils import audit as jax_audit
    from batch_scheduler_tpu_torch.utils import audit as port_audit

    ref, port = (mod.AuditReader(policy_rings[pkg, fmt]).batches()
                 for pkg, mod in zip(PACKAGES, (jax_audit, port_audit)))
    assert not ref[1] and not port[1] and len(port[0]) == len(ref[0]) == 9
    for a, b in zip(ref[0], port[0]):
        assert (b["plan_digest"], b["keyframe"], b["policy"]) == (
            a["plan_digest"], a["keyframe"], a["policy"])
        assert b["policy_args"][1:] == (ALL_TERMS, WEIGHTS)
        _cols_equal(a["policy_args"][0], b["policy_args"][0])


@pytest.mark.parametrize("fmt", ["array", "v2"])
def test_reference_policy_ring_replays_in_port(policy_rings, fmt):
    """A policy ring the JAX package writes replays identical in the port,
    on the plain policy scan (cpu-ladder) and on steady (the kernel's
    wrapper; its plain version on the CPU)."""
    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record
    from batch_scheduler_tpu_torch.utils.audit import AuditReader

    batches, skipped = AuditReader(policy_rings[PACKAGES[0], fmt]).batches()
    assert len(batches) == 9 and not skipped
    for rec in batches:
        for rung in ("cpu-ladder", "steady"):
            rep = replay_audit_record(rec, against=rung, device="cpu")
            assert rep["identical"], (rung, rec["seq"], rep.get("blame"))
            assert rep["executed_rung"]["scan_policy"] is True


@pytest.mark.parametrize("fmt", ["array", "v2"])
def test_port_policy_ring_replays_in_reference(policy_rings, fmt):
    from batch_scheduler_tpu.core.oracle_scorer import replay_audit_record as jax_replay
    from batch_scheduler_tpu.utils.audit import AuditReader as JaxReader

    batches, skipped = JaxReader(policy_rings[PACKAGES[1], fmt]).batches()
    assert len(batches) == 9 and not skipped
    for rec in batches:
        rep = jax_replay(rec, against="cpu-ladder")
        assert rep["identical"] and rep["executed_rung"]["scan_policy"], rec["seq"]


def test_policy_identity_audit_verifies_the_composite(tmp_path):
    """The identity audit of a policy batch re-runs the policy scan: no
    mismatch (it would be one if the verification ran the base scan on
    these inputs)."""
    from batch_scheduler_tpu_torch.core.oracle_scorer import OracleScorer

    engine = port_engine.PolicyEngine(port_engine.PolicyConfig(terms=ALL_TERMS))
    scorer = OracleScorer(device="cpu", identity_audit_every=1, policy_engine=engine)
    cm, cluster, cache, pods = _policy_world(PACKAGES[1])
    scorer.refresh(cluster, cache)
    assert scorer._identity.drain(60.0)
    assert scorer.stats()["audit"]["identity_audits"] == 1
    assert scorer.stats()["audit"]["identity_mismatches"] == 0
