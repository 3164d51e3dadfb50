"""The port's hierarchical top-K scan against the JAX reference on the CPU:
the plain ``assign_gangs_topk`` equals the reference's (outputs and the
three per-wave stat series) on every branch (mega, speculative, replay,
dense-column demotion) in both mask modes, and the serial scan; the XL
scenario's operands and ``topk_bucket`` equal the reference's; the
``BST_SCAN_TOPK`` knob, the batch's host dict and telemetry, the ``topk``
replay and what-if rungs give the reference's answers; and, on a card, the
CUDA kernel against the plain version. Every output is an integer, so
every comparison is exact (tolerance zero)."""

import numpy as np
import pytest
import torch

try:
    from batch_scheduler_tpu.ops import bucketing as jax_bucketing
    from batch_scheduler_tpu.ops import oracle as jax_oracle
    from batch_scheduler_tpu.sim import scenarios as jax_scenarios
except ImportError:  # a GPU machine without JAX runs only the `cuda` test here
    jax_bucketing = jax_oracle = jax_scenarios = None
from batch_scheduler_tpu_torch.ops import bucketing as port_bucketing
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_topk_cuda
from batch_scheduler_tpu_torch.sim import scenarios as port_scenarios


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# -- scan fixtures (tests/test_topk_scan.py's cases) --------------------------

def _scan_case(n=48, g=14, r=3, per_group=False, uniform=False, seed=7):
    """The reference test's inputs; ``uniform`` with ``per_group`` gives
    every gang the same mask row too."""
    rng = np.random.RandomState(seed)
    left = rng.randint(0, 120, size=(n, r)).astype(np.int32)
    if uniform:
        req = np.tile(rng.randint(1, 6, size=(1, r)), (g, 1)).astype(np.int32)
    else:
        req = rng.randint(0, 6, size=(g, r)).astype(np.int32)
    rem = rng.randint(0, 30, size=(g,)).astype(np.int32)
    mask = rng.randint(0, 2, size=(g, n)) > 0 if per_group else np.ones((1, n), bool)
    if per_group and uniform:
        mask[:] = mask[0]
    return left, req, rem, mask, rng.permutation(g).astype(np.int32)


def _tight_fit():
    """One member a node: a 10-member gang outruns K=4 candidates while the
    pooled capacity says it fits, so it demotes to the dense column."""
    n, g, r = 40, 3, 2
    return (np.full((n, r), 5, np.int32), np.full((g, r), 5, np.int32),
            np.array([10, 10, 10], np.int32), np.ones((1, n), bool),
            np.arange(g, dtype=np.int32))


def _pooled_infeasible():
    """A gang the whole cluster cannot hold: infeasible with no demotion."""
    n = 24
    return (np.full((n, 2), 5, np.int32), np.full((2, 2), 5, np.int32),
            np.array([n + 10, 4], np.int32), np.ones((1, n), bool),
            np.arange(2, dtype=np.int32))


def _contended():
    """Alternating demand rows fighting over a few tight nodes: speculative
    waves conflict and replay."""
    left = np.array([[10], [100], [7], [40]], np.int32)
    group_req = np.array([[1 + (i % 2)] for i in range(8)], np.int32)
    return (left, group_req, np.full(8, 3, np.int32), np.ones((1, 4), bool),
            np.arange(8, dtype=np.int32))


def _zone_disjoint():
    """Each gang sees only its own node: waves commit speculatively."""
    n, g = 8, 8
    return (np.full((n, 1), 10, np.int32), np.array([[1 + i % 3] for i in range(g)], np.int32),
            np.full(g, 3, np.int32), np.eye(g, n, dtype=bool), np.arange(g, dtype=np.int32))


def _loose_bin():
    """Capacities >= 127 (the loose bin), a need-0 gang, an infeasible gang."""
    left = np.array(
        [[10**6, 10**6], [2000, 10**6], [10**6, 10**6], [2000, 10**6],
         [2000, 10**6], [0, 10**6], [10**6, 10**6], [3000, 10**6]], np.int32)
    group_req = np.array([[1000, 1], [1000, 1], [1000, 1], [1000, 1], [10, 1], [1, 0]],
                         np.int32)
    remaining = np.array([6, 0, 10**4, 300, 500, 7], np.int32)
    return left, group_req, remaining, np.ones((1, 8), bool), np.array([1, 0, 2, 3, 4, 5],
                                                                       np.int32)


def _xl(profiles, seed=0):
    spec = port_scenarios.XLClusterSpec(num_nodes=2048, num_groups=128,
                                        request_profiles=profiles, seed=seed)
    left, req, rem, mask, order = port_scenarios.xl_scan_operands(spec)
    return left, req, rem, mask.astype(bool), order


# case -> (inputs, wave, k, the stat the case must show: "demoted", "replayed",
# "speculative", "mega" or None)
SCAN_CASES = {
    "k4": (lambda: _scan_case(), 4, 4, None),
    "k16": (lambda: _scan_case(), 4, 16, None),
    "k64": (lambda: _scan_case(), 4, 64, None),
    "per-group": (lambda: _scan_case(per_group=True, seed=11), 4, 8, None),
    "uniform": (lambda: _scan_case(uniform=True, seed=3), 4, 8, "mega"),
    "uniform-per-group": (lambda: _scan_case(uniform=True, per_group=True, seed=5), 4, 64,
                          "mega"),
    "uneven-50": (lambda: _scan_case(n=50, g=9, seed=50), 4, 8, None),
    "uneven-61": (lambda: _scan_case(n=61, g=9, seed=61), 4, 8, None),
    "tight-fit-k4": (_tight_fit, 4, 4, "demoted"),
    "tight-fit-k16": (_tight_fit, 4, 16, None),
    "pooled-infeasible": (_pooled_infeasible, 4, 4, None),
    "contended": (_contended, 2, 4, "replayed"),
    "zone-disjoint": (_zone_disjoint, 8, 4, "speculative"),
    "loose-bin": (_loose_bin, 2, 4, None),
    "xl-1-profile": (lambda: _xl(1), 8, 16, "mega"),
    "xl-3-profiles": (lambda: _xl(3), 8, 16, "demoted"),
}


def _shows(stat, conflicts, megas, dense):
    return {
        "demoted": dense.sum() > 0,
        "replayed": conflicts.any(),
        "speculative": (~conflicts & ~megas).any(),
        "mega": (megas & ~conflicts).any(),
    }[stat]


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_plain_topk_matches_reference(case):
    build, wave, k, stat = SCAN_CASES[case]
    args = build()
    ref = jax_oracle.assign_gangs_topk(*args, wave=wave, k=k, with_stats=True)
    got = port_oracle.assign_gangs_topk(*_t(*args), wave=wave, k=k, with_stats=True)
    serial = port_oracle.assign_gangs(*_t(*args))
    for name, r, q, s in zip(("alloc", "placed", "left"), ref, got, serial):
        assert q.numpy().dtype == np.asarray(r).dtype, name
        np.testing.assert_array_equal(q.numpy(), np.asarray(r), err_msg=name)
        np.testing.assert_array_equal(q.numpy(), s.numpy(), err_msg=name)
    stats = [x.numpy() for x in got[3]]
    assert len(stats[0]) == -(-args[1].shape[0] // wave)
    for name, q, r in zip(("conflicts", "megas", "dense_demotions"), stats, ref[3]):
        np.testing.assert_array_equal(q, np.asarray(r).astype(q.dtype), err_msg=name)
    if stat is not None:
        assert _shows(stat, *stats), (stat, stats)
    if case == "tight-fit-k4":
        assert stats[2].sum() >= 3  # every gang outran its candidates


# -- knob, bucket and scenario ------------------------------------------------

@pytest.mark.parametrize("k", [-3, 0, 1, 3, 4, 5, 16, 17, 64, 127, 128, 129, 10**6])
def test_topk_bucket_matches_reference(k):
    assert port_bucketing.topk_bucket(k) == jax_bucketing.topk_bucket(k)


@pytest.mark.parametrize("raw", [None, "", "0", "-2", "1", "16", "100", "999", "many"])
def test_scan_topk_knob_matches_reference(raw, monkeypatch, capsys):
    if raw is None:
        monkeypatch.delenv("BST_SCAN_TOPK", raising=False)
    else:
        monkeypatch.setenv("BST_SCAN_TOPK", raw)
    port_oracle._warn_unparseable_topk.cache_clear()
    got = port_oracle._scan_topk_from_env()
    assert got == port_oracle._scan_topk_from_env()
    # an unparseable value warns once on stderr, and only then
    err = capsys.readouterr().err
    assert err.count("ignoring unparseable BST_SCAN_TOPK") == (raw == "many")
    assert got == jax_oracle._scan_topk_from_env()


@pytest.mark.parametrize("kw", [{}, {"num_nodes": 3000, "num_groups": 200, "request_profiles": 3,
                                      "seed": 7, "lanes": 4}], ids=["default", "small-3-profiles"])
def test_xl_operands_match_reference(kw):
    port_spec = port_scenarios.XLClusterSpec(**kw)
    ref_spec = jax_scenarios.XLClusterSpec(**kw)
    got = port_scenarios.xl_scan_operands(port_spec)
    want = jax_scenarios.xl_scan_operands(ref_spec)
    for g_arr, w_arr in zip(got, want):
        assert g_arr.dtype == w_arr.dtype
        np.testing.assert_array_equal(g_arr, w_arr)
    for step in (0, 1, 2):
        np.testing.assert_array_equal(port_scenarios.xl_churn_burst(port_spec, got[0], step),
                                      jax_scenarios.xl_churn_burst(ref_spec, want[0], step))


# -- the batch path -------------------------------------------------------------

def _padded(case):
    from test_torch_wavefront import pad_scan_args

    return pad_scan_args(*SCAN_CASES[case][0]())


TOPK_TELEMETRY = ("wave_width", "waves_per_batch", "wave_demotions", "wave_uniform", "scan_topk",
                  "topk_demotions")


def _assert_hosts_equal(host, ref_host):
    assert set(host) == set(ref_host)
    for key in ref_host:
        if key == "telemetry":
            continue
        got, want = np.asarray(host[key]), np.asarray(ref_host[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("case,env", [
    ("k4", {"BST_SCAN_TOPK": "4"}),
    ("per-group", {"BST_SCAN_TOPK": "16", "BST_SCAN_WAVE": "4"}),
    ("tight-fit-k4", {"BST_SCAN_TOPK": "3"}),
    ("uniform", {"BST_SCAN_TOPK": "128", "BST_SCAN_WAVE": "2"}),
], ids=["k4", "per-group-w4", "tight-fit", "uniform-k128"])
def test_execute_batch_host_topk_matches_reference(case, env, monkeypatch):
    batch_args, progress_args = _padded(case)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref_host, ref_dev = jax_oracle.execute_batch_host(batch_args, progress_args)
    host, dev = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    _assert_hosts_equal(host, ref_host)
    for key in TOPK_TELEMETRY:
        assert host["telemetry"][key] == ref_host["telemetry"][key], key
    assert host["telemetry"]["scan_topk"] == port_bucketing.topk_bucket(int(env["BST_SCAN_TOPK"]))
    assert host["telemetry"]["wave_width"] == int(env.get("BST_SCAN_WAVE", 8))
    for kind in ("capacity", "scores"):
        np.testing.assert_array_equal(dev[kind].numpy(), np.asarray(ref_dev[kind]))
    # the same plan as the serial scan's
    monkeypatch.delenv("BST_SCAN_TOPK")
    monkeypatch.delenv("BST_SCAN_WAVE", raising=False)
    serial, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    assert serial["telemetry"]["scan_topk"] == 0 and "topk_demotions" not in serial["telemetry"]
    for key in ("placed", "gang_feasible", "assignment_nodes", "assignment_counts"):
        np.testing.assert_array_equal(serial[key], host[key], err_msg=key)


def test_unparseable_knob_runs_the_dense_scan(monkeypatch):
    batch_args, progress_args = _padded("k16")
    monkeypatch.setenv("BST_SCAN_TOPK", "many")
    host, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    tel = host["telemetry"]
    assert tel["scan_topk"] == 0 and tel["wave_width"] == 0 and "waves_per_batch" not in tel
    monkeypatch.setenv("BST_SCAN_WAVE", "8")  # the wavefront rung below it still runs
    host, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    assert host["telemetry"]["scan_topk"] == 0 and host["telemetry"]["wave_width"] == 8
    assert "topk_demotions" not in host["telemetry"]


def test_policy_batch_never_takes_the_rung(monkeypatch):
    """A batch with a policy runs the policy scan whatever BST_SCAN_TOPK or a
    pin says, in both packages, with the same answers."""
    batch_args, progress_args = _padded("k16")
    g, n = batch_args[2].shape[0], batch_args[0].shape[0]
    rng = np.random.default_rng(2)
    cols = (np.zeros(g, np.int32), rng.integers(0, 3, g).astype(np.int32),
            np.zeros(g, np.int32), np.zeros((g, 16), np.int32),
            rng.integers(0, 3, (n, 4)).astype(np.int32), np.zeros(n, np.int32))
    policy = (cols, ("affinity",), (32, 8, 3))
    monkeypatch.setenv("BST_SCAN_TOPK", "16")
    ref_host, _ = jax_oracle.execute_batch_host(batch_args, progress_args, policy=policy)
    host, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu",
                                             policy=policy)
    _assert_hosts_equal(host, ref_host)
    for tel in (host["telemetry"], ref_host["telemetry"]):
        assert tel["scan_policy"] is True and tel["scan_topk"] == 0 and tel["wave_width"] == 0
    with port_oracle.forced_scan_rung(8, 16):
        pinned, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu",
                                                   policy=policy)
    assert pinned["telemetry"]["scan_topk"] == 0 and pinned["telemetry"]["scan_policy"]


def test_north_star_small_topk_matches_reference(monkeypatch):
    """The whole slice under BST_SCAN_TOPK=16: both packages' OracleScorer
    give the same answers, and the scorer keeps the top-K telemetry."""
    from test_torch_slice import PACKAGES, _answers, _north_star_small

    monkeypatch.setenv("BST_SCAN_TOPK", "16")
    ref, port = (_answers(name) for name in PACKAGES)
    assert port == ref
    from batch_scheduler_tpu_torch.core import OracleScorer

    cluster, cache, _ = _north_star_small("batch_scheduler_tpu_torch")
    scorer = OracleScorer(device="cpu")
    scorer.ensure_fresh(cluster, cache)
    tele = scorer.last_telemetry
    assert tele["scan_topk"] == 16 and tele["wave_width"] == 8
    assert tele["waves_per_batch"] == scorer.snapshot.shape[0] // 8
    assert 0 <= tele["topk_demotions"]


@pytest.mark.parametrize("against", ["topk", "steady", "cpu-ladder", "wavefront"])
def test_topk_replay_rung_matches_reference(against):
    """Every replay rung gives the reference's digest on a recorded batch,
    and the topk rung the steady rung's plan."""
    from batch_scheduler_tpu.core import oracle_scorer as jax_scorer
    from batch_scheduler_tpu.utils import audit as jax_audit
    from batch_scheduler_tpu_torch.core import oracle_scorer as port_scorer
    from batch_scheduler_tpu_torch.utils import audit as port_audit

    batch_args, progress_args = _padded("tight-fit-k4")
    ref_host, _ = jax_scorer.replay_batch(batch_args, progress_args, against=against)
    host, _ = port_scorer.replay_batch(batch_args, progress_args, against=against,
                                       device="cpu")
    assert port_audit.plan_digest(host) == jax_audit.plan_digest(ref_host)
    steady, _ = port_scorer.replay_batch(batch_args, progress_args, device="cpu")
    assert port_audit.plan_digest(host) == port_audit.plan_digest(steady)
    if against == "topk":
        assert host["telemetry"]["scan_topk"] == 16 == ref_host["telemetry"]["scan_topk"]
        assert host["telemetry"]["topk_demotions"] == ref_host["telemetry"]["topk_demotions"]
    assert port_scorer.REPLAY_RUNGS == jax_scorer.REPLAY_RUNGS


def test_topk_audit_ring_replays_on_every_rung(tmp_path, monkeypatch):
    """A ring recorded on the topk rung replays identically on steady and
    cpu-ladder, and a serial-recorded ring on topk; the reference's reader
    reads the port's ring and replays it on its own topk rung."""
    from batch_scheduler_tpu.core import oracle_scorer as jax_scorer
    from batch_scheduler_tpu.utils.audit import AuditReader as JaxReader
    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record
    from batch_scheduler_tpu_torch.utils.audit import AuditLog, AuditReader, plan_digest

    batch_args, progress_args = _padded("k16")
    for name, env, rungs in (("topk", "16", ("steady", "cpu-ladder")),
                             ("serial", None, ("topk",))):
        if env is None:
            monkeypatch.delenv("BST_SCAN_TOPK", raising=False)
        else:
            monkeypatch.setenv("BST_SCAN_TOPK", env)
        host, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
        ring = tmp_path / name
        log = AuditLog(str(ring))
        log.record_batch(batch_args=batch_args, progress_args=progress_args, result=host,
                         plan_digest=plan_digest(host), telemetry=host["telemetry"])
        log.flush()
        monkeypatch.delenv("BST_SCAN_TOPK", raising=False)
        (rec,), skipped = AuditReader(str(ring)).batches()
        assert not skipped
        for rung in rungs:
            rep = replay_audit_record(rec, against=rung, device="cpu")
            assert rep["identical"], (name, rung, rep)
            assert rep["executed_rung"].get("scan_topk", 0) == (16 if rung == "topk" else 0)
        (jrec,), _ = JaxReader(str(ring)).batches()
        assert jax_scorer.replay_audit_record(jrec, against="topk")["identical"]


def test_topk_wrapper_rejects_bad_widths_and_inputs():
    args = _t(*_contended())
    for wave in (0, 1, 3, 64, 8.0):
        with pytest.raises(ValueError, match="wave must be one of"):
            assign_gangs_topk_cuda(*args, wave, 16)
    for k in (0, -1, 129, 16.0):
        with pytest.raises(ValueError, match="k must be an int"):
            assign_gangs_topk_cuda(*args, 8, k)
    left = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        assign_gangs_topk_cuda(
            left, torch.zeros((1, 2), dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
            torch.ones((1, 2), dtype=torch.bool), torch.arange(1, dtype=torch.int32), 8, 16,
        )
    # on the CPU the wrapper is the plain version
    got = assign_gangs_topk_cuda(*args, 2, 4)
    want = port_oracle.assign_gangs_topk(*args, wave=2, k=4, with_stats=True)
    for a, b in zip(list(got[:3]) + list(got[3]), list(want[:3]) + list(want[3])):
        assert torch.equal(a, b)


def test_topk_kernel_plan_layout():
    """The launch shape: the serial kernel's blocks, at most 512 threads a
    block covering its nodes, the shared memory of the kernel's layout
    within the budget; the leftover in shared memory at the north star and
    the acceptance bucket [2048, 65536], in global scratch at XL with K=128;
    the widest width and list still fit (one publish buffer)."""
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        _node_split, _topk_shared_bytes, topk_kernel_plan)

    budget = 232448 - 2048  # an H100's opt-in shared memory less the static part
    for n in (8, 100, 512, 8192, 65536, 100_000, 131072, 2**21):
        for wave, kk in ((8, 16), (8, 128), (32, 64)):
            kk = min(kk, n)
            plan = topk_kernel_plan(n, 6, wave, kk, 16, budget)
            c, block_nodes, _ = _node_split(n, 16)
            assert (plan.cluster_blocks, plan.block_nodes) == (c, block_nodes)
            assert plan.threads % 32 == 0 and plan.threads <= 512
            assert plan.threads * plan.per_thread >= plan.block_nodes
            assert plan.per_thread == -(-block_nodes // 512)
            assert plan.cluster_blocks * plan.block_nodes >= n
            assert kk <= plan.list_len <= kk + min(kk, 32) and plan.touched_max >= kk
            assert plan.shared_bytes == _topk_shared_bytes(
                wave, kk, plan.list_len, plan.touched_max, 6, plan.per_thread, plan.threads,
                plan.leftover == "shared", plan.keys == "shared", plan.publish_buffers)
            assert plan.shared_bytes <= budget
            assert plan.scratch_ints == (
                plan.cluster_blocks * 6 * plan.per_thread * plan.threads
                if plan.leftover == "global" else 0)
    for n, kk in ((8192, 16), (65536, 16), (65536, 128)):
        plan = topk_kernel_plan(n, 6, 8, kk, 16, budget)
        assert (plan.leftover, plan.keys, plan.list_len) == ("shared", "shared", kk + min(kk, 32))
    assert topk_kernel_plan(131072, 6, 8, 128, 16, budget).leftover == "global"
    wide = topk_kernel_plan(3000, 12, 32, 128, 16, budget)
    assert wide.publish_buffers == 1 and wide.shared_bytes <= budget
    with pytest.raises(ValueError, match="no top-K layout fits"):
        topk_kernel_plan(8192, 6, 8, 16, 16, 1024)


def test_topk_source_builds_from_the_shared_header(tmp_path):
    """assign_topk.cu is a library of its own (no variant), an edited
    cluster_scan.cuh changes its build digest (so it rebuilds), and the
    source's limits are the wrapper's: 512 threads a block, lists of at most
    256 entries, K at most 128, W at most 32."""
    import re
    import shutil

    from batch_scheduler_tpu_torch.ops import _build
    from batch_scheduler_tpu_torch.ops import assign_scan

    assert "assign_topk" not in _build.VARIANTS
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    src = csrc / "assign_topk.cu"
    before = _build.digest(src)
    assert before == _build.digest(_build.CSRC_DIR / "assign_topk.cu")
    header = csrc / "cluster_scan.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.digest(src) != before
    text = src.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kTopkThreads"]) == assign_scan._TOPK_THREADS
    assert int(consts["kMaxList"]) == assign_scan._TOPK_LIST_MAX
    assert int(consts["kMaxK"]) == assign_scan._MAX_TOPK
    assert int(consts["kMaxWave"]) == max(assign_scan.WAVE_WIDTHS)


def _card_case(rng, n, g, kind, lanes=5):
    """Seeded inputs for the card test: random rows, one request row
    (uniform waves), per-group masks, or the tight fit that demotes."""
    left = rng.integers(0, 3000, size=(n, lanes)).astype(np.int32)
    req = rng.integers(0, 40, size=(g, lanes)).astype(np.int32)
    rem = rng.integers(0, 200, size=g).astype(np.int32)
    mask = rng.random((g if kind == "per-group" else 1, n)) < 0.8
    if kind == "uniform":
        req[:] = req[0]
    elif kind == "tight":
        left[:] = 40
        req[:] = 40
        rem = rng.integers(1, 40, size=g).astype(np.int32)
    return left, req, rem, mask, rng.permutation(g).astype(np.int32)


@pytest.mark.cuda
def test_topk_kernel_matches_plain_on_card():
    """The cluster kernel against the plain top-K scan (outputs and the three
    series) and the plain serial scan: one block, 2 and 16 blocks, several
    nodes a thread (135 at 1,100,000 nodes), both mask modes, 12
    lanes, widths 2 to 32 with K up to 128, every branch and demotion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_plain

    rng = np.random.default_rng(6)
    shown = {"mega": 0, "speculative": 0, "replayed": 0, "demoted": 0}
    for n, g, wave, k, kind, lanes in (
            (8, 8, 2, 4, "mixed", 5), (300, 64, 8, 16, "mixed", 5), (600, 64, 8, 4, "tight", 5),
            (2000, 100, 4, 16, "per-group", 5), (5000, 96, 8, 128, "uniform", 5),
            (40000, 48, 32, 64, "mixed", 5), (3000, 64, 32, 128, "per-group", 12),
            (20000, 64, 16, 8, "tight", 3), (1_100_000, 16, 8, 16, "mixed", 4)):
        args = _t(*_card_case(rng, n, g, kind, lanes))
        want = port_oracle.assign_gangs_topk(*args, wave=wave, k=k, with_stats=True)
        serial = assign_gangs_plain(*args)
        cargs = tuple(a.cuda() for a in args)
        got = assign_gangs_topk_cuda(*cargs, wave, k)
        for a, b in zip(list(got[:3]) + list(got[3]), list(want[:3]) + list(want[3])):
            assert torch.equal(a.cpu(), b), (n, g, wave, k, kind, lanes)
        for a, b in zip(got[:3], serial):
            assert torch.equal(a.cpu(), b)
        conflicts, megas, dense = (x.cpu().numpy() for x in got[3])
        # every replayed gang was served by the carried lists or ranked afresh
        carried, fresh = assign_gangs_topk_cuda.replay_counts.tolist()
        real = [min(wave, g - s * wave) for s in range(len(conflicts))]
        assert carried + fresh == sum(w for w, c in zip(real, conflicts) if c)
        for stat in shown:
            shown[stat] += int(_shows(stat, conflicts, megas, dense))
    assert all(shown.values()), shown
