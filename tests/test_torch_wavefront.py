"""The port's wavefront assignment scan against the JAX reference on the
CPU: the plain ``assign_gangs_wavefront`` equals the reference's lax
wavefront (outputs and per-wave stats), its Pallas ``_kernel_wave`` in
interpret mode and the port's serial scan, on every branch (uniform,
speculative, replay); the ``BST_SCAN_WAVE`` knob parses and buckets as
the reference's; the batch's host dict and wave telemetry equal the
reference's; the wrapper's input checks; and, on a card, the CUDA kernel
against the plain version. Every output is an integer, so every
comparison is exact (tolerance zero)."""

import numpy as np
import pytest
import torch

try:
    from batch_scheduler_tpu.ops import bucketing as jax_bucketing
    from batch_scheduler_tpu.ops import oracle as jax_oracle
    from batch_scheduler_tpu.ops.pallas_assign import assign_gangs_pallas
except ImportError:  # a GPU machine without JAX runs only the `cuda` test here
    jax_bucketing = jax_oracle = assign_gangs_pallas = None
from batch_scheduler_tpu_torch.ops import bucketing as port_bucketing
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.assign_scan import WAVE_WIDTHS, assign_gangs_wave_cuda


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# -- scan fixtures (tests/test_wavefront.py's classes) ---------------------

def _fuzz(seed, per_group, uniform=False):
    # one fixed shape (12 nodes, 12 gangs, 3 lanes) so the reference
    # compiles once per wave width and mask mode
    rng = np.random.default_rng(seed)
    n, g, r = 12, 12, 3
    left = rng.integers(0, 400 if uniform else 50, size=(n, r)).astype(np.int32)
    group_req = rng.integers(0, 6, size=(g, r)).astype(np.int32)
    if uniform:
        group_req[:] = rng.integers(0, 3, size=(1, r))
    remaining = rng.integers(0, 30 if uniform else 16, size=g).astype(np.int32)
    order = rng.permutation(g).astype(np.int32)
    mask = rng.random((g if per_group else 1, n)) > 0.2
    return left, group_req, remaining, mask, order


def _uniform_infeasible():
    """Identical gangs; the first wave holds gangs that need more than the
    cluster holds; nodes with capacity >= 127 (the loose bin)."""
    left = np.array([[500, 9], [500, 9], [500, 3], [500, 200], [500, 200], [500, 0]],
                    np.int32)
    group_req = np.tile(np.array([[3, 1]], np.int32), (16, 1))
    remaining = np.array([4, 4, 4, 900, 4, 4, 4, 900] + [4] * 8, np.int32)
    return left, group_req, remaining, np.ones((1, 6), bool), np.arange(16, dtype=np.int32)


def _uniform_runs_out():
    """Identical feasible gangs whose wave drains the cluster mid-wave."""
    left = np.array([[12, 5], [30, 40], [7, 7]], np.int32)
    group_req = np.tile(np.array([[2, 1]], np.int32), (8, 1))
    remaining = np.array([3, 4, 5, 2, 6, 3, 4, 2], np.int32)
    return left, group_req, remaining, np.ones((1, 3), bool), np.arange(8, dtype=np.int32)


def _uniform_per_group():
    """Identical demand and identical zone mask rows in per-group mode."""
    rng = np.random.default_rng(3)
    left = rng.integers(0, 300, size=(10, 2)).astype(np.int32)
    group_req = np.tile(np.array([[2, 1]], np.int32), (8, 1))
    remaining = rng.integers(1, 20, size=8).astype(np.int32)
    mask = np.tile(np.arange(10) % 2 == 0, (8, 1))
    return left, group_req, remaining, mask, rng.permutation(8).astype(np.int32)


def _contended():
    """Alternating demand rows fighting over one tight node."""
    left = np.array([[10], [100]], np.int32)
    group_req = np.array([[1 + (i % 2)] for i in range(8)], np.int32)
    return (left, group_req, np.full(8, 3, np.int32), np.ones((1, 2), bool),
            np.arange(8, dtype=np.int32))


def _zone_disjoint():
    """Each gang sees only its own node: waves commit speculatively."""
    n, g = 8, 8
    mask = np.eye(g, n, dtype=bool)
    group_req = np.array([[1 + i % 3] for i in range(g)], np.int32)
    return (np.full((n, 1), 10, np.int32), group_req, np.full(g, 3, np.int32), mask,
            np.arange(g, dtype=np.int32))


def _loose_bin():
    """Capacities >= 127, a need-0 gang, an infeasible gang, mixed rows."""
    left = np.array(
        [[10**6, 10**6], [2000, 10**6], [10**6, 10**6], [2000, 10**6],
         [2000, 10**6], [0, 10**6], [10**6, 10**6], [3000, 10**6]], np.int32)
    group_req = np.array([[1000, 1], [1000, 1], [1000, 1], [1000, 1], [10, 1], [1, 0]],
                         np.int32)
    remaining = np.array([6, 0, 10**4, 300, 500, 7], np.int32)
    return left, group_req, remaining, np.ones((1, 8), bool), np.array([1, 0, 2, 3, 4, 5], np.int32)


# case -> (inputs, the branch its per-wave stats must show at least once)
SCAN_CASES = {
    "fuzz-broadcast": (lambda: _fuzz(17, False), None),
    "fuzz-per-group": (lambda: _fuzz(18, True), None),
    "uniform-fuzz": (lambda: _fuzz(41, False, uniform=True), "uniform"),
    "uniform-infeasible": (_uniform_infeasible, "uniform-replayed"),
    "uniform-runs-out": (_uniform_runs_out, "uniform-replayed"),
    "uniform-per-group": (_uniform_per_group, "uniform"),
    "contended": (_contended, "replayed"),
    "zone-disjoint": (_zone_disjoint, "speculative"),
    "loose-bin": (_loose_bin, None),
}
WAVE_CASES = [
    ("fuzz-broadcast", 2), ("fuzz-broadcast", 8), ("fuzz-broadcast", 32),
    ("fuzz-per-group", 2), ("fuzz-per-group", 8), ("fuzz-per-group", 32),
    ("uniform-fuzz", 8), ("uniform-infeasible", 8), ("uniform-runs-out", 8),
    ("uniform-per-group", 8), ("contended", 2), ("contended", 8),
    ("zone-disjoint", 8), ("loose-bin", 2), ("loose-bin", 8),
]


@pytest.mark.parametrize("case,wave", WAVE_CASES, ids=[f"{c}-w{w}" for c, w in WAVE_CASES])
def test_plain_wavefront_matches_reference(case, wave):
    build, branch = SCAN_CASES[case]
    args = build()
    ref = jax_oracle.assign_gangs_wavefront(*args, wave=wave, with_stats=True)
    pallas = assign_gangs_pallas(*args, interpret=True, wave=wave)
    serial = port_oracle.assign_gangs(*_t(*args))
    got = port_oracle.assign_gangs_wavefront(*_t(*args), wave=wave, with_stats=True)
    for name, r, p, s, q in zip(("alloc", "placed", "left"), ref, pallas, serial, got):
        assert q.numpy().dtype == np.asarray(r).dtype, name
        np.testing.assert_array_equal(q.numpy(), np.asarray(r), err_msg=name)
        np.testing.assert_array_equal(q.numpy(), np.asarray(p), err_msg=name)
        np.testing.assert_array_equal(q.numpy(), s.numpy(), err_msg=name)
    conflicts, megas = (x.numpy() for x in got[3])
    assert len(conflicts) == -(-args[1].shape[0] // wave)
    np.testing.assert_array_equal(conflicts, np.asarray(ref[3][0]))
    np.testing.assert_array_equal(megas, np.asarray(ref[3][1]))
    # the wrapper on CPU tensors is the same plain version
    wrapped = assign_gangs_wave_cuda(*_t(*args), wave)
    for a, b in zip(wrapped[:3] + wrapped[3], got[:3] + got[3]):
        assert torch.equal(a, b)
    if branch == "uniform":
        assert (megas & ~conflicts).any()
    elif branch == "uniform-replayed":
        assert (megas & conflicts).any()
    elif branch == "speculative":
        assert (~megas & ~conflicts).any()
    elif branch == "replayed":
        assert (~megas & conflicts).any()


@pytest.mark.parametrize("w", [-3, 0, 1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 10**6])
def test_wave_width_bucket_matches_reference(w):
    assert port_bucketing.wave_width_bucket(w) == jax_bucketing.wave_width_bucket(w)


@pytest.mark.parametrize("raw", [None, "", "0", "1", "2", "5", "9", "32", "33", "-4", "x8"])
def test_scan_wave_knob_matches_reference(raw, monkeypatch, capsys):
    if raw is None:
        monkeypatch.delenv("BST_SCAN_WAVE", raising=False)
    else:
        monkeypatch.setenv("BST_SCAN_WAVE", raw)
    port_oracle._warn_unparseable_wave.cache_clear()
    got = port_oracle._scan_wave_from_env()
    assert got == port_oracle._scan_wave_from_env()
    # an unparseable value warns once on stderr, and only then
    err = capsys.readouterr().err
    assert err.count("ignoring unparseable BST_SCAN_WAVE") == (raw == "x8")
    assert got == jax_oracle._scan_wave_from_env()
    assert got in (0,) + WAVE_WIDTHS


def _padded(case):
    from batch_scheduler_tpu.ops.bucketing import pad_oracle_batch

    left, group_req, remaining, mask, order = SCAN_CASES[case][0]()
    n, r = left.shape
    g = group_req.shape[0]
    rng = np.random.default_rng(5)
    requested = rng.integers(0, 3, size=(n, r)).astype(np.int32)
    return pad_oracle_batch(
        alloc=left + requested, requested=requested, group_req=group_req,
        remaining=remaining, fit_mask=mask, group_valid=np.ones(g, bool),
        order=order, min_member=remaining + 1,
        scheduled=np.ones(g, np.int32), matched=np.zeros(g, np.int32),
        ineligible=np.zeros(g, bool),
        creation_rank=np.arange(g, dtype=np.int32),
    )


WAVE_TELEMETRY = ("wave_width", "waves_per_batch", "wave_demotions", "wave_uniform")


@pytest.mark.parametrize("case", ["fuzz-per-group", "uniform-infeasible", "zone-disjoint"])
def test_execute_batch_host_wave_matches_reference(case, monkeypatch):
    batch_args, progress_args = _padded(case)
    monkeypatch.setenv("BST_SCAN_WAVE", "8")
    ref_host, ref_dev = jax_oracle.execute_batch_host(batch_args, progress_args)
    host, dev = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    assert set(host) == set(ref_host)
    for key in ref_host:
        if key == "telemetry":
            continue
        got, want = np.asarray(host[key]), np.asarray(ref_host[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for key in WAVE_TELEMETRY:
        assert host["telemetry"][key] == ref_host["telemetry"][key], key
    assert host["telemetry"]["wave_width"] == 8
    for kind in ("capacity", "scores"):
        np.testing.assert_array_equal(dev[kind].numpy(), np.asarray(ref_dev[kind]))
    # unset: the serial scan, no wave statistics
    monkeypatch.delenv("BST_SCAN_WAVE")
    serial, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    assert serial["telemetry"]["wave_width"] == 0
    assert "waves_per_batch" not in serial["telemetry"]
    for key in ("placed", "assignment_nodes", "assignment_counts"):
        np.testing.assert_array_equal(serial[key], host[key], err_msg=key)


def test_north_star_small_wave_matches_reference(monkeypatch):
    """The whole slice under BST_SCAN_WAVE=8: both packages' OracleScorer
    give the same answers, and the scorer keeps the wave telemetry."""
    from test_torch_slice import PACKAGES, _answers, _north_star_small

    monkeypatch.setenv("BST_SCAN_WAVE", "8")
    ref, port = (_answers(name) for name in PACKAGES)
    assert port == ref
    from batch_scheduler_tpu_torch.core import OracleScorer

    cluster, cache, _ = _north_star_small("batch_scheduler_tpu_torch")
    scorer = OracleScorer(device="cpu")
    scorer.ensure_fresh(cluster, cache)
    tele = scorer.last_telemetry
    assert tele["wave_width"] == 8
    assert tele["waves_per_batch"] == scorer.snapshot.shape[0] // 8
    assert 0 <= tele["wave_demotions"] <= tele["waves_per_batch"]


def test_wave_wrapper_rejects_bad_wave_and_inputs():
    args = _t(*_contended())
    for wave in (0, 1, 3, 64, 8.0):
        with pytest.raises(ValueError, match="wave must be one of"):
            assign_gangs_wave_cuda(*args, wave)
    left = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        assign_gangs_wave_cuda(
            left, torch.zeros((3, 2), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
            torch.ones((2, 2), dtype=torch.bool),  # neither 1 nor G rows
            torch.arange(3, dtype=torch.int32), 8,
        )
    with pytest.raises(TypeError):
        assign_gangs_wave_cuda(
            left, torch.zeros((1, 2), dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
            torch.ones((1, 2), dtype=torch.bool), torch.arange(1, dtype=torch.int32), 8,
        )


def _card_inputs(rng, n, g, rows, wave, kind):
    """Seeded scan inputs for the card test: ``kind`` "mixed" (random rows),
    "uniform" (one request row; the needs sometimes drain the cluster
    mid-wave), or "zones" (per-group rows, position p sees nodes
    n % wave == p % wave, so non-uniform waves run without a conflict)."""
    left = rng.integers(0, 2000, size=(n, 5)).astype(np.int32)
    req = rng.integers(0, 40, size=(g, 5)).astype(np.int32)
    rem = rng.integers(0, 300, size=g).astype(np.int32)
    order = rng.permutation(g).astype(np.int32)
    mask = rng.random((rows, n)) < 0.8
    if kind == "uniform":
        req[:] = req[0]
        rem[rng.random(g) < 0.1] = 3000
    elif kind == "zones":
        position = np.empty(g, np.int64)
        position[order] = np.arange(g)
        mask = np.arange(n)[None, :] % wave == position[:, None] % wave
        left[:] = 10 ** 6
    return left, req, rem, mask, order


@pytest.mark.cuda
def test_wave_kernel_matches_plain_on_card():
    """The cluster kernel against the plain wavefront (outputs and flags)
    and the plain serial scan: one block (8 nodes), 16 blocks with the
    leftover in shared memory (one node a thread in the unrolled variant;
    two and three in the runtime-loop variant), and 70,000 nodes (five a
    thread) with the leftover in global scratch; every branch taken and
    demoted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_plain, wave_scan_plan

    rng = np.random.default_rng(4)
    shapes = ((8, 8, 1, 2), (300, 64, 64, 8), (5000, 128, 1, 8), (10000, 40, 40, 32),
              (2000, 100, 1, 32), (20000, 24, 1, 8), (20000, 24, 24, 32),
              (40000, 24, 1, 8), (70000, 24, 1, 8), (70000, 24, 24, 32))
    branches = {"uniform": 0, "uniform-replayed": 0, "speculative": 0, "replayed": 0}
    leftovers, per_thread = set(), set()
    for n, g, rows, wave in shapes:
        for kind in ("mixed", "uniform") + (("zones",) if rows > 1 else ()):
            host = _card_inputs(rng, n, g, g if kind == "zones" else rows, wave, kind)
            args = tuple(t.cuda() for t in _t(*host))
            got = assign_gangs_wave_cuda(*args, wave)
            want = port_oracle.assign_gangs_wavefront(*args, wave=wave, with_stats=True)
            serial = assign_gangs_plain(*args)
            torch.cuda.synchronize()
            for a, b, c in zip(got[:3], want[:3], serial):
                assert torch.equal(a, b) and torch.equal(a, c), (n, g, wave, kind)
            for a, b in zip(got[3], want[3]):
                assert torch.equal(a, b), (n, g, wave, kind)
            conflicts, megas = (x.cpu().numpy() for x in got[3])
            branches["uniform"] += int((megas & ~conflicts).sum())
            branches["uniform-replayed"] += int((megas & conflicts).sum())
            branches["speculative"] += int((~megas & ~conflicts).sum())
            branches["replayed"] += int((~megas & conflicts).sum())
            plan = wave_scan_plan(n, 5, torch.cuda.current_device())
            leftovers.add(plan.leftover)
            per_thread.add(plan.per_thread)
    assert all(branches.values()), branches
    assert leftovers == {"shared", "global"}
    assert {1, 2, 3} <= per_thread, per_thread
