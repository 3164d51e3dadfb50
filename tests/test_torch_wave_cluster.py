"""The wave kernel's rules, on the CPU: the uniform flags its prepare
kernel computes (plain version ``wave_uniform``) against the plain
wavefront's and the JAX reference's; the partial-keep rules it reaches the
serial results and the reference's flags by (a uniform wave keeps the
gangs before its first gang infeasible at its boundary, found from the
stream's length; a speculative wave's takes before its first conflicted
gang k are the serial takes, and k is the first gang whose capacity row
under the serial leftover differs from its wave-start row, which the
kernel's checked replay detects); the cluster launch shape
(``wave_kernel_plan``); and the build digest's headers. Every comparison is
exact (integers, tolerance zero)."""

import shutil

import numpy as np
import pytest
import torch

try:
    from batch_scheduler_tpu.ops import oracle as jax_oracle
except ImportError:  # a GPU machine without JAX
    jax_oracle = None
from batch_scheduler_tpu_torch.ops import _build
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.assign_scan import (
    CLUSTER_SIZES, WAVE_WIDTHS, wave_kernel_plan, wave_uniform)
from test_torch_assign_cluster import BIG_BUCKETS, _assert_tiles_once, big_bucket_cases
from test_torch_wavefront import SCAN_CASES, _t

MODES = ("broadcast", "per_group")


def _case(name, mode):
    """A scan case in the given mask mode: a broadcast row tiled to one row
    a gang, or a per-group mask cut to its first row."""
    left, group_req, remaining, mask, order = SCAN_CASES[name][0]()
    g = group_req.shape[0]
    if mode == "per_group" and mask.shape[0] == 1:
        mask = np.tile(mask, (g, 1))
    elif mode == "broadcast" and mask.shape[0] != 1:
        mask = mask[:1]
    return left, group_req, remaining, mask, order


FLAG_CASES = [(c, w, m) for c in SCAN_CASES for w in WAVE_WIDTHS for m in MODES]


@pytest.mark.parametrize("case,wave,mode", FLAG_CASES,
                         ids=[f"{c}-w{w}-{m}" for c, w, m in FLAG_CASES])
def test_wave_uniform_matches_plain_and_reference(case, wave, mode):
    args = _case(case, mode)
    flags = wave_uniform(*_t(*args[1:]), wave)
    plain = port_oracle.assign_gangs_wavefront(*_t(*args), wave=wave, with_stats=True)
    assert flags.dtype == torch.bool
    assert len(flags) == -(-args[1].shape[0] // wave)  # the last wave is padded
    assert torch.equal(flags, plain[3][1])
    # the reference compiles one scan per width and mask mode (seconds
    # each); at W=8 every case and mode is held against it here, and
    # test_torch_wavefront holds the plain flags against it at W=2/8/32
    if jax_oracle is not None and wave == 8:
        ref = jax_oracle.assign_gangs_wavefront(*args, wave=wave, with_stats=True)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(ref[3][1]))


def test_wave_uniform_inert_order_entries():
    """Out-of-range order entries are inert positions, as the kernel treats
    them: a zero request row, need 0, an empty mask row."""
    group_req = torch.tensor([[2, 1]] * 4, dtype=torch.int32)
    remaining = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    mask = torch.ones((4, 6), dtype=torch.bool)
    # the second wave is two inert positions: identical (zero) rows, need 0
    order = torch.tensor([0, 1, 9, -1], dtype=torch.int32)
    assert wave_uniform(group_req, remaining, mask, order, 2).tolist() == [True, True]
    assert wave_uniform(group_req, remaining, mask[:1], order, 2).tolist() == [True, True]
    # a real gang beside an inert position: the rows differ
    order = torch.tensor([0, 9, 1, -1], dtype=torch.int32)
    assert wave_uniform(group_req, remaining, mask, order, 2).tolist() == [False, False]
    assert wave_uniform(group_req, remaining, mask[:1], order, 2).tolist() == [False, False]


# -- the partial-keep rule ---------------------------------------------------

def _first_conflict(left, req_c, need_c, mask_c):
    """(k, takes): the reference's speculative takes against the wave-start
    leftover and k, the first gang whose capacity row changes under the
    exclusive prefix of the earlier gangs' takes (W when none does)."""
    cap = port_oracle._member_capacity(left[None, :, :], req_c[:, None, :]) * mask_c
    takes = torch.stack([
        port_oracle._select_best_fit(cap[j], cap[j].clamp(max=need), need)[0]
        for j, need in enumerate(need_c)])
    acc = left
    for j in range(len(need_c)):
        pref = port_oracle._member_capacity(acc, req_c[j][None, :]) * mask_c[j]
        if not torch.equal(pref, cap[j]):
            return j, takes
        acc = torch.clamp(acc - takes[j][:, None] * req_c[j][None, :], min=-2**30)
    return len(need_c), takes


def _first_infeasible(left, req0, need_c, mask0):
    """(j*, takes): the uniform wave's fill split at the boundaries that
    hold when every gang is feasible, and j*, the first gang with need > 0
    whose boundary A_{j+1} lies past the stream's length H (W when none),
    as the kernel finds it. Asserts that j* is also the first gang the
    reference's batched feasibility check rejects."""
    cap0 = port_oracle._member_capacity(left, req0[None, :]) * mask0
    total = sum(need_c)
    stream = int(cap0.clamp(max=total).long().sum())
    bounds = np.cumsum(need_c)
    jstar = next((j for j, need in enumerate(need_c) if need > 0 and bounds[j] > stream),
                 len(need_c))
    # the reference's check: the capacity left after the first A_j units
    key = cap0.clamp(max=127).long()
    capc = cap0.clamp(max=total).long()
    bins = torch.zeros(128, dtype=torch.int64).scatter_add_(0, key, capc)
    cum = bins.cumsum(0)
    a = torch.tensor(np.concatenate([[0], bounds]), dtype=torch.int64)
    bbkt = (cum[None, :] <= a[:, None]).sum(dim=1)
    bmask = key[None, :] == bbkt[:, None]
    bvals = torch.where(bmask, capc[None, :], 0)
    within = bvals.cumsum(dim=1) - bvals
    boff = (a - (cum - bins)[bbkt.clamp(max=127)])[:, None]
    taken = torch.where(key[None, :] < bbkt[:, None], capc[None, :],
                        torch.where(bmask, torch.minimum((boff - within).clamp(min=0),
                                                         capc[None, :]), 0))
    need_t = torch.tensor(need_c, dtype=torch.int64)
    feas = torch.minimum(cap0.long()[None, :] - taken[:-1], need_t[:, None]).sum(dim=1) >= need_t
    bad = (~feas).nonzero()
    assert jstar == (int(bad[0]) if len(bad) else len(need_c))
    return jstar, (taken[1:] - taken[:-1]).to(torch.int32), taken


def _first_changed_row(left, req_c, mask_c, serial_takes):
    """The checked replay's k: the first gang whose capacity row under the
    serial leftover differs from its row under the wave-start leftover (W
    when none does)."""
    live = left
    for j in range(len(req_c)):
        row = port_oracle._member_capacity(live, req_c[j][None, :]) * mask_c[j]
        start = port_oracle._member_capacity(left, req_c[j][None, :]) * mask_c[j]
        if not torch.equal(row, start):
            return j
        live = live - serial_takes[j][:, None] * req_c[j][None, :]
    return len(req_c)


def _partial_keep_scan(left0, group_req, remaining, fit_mask, order, wave):
    """The kernel's wave decomposition in plain PyTorch: a uniform wave
    commits its fill up to its first infeasible gang and replays the rest
    serially; any other wave runs serially, its conflicts flag from the
    checked replay's rule. Checks the speculative partial-keep rule on the
    way. Returns the scan's outputs and the per-wave (conflicts, megas)."""
    n, r = left0.shape
    g = group_req.shape[0]
    steps = -(-g // wave)
    pad = steps * wave - g
    idx = order.long()
    gr = torch.cat([group_req[idx], group_req.new_zeros((pad, r))])
    needs = remaining[idx].tolist() + [0] * pad
    per_group = fit_mask.shape[0] != 1
    mask = fit_mask.to(torch.int32)
    mask = torch.cat([mask[idx], mask.new_zeros((pad, n))]) if per_group else mask
    megas = wave_uniform(group_req, remaining, fit_mask, order, wave)
    left = left0.clone()
    takes = torch.zeros((steps * wave, n), dtype=torch.int32)
    feas = torch.zeros(steps * wave, dtype=torch.bool)
    conflicts = torch.zeros(steps, dtype=torch.bool)
    for s in range(steps):
        lo = s * wave
        req_c, need_c = gr[lo:lo + wave], needs[lo:lo + wave]
        mask_c = mask[lo:lo + wave] if per_group else mask.expand(wave, n)
        serial = port_oracle._serial_steps(left, req_c, need_c, mask_c)
        if bool(megas[s]):
            keep, fast, taken = _first_infeasible(left, req_c[0], need_c, mask_c[0])
            kept_left = left - taken[keep].to(torch.int32)[:, None] * req_c[0][None, :]
            kept_feas = torch.ones(keep, dtype=torch.bool)
            # the rule: the kept gangs' fast takes are their serial takes
            assert torch.equal(fast[:keep], serial[0][:keep]), (s, keep)
            assert torch.equal(kept_feas, serial[1][:keep]), (s, keep)
            rest = port_oracle._serial_steps(kept_left, req_c[keep:], need_c[keep:],
                                             mask_c[keep:])
            takes[lo:lo + wave] = torch.cat([fast[:keep], rest[0]])
            feas[lo:lo + wave] = torch.cat([kept_feas, rest[1]])
            left = rest[2]
            conflicts[s] = keep < wave
        else:
            k, fast = _first_conflict(left, req_c, need_c, mask_c)
            # the rule: the speculative takes before k are the serial takes
            assert torch.equal(fast[:k], serial[0][:k]), (s, k)
            # and the checked replay finds the same k
            assert _first_changed_row(left, req_c, mask_c, serial[0]) == k, (s, k)
            takes[lo:lo + wave], feas[lo:lo + wave], left = serial
            conflicts[s] = k < wave
    alloc = torch.zeros((g, n), dtype=torch.int32)
    placed = torch.zeros(g, dtype=torch.bool)
    alloc[idx] = takes[:g]
    placed[idx] = feas[:g]
    return alloc, placed, left, (conflicts, megas)


@pytest.mark.parametrize("case,wave,mode", FLAG_CASES,
                         ids=[f"{c}-w{w}-{m}" for c, w, m in FLAG_CASES])
def test_partial_keep_rule(case, wave, mode):
    args = _t(*_case(case, mode))
    got = _partial_keep_scan(*args, wave)
    plain = port_oracle.assign_gangs_wavefront(*args, wave=wave, with_stats=True)
    serial = port_oracle.assign_gangs(*args)
    for a, b, c in zip(got[:3], plain[:3], serial):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(got[3], plain[3]):
        assert torch.equal(a, b)


# -- the launch shape ---------------------------------------------------------

# an H100's per-block opt-in shared memory (232,448 bytes) less the wave
# kernel's static shared state: four 128-int rows (the block histogram
# and the uniform branch's three), three 33-int rows, eight ints and two
# mbarriers, padded to 16 bytes
WAVE_STATIC_BYTES = 4 * 4 * 128 + 3 * 4 * 33 + 4 * 8 + 2 * 8
WAVE_STATIC_BYTES = -(-WAVE_STATIC_BYTES // 16) * 16
H100_WAVE_BUDGET = 232448 - WAVE_STATIC_BYTES

# N -> the whole plan at R=5, C <= 16: (C, nodes a block, threads, nodes a
# thread, leftover, dynamic shared bytes, global scratch ints). The bytes
# are worked out by hand from assign_wave.cu's layout: two inboxes of
# kInbox = 16 x 132 ints, two stages of kStageRows + 4 x 32 x R = 740 ints,
# two 128-int histograms a warp, and, when shared, the leftover and its
# wave-start copy (2 x R ints a node slot). At 8192 nodes: 4 x (4224 +
# 1480 + 4096 + 5120) = 59680.
WAVE_PLANS = {
    8: (1, 8, 32, 1, "shared", 25120, 0),                 # race's bucket: one block
    8192: (16, 512, 512, 1, "shared", 59680, 0),          # the north star
    16384: (16, 1024, 1024, 1, "shared", 96544, 0),       # global_leftover's bucket
    32768: (16, 2048, 1024, 2, "shared", 137504, 0),      # the runtime loop, in shared
    262144: (16, 16384, 1024, 16, "global", 55584, 2621440),  # the smoke's global input
}
PLAN_CASES = [(n, w) for n in WAVE_PLANS for w in WAVE_WIDTHS]


@pytest.mark.parametrize("n,wave", PLAN_CASES, ids=[f"n{n}-w{w}" for n, w in PLAN_CASES])
def test_wave_kernel_plan(n, wave):
    r = 5
    plan = wave_kernel_plan(n, r, CLUSTER_SIZES[0], H100_WAVE_BUDGET)
    assert tuple(plan) == WAVE_PLANS[n]
    # the blocks' node ranges tile [0, N): the same split as the serial kernel
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads * plan.per_thread >= plan.block_nodes
    assert plan.cluster_blocks * plan.block_nodes >= n
    # the plan fits the budget, and the leftover goes to global scratch
    # only when its two slabs would not fit beside the fixed part
    assert wave <= 32 and plan.shared_bytes <= H100_WAVE_BUDGET
    if plan.leftover == "global":
        slab_bytes = 4 * plan.scratch_ints // plan.cluster_blocks
        assert plan.shared_bytes + slab_bytes > H100_WAVE_BUDGET
    # the portable cluster size splits the same way with 8 blocks at most
    small = wave_kernel_plan(n, r, CLUSTER_SIZES[1], H100_WAVE_BUDGET)
    assert small.cluster_blocks == min(plan.cluster_blocks, 8)


def test_wave_kernel_plan_bounds():
    # past 64 nodes a thread the plan still exists: the kernel runs a
    # thread's nodes as slabs, from global scratch
    n = 64 * 1024 * 16 + 1
    plan = wave_kernel_plan(n, 5, 16, H100_WAVE_BUDGET)
    assert plan.per_thread == 65 and plan.leftover == "global"
    _assert_tiles_once(plan, n)
    assert wave_kernel_plan(64 * 1024 * 16, 5, 16, H100_WAVE_BUDGET).per_thread == 64
    assert wave_kernel_plan(8192, 5, 16, 1024).leftover == "global"


@pytest.mark.parametrize("n,cluster_max", BIG_BUCKETS, ids=lambda v: str(v))
def test_wave_kernel_plan_past_2_20_nodes(n, cluster_max):
    r = 5
    plan = wave_kernel_plan(n, r, cluster_max, H100_WAVE_BUDGET)
    assert plan.cluster_blocks == cluster_max
    assert plan.threads == 1024 and plan.per_thread == n // (cluster_max * 1024) > 64
    assert plan.leftover == "global"
    # the fixed part alone: inboxes, stages, warp histograms
    assert plan.shared_bytes == 4 * (2 * 16 * 132 + 2 * (100 + 4 * 32 * r) + 2 * 32 * 128)
    # the leftover and its wave-start copy, one slab of each a block
    assert plan.scratch_ints == plan.cluster_blocks * 2 * r * plan.per_thread * plan.threads
    _assert_tiles_once(plan, n)


@pytest.mark.cuda
def test_wave_kernel_matches_plain_past_2_20_nodes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_wave_cuda, wave_scan_plan

    cases = big_bucket_cases()
    # one uniform input besides: every gang has the first one's request
    # row, so each wave of 8 takes the uniform branch through the slabs
    name, (left, req, rem, mask, order) = cases[0]
    cases.append(("uniform broadcast", (left, np.tile(req[:1], (len(req), 1)),
                                        rem % 64, mask, order)))
    for name, arrays in cases:
        args = [torch.from_numpy(a).cuda() for a in arrays]
        plan = wave_scan_plan(args[0].shape[0], 5, torch.cuda.current_device())
        assert plan.per_thread > 64 and plan.leftover == "global", (name, plan)
        got = assign_gangs_wave_cuda(*args, 8)
        plain = port_oracle.assign_gangs_wavefront(*args, wave=8, with_stats=True)
        serial = port_oracle.assign_gangs(*args)
        torch.cuda.synchronize()
        for field, a, b, c in zip(("alloc", "placed", "left_after"), got, plain, serial):
            assert torch.equal(a, b) and torch.equal(a, c), (name, field)
        for a, b in zip(got[3], plain[3]):
            assert torch.equal(a, b), (name, "flags")
        if name == "uniform broadcast":
            assert bool(got[3][1].all()), "every wave takes the uniform branch"


# -- the build digest ---------------------------------------------------------

def test_build_digest_follows_included_headers(tmp_path):
    """An edited header changes the digest of every source that includes it
    (so the library rebuilds); a header no source includes does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    scan, wave = csrc / "assign_scan.cu", csrc / "assign_wave.cu"
    before = (_build.digest(scan), _build.digest(wave))
    assert before == (_build.digest(_build.CSRC_DIR / "assign_scan.cu"),
                      _build.digest(_build.CSRC_DIR / "assign_wave.cu"))
    (csrc / "unused.cuh").write_text("// not included\n")
    assert (_build.digest(scan), _build.digest(wave)) == before
    header = csrc / "cluster_scan.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = (_build.digest(scan), _build.digest(wave))
    assert after[0] != before[0] and after[1] != before[1]
    wave.write_text(wave.read_text() + "\n// edited\n")
    assert _build.digest(wave) != after[1] and _build.digest(scan) == after[0]
