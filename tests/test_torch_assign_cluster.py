"""The serial scan kernel's host-side arithmetic, on the CPU: the exact
multiply-shift division numbers (``division_magic``) the kernel divides by,
and the cluster launch shape (``kernel_plan``) it lays the nodes out by, up
to buckets past 2^20 nodes; on a card, the kernel against the plain scan
there. Every comparison is exact (integers, tolerance zero)."""

import numpy as np
import pytest
import torch

from batch_scheduler_tpu_torch.ops.assign_scan import CLUSTER_SIZES, division_magic, kernel_plan

LANE_MAX = 2**30
# an H100's per-block opt-in shared memory (232,448 bytes) less the
# kernel's static arrays: the block histogram, two inboxes of 16 block
# histograms, two mbarriers and four ints
H100_SHARED_BUDGET = 232448 - (4 * (128 + 2 * 16 * 128) + 2 * 8 + 4 * 4)


def _kernel_floordiv(v, magic, shift):
    """The kernel's quotient: umulhi(v, m) >> (l - 1), and v when l = 0."""
    m = magic.to(torch.int64) & 0xFFFFFFFF
    hi = (v * m) >> 32
    return torch.where(shift == 0, v, hi >> (shift.to(torch.int64) - 1).clamp(min=0))


def _numerators(d):
    """0, 1, d-1, d, d+1, k*d-1, k*d, k*d+1 and 2^30, inside [0, 2^30]."""
    k = np.array([2, 3, 7, 127, 128, 1000, 65537])
    v = np.concatenate([[0, 1, d - 1, d, d + 1, LANE_MAX],
                        (k * d - 1), k * d, k * d + 1, [LANE_MAX // d * d, LANE_MAX // d * d - 1]])
    return np.unique(v[(v >= 0) & (v <= LANE_MAX)])


def _check_divisors(divisors, rng):
    d = torch.tensor(divisors, dtype=torch.int64)
    magic, shift = division_magic(d.to(torch.int32))
    assert magic.dtype == torch.int32 and shift.dtype == torch.int32
    for i, di in enumerate(divisors):
        v = _numerators(int(di))
        v = np.concatenate([v, rng.integers(0, LANE_MAX + 1, size=64)])
        vt = torch.from_numpy(v.astype(np.int64))
        got = _kernel_floordiv(vt, magic[i].expand(len(v)), shift[i].expand(len(v)))
        np.testing.assert_array_equal(got.numpy(), v // int(di), err_msg=f"d={di}")


@pytest.mark.parametrize("k", range(31))
def test_division_magic_exact_near_powers_of_two(k):
    """Divisors 2^k - 1, 2^k and 2^k + 1 in [1, 2^30]."""
    divisors = [d for d in (2**k - 1, 2**k, 2**k + 1) if 1 <= d <= LANE_MAX]
    _check_divisors(divisors, np.random.default_rng(k))


@pytest.mark.parametrize("seed", range(4))
def test_division_magic_exact_random_divisors(seed):
    rng = np.random.default_rng(100 + seed)
    small = rng.integers(1, 4096, size=24)
    large = rng.integers(1, LANE_MAX + 1, size=24)
    by_width = 2 ** rng.integers(0, 30, size=24) + rng.integers(0, 2**10, size=24)
    divisors = np.unique(np.clip(np.concatenate([small, large, by_width]), 1, LANE_MAX))
    _check_divisors(divisors.tolist(), rng)


def test_division_magic_fits_32_bits_and_clamps():
    d = torch.tensor([-7, 0, 1, 2, 3, 2**29 + 1, 2**30 - 1, 2**30], dtype=torch.int32)
    magic, shift = division_magic(d)
    m = magic.to(torch.int64) & 0xFFFFFFFF
    # m = floor(2^(31+l) / d) + 1 with d clamped to [1, 2^30]
    dc = d.to(torch.int64).clamp(1, LANE_MAX)
    assert shift.tolist() == [0, 0, 0, 1, 2, 30, 30, 30]
    assert m.tolist() == [(2 ** (31 + int(l))) // int(x) + 1 for l, x in zip(shift, dc)]
    assert bool((m < 2**32).all()) and bool((m > 2**31).all())
    # requests <= 0 divide like a request of 1 (the kernel skips those lanes)
    v = torch.tensor([0, 5, LANE_MAX], dtype=torch.int64)
    assert _kernel_floordiv(v, magic[0].expand(3), shift[0].expand(3)).tolist() == v.tolist()


def _kernel_layout(plan, n):
    """Each thread's node run (n0, cnt) as the kernel computes it from the
    plan: block b's range [b0, b1), thread t's run from b0 + t * per."""
    runs = []
    for b in range(plan.cluster_blocks):
        b0 = min(b * plan.block_nodes, n)
        b1 = min(b0 + plan.block_nodes, n)
        assert b1 - b0 <= plan.threads * plan.per_thread
        for t in range(plan.threads):
            n0 = min(b0 + t * plan.per_thread, b1)
            runs.append((n0, min(n0 + plan.per_thread, b1) - n0))
    return runs


# (N, cluster_max) -> (C, nodes a block, threads, nodes a thread, leftover)
PLANS = {
    (8, 16): (1, 8, 32, 1, "shared"),          # race's bucket: one block
    (8192, 16): (16, 512, 512, 1, "shared"),   # the north star
    (8192, 8): (8, 1024, 1024, 1, "shared"),
    (16384, 16): (16, 1024, 1024, 1, "shared"),  # global_leftover's bucket
    (16384, 8): (8, 2048, 1024, 2, "shared"),
    (262144, 16): (16, 16384, 1024, 16, "global"),  # the smoke's global-scratch input
    (262144, 8): (8, 32768, 1024, 32, "global"),
}


@pytest.mark.parametrize("n,cluster_max", sorted(PLANS), ids=lambda v: str(v))
def test_kernel_plan_at_smoke_shapes(n, cluster_max):
    r = 5
    plan = kernel_plan(n, r, cluster_max, H100_SHARED_BUDGET)
    want = PLANS[(n, cluster_max)]
    assert (plan.cluster_blocks, plan.block_nodes, plan.threads, plan.per_thread,
            plan.leftover) == want
    assert cluster_max in CLUSTER_SIZES
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    # the blocks' node ranges tile [0, N) and the threads' runs cover each once
    covered = np.zeros(n, np.int64)
    for n0, cnt in _kernel_layout(plan, n):
        covered[n0:n0 + cnt] += 1
    assert (covered == 1).all()
    # two staged gang rows, (request, magic, shift, -) a lane, and two
    # 128-bin histograms a warp
    fixed_bytes = 4 * 8 * r + 4 * 2 * 128 * plan.threads // 32
    leftover_ints = r * plan.per_thread * plan.threads
    if plan.leftover == "shared":
        assert plan.shared_bytes == fixed_bytes + 4 * leftover_ints <= H100_SHARED_BUDGET
        assert plan.scratch_ints == 0
    else:
        assert fixed_bytes + 4 * leftover_ints > H100_SHARED_BUDGET
        assert plan.shared_bytes == fixed_bytes
        assert plan.scratch_ints == plan.cluster_blocks * leftover_ints


def _assert_tiles_once(plan, n):
    covered = np.zeros(n, np.int64)
    for n0, cnt in _kernel_layout(plan, n):
        covered[n0:n0 + cnt] += 1
    assert (covered == 1).all()


def test_kernel_plan_bounds():
    # a budget too small for the leftover sends it to global scratch
    assert kernel_plan(8192, 5, 16, 1024).leftover == "global"
    # more lanes than one block's threads can stage
    with pytest.raises(ValueError, match="lanes"):
        kernel_plan(8192, 342, 16, H100_SHARED_BUDGET)
    # past 64 nodes a thread the plan still exists: the kernel runs a
    # thread's nodes as slabs, from global scratch
    n = 64 * 1024 * 8 + 1
    plan = kernel_plan(n, 5, 8, H100_SHARED_BUDGET)
    assert plan.per_thread == 65 and plan.leftover == "global"
    _assert_tiles_once(plan, n)
    # C never exceeds the cap and leaves each block >= 256 nodes
    for n in (1, 255, 256, 511, 512, 4095, 4096, 5000, 10000):
        plan = kernel_plan(n, 5, 16, H100_SHARED_BUDGET)
        assert plan.cluster_blocks <= 16
        assert plan.cluster_blocks == 1 or n // plan.cluster_blocks >= 256


# the buckets past 2^20 nodes that the reference admits (pad_oracle_batch
# bounds only the gang, by (2^31 - 1) // N): 128 and 256 nodes a thread at
# 16 blocks, 256 and 512 at 8
BIG_BUCKETS = [(n, c) for n in (2**21, 2**22) for c in CLUSTER_SIZES]


@pytest.mark.parametrize("n,cluster_max", BIG_BUCKETS, ids=lambda v: str(v))
def test_kernel_plan_past_2_20_nodes(n, cluster_max):
    r = 5
    plan = kernel_plan(n, r, cluster_max, H100_SHARED_BUDGET)
    assert plan.cluster_blocks == cluster_max
    assert plan.threads == 1024 and plan.per_thread == n // (cluster_max * 1024) > 64
    assert plan.leftover == "global"
    assert plan.shared_bytes == 4 * 8 * r + 4 * 2 * 128 * plan.threads // 32
    assert plan.scratch_ints == plan.cluster_blocks * r * plan.per_thread * plan.threads
    _assert_tiles_once(plan, n)


def _one_bin_case(n, g, rows):
    """Every node holds 4 members of every gang: a gang of 3,001 fills its
    threshold bin over 751 nodes, across several threads' slabs, and splits
    node 750; gangs 1 and 2 need nothing, gang 3 never fits."""
    left = np.tile(np.array([[4000, 16, 8, 4, 10**6]], np.int32), (n, 1))
    req = np.tile(np.array([[1000, 4, 2, 1, 0]], np.int32), (g, 1))
    rem = np.full(g, 3001, np.int32)
    rem[1] = rem[2] = 0
    rem[3] = 10**6
    mask = np.ones((rows, n), bool)
    if rows > 1:
        mask[4, ::3] = False
    return left, req, rem, mask, np.arange(g, dtype=np.int32)


def big_bucket_cases(n=2**21):
    """(name, (left, group_req, remaining, fit_mask, order)) at a bucket
    past 2^20 nodes, for the kernels against the plain scans on the card."""
    rng = np.random.default_rng(21)

    def rand(g, rows):
        return (rng.integers(0, 2000, size=(n, 5)).astype(np.int32),
                rng.integers(0, 40, size=(g, 5)).astype(np.int32),
                rng.integers(0, 300, size=g).astype(np.int32),
                rng.random((rows, n)) < 0.8, rng.permutation(g).astype(np.int32))

    return [("broadcast", rand(16, 1)), ("per-group", rand(16, 16)),
            ("one bin broadcast", _one_bin_case(n, 16, 1)),
            ("one bin per-group", _one_bin_case(n, 16, 16))]


@pytest.mark.cuda
def test_kernel_matches_plain_past_2_20_nodes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_plain, scan_plan)

    for name, arrays in big_bucket_cases():
        args = [torch.from_numpy(a).cuda() for a in arrays]
        plan = scan_plan(args[0].shape[0], 5, torch.cuda.current_device())
        assert plan.per_thread > 64 and plan.leftover == "global", (name, plan)
        got = assign_gangs_cuda(*args)
        want = assign_gangs_plain(*args)
        torch.cuda.synchronize()
        for field, a, b in zip(("alloc", "placed", "left_after"), got, want):
            assert torch.equal(a, b), (name, field)
        if name.startswith("one bin"):
            assert want[0][0, :751].tolist() == [4] * 750 + [1], name
