"""The batch head (``ops.batch_kernels``: the leftover, the capacity matrix,
the policy's anti-affinity fold, the gang feasibility and the scores)
against the JAX package on the CPU: the port's ``schedule_batch`` and
``batch_head_cuda`` (its plain version on CPU tensors) against the
reference's ``schedule_batch`` on padded batches in both mask modes, with
zero-request rows, invalid groups, roomy and overcommitted nodes, and a
policy with and without the anti-affinity term; the mesh's block, finish
and leftover modes assembled against the whole head; numpy models of the
kernel's in-kernel multiply-shift division and of its int64 feasibility
sum; the bound's count; and, on a card, the CUDA kernel against the plain
version. Every output is an integer: every comparison is exact
(tolerance zero)."""

import re

import numpy as np
import pytest
import torch

try:
    from batch_scheduler_tpu.ops import oracle as jax_oracle
    from batch_scheduler_tpu.ops.bucketing import pad_oracle_batch
    from batch_scheduler_tpu.policy import terms as jax_terms
except ImportError:  # a GPU machine without JAX runs only the `cuda` tests here
    jax_oracle = pad_oracle_batch = jax_terms = None
from batch_scheduler_tpu_torch.ops import _build, batch_kernels as bk, bounds
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.assign_scan import division_magic
from batch_scheduler_tpu_torch.ops.convert import batch_from_numpy, policy_from_numpy
from batch_scheduler_tpu_torch.policy import terms as port_terms

HEAD_KEYS = ("left", "capacity", "gang_feasible", "scores")


def padded_batch(n, g, r=3, seed=0, per_group=False, zero_rows=(), invalid=(),
                 left_hi=60, req_hi=5, rem_hi=14, roomy=0.15, overcommit=0.0,
                 remaining=None, left=None, group_req=None):
    """A seeded batch through the reference's ``pad_oracle_batch``:
    ``(batch_args, progress_args)``. ``roomy`` nodes have 4,000 free in
    every lane (capacities past 127), ``overcommit`` nodes more requested
    than allocatable (a negative leftover); ``zero_rows`` request nothing
    (capacity 2^30 where the mask allows), ``invalid`` groups are not
    valid. ``remaining``, ``left`` and ``group_req`` override the seeded
    ones."""
    rng = np.random.default_rng(seed)
    if left is None:
        left = rng.integers(0, left_hi, size=(n, r)).astype(np.int64)
        left[rng.random(n) < roomy] = 4000
    n, r = left.shape
    requested = rng.integers(0, 3, size=(n, r)).astype(np.int64)
    alloc = left + requested
    over = rng.random(n) < overcommit
    requested[over] = alloc[over] + rng.integers(1, 9, size=(int(over.sum()), r))
    if group_req is None:
        group_req = rng.integers(0, req_hi, size=(g, r))
        group_req[:, 0] = np.maximum(group_req[:, 0], 1)
        group_req[list(zero_rows)] = 0
    if remaining is None:
        remaining = rng.integers(0, rem_hi, size=g)
    if per_group:
        mask = rng.random((g, n)) < 0.8
    else:
        mask = np.ones((1, n), bool)
        mask[0, rng.random(n) < 0.1] = False
    valid = np.ones(g, bool)
    valid[list(invalid)] = False
    return pad_oracle_batch(
        alloc=alloc.astype(np.int32), requested=requested.astype(np.int32),
        group_req=np.asarray(group_req, np.int32), remaining=np.asarray(remaining, np.int32),
        fit_mask=mask, group_valid=valid, order=rng.permutation(g).astype(np.int32),
        min_member=(np.asarray(remaining) + rng.integers(0, 3, size=g)).astype(np.int32),
        scheduled=rng.integers(0, 3, size=g).astype(np.int32),
        matched=rng.integers(0, 4, size=g).astype(np.int32),
        ineligible=rng.random(g) < 0.2,
        creation_rank=rng.permutation(g).astype(np.int32),
    )


def policy_cols(rng, n, g, anti_share=0.4):
    """(prio, aff, anti, gang_dom, node_hash, node_dom) int32 over a small
    label vocabulary, so anti-affinity hits and misses."""
    vocab = np.array([0] + [port_terms.label_hash(k, v) for k, v in
                            (("pool", "p0"), ("pool", "p1"), ("team", "red"),
                             ("zone", "z3"))], np.int64)
    node_hash = vocab[rng.integers(0, len(vocab), size=(n, port_terms.HASH_LANES))]
    node_dom = rng.integers(0, 16, size=n)
    aff = np.where(rng.random(g) < 0.5, vocab[rng.integers(1, len(vocab), size=g)], 0)
    anti = np.where(rng.random(g) < anti_share, vocab[rng.integers(1, len(vocab), size=g)], 0)
    gang_dom = rng.integers(0, 4, size=(g, 16))
    prio = rng.integers(0, 3, size=g)
    return tuple(np.asarray(c, np.int32) for c in
                 (prio, aff, anti, gang_dom, node_hash, node_dom))


HEAD_CASES = {
    "broadcast": dict(n=37, g=11),
    "per-group": dict(n=50, g=13, per_group=True, seed=1),
    "zero-request-rows": dict(n=29, g=9, zero_rows=(0, 4), seed=2),
    "invalid-groups": dict(n=40, g=12, invalid=(1, 5, 11), per_group=True, seed=3),
    "overcommitted-nodes": dict(n=33, g=10, overcommit=0.3, seed=4),
    "wide-lanes": dict(n=70, g=20, r=11, per_group=True, seed=5, req_hi=3),
    "needs-past-capacity": dict(n=24, g=16, rem_hi=400, seed=6),
}


def _port_head(batch_args, **kw):
    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    return port_oracle.schedule_batch(*batch, **kw), batch


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_head_matches_reference(case):
    """The port's head (schedule_batch on the CPU) equals the reference's,
    and the wrapper on CPU tensors is that head."""
    batch_args, _ = padded_batch(**HEAD_CASES[case])
    want = jax_oracle.schedule_batch(*batch_args)
    out, batch = _port_head(batch_args)
    for key in HEAD_KEYS:
        got = out[key].numpy()
        ref = np.asarray(want[key])
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    alloc, requested, group_req, remaining, fit_mask, group_valid, _ = batch
    direct = bk.batch_head_cuda(alloc, requested, group_req, remaining, fit_mask, group_valid)
    for key, t in zip(HEAD_KEYS, direct):
        assert torch.equal(t, out[key]), key


@pytest.mark.parametrize("terms", [
    ("affinity", "anti-affinity", "spread"), ("anti-affinity",), ("affinity", "spread"),
], ids=["all-terms", "anti-only", "no-anti"])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per-group"])
def test_head_policy_fold_matches_reference(terms, per_group):
    """With a policy the anti-affinity term zeroes the capacity of the
    nodes carrying the gang's label (and with it feasibility and scores);
    without the term the head is the plain one."""
    batch_args, _ = padded_batch(n=45, g=14, per_group=per_group, seed=9)
    nb, gb = batch_args[0].shape[0], batch_args[2].shape[0]
    cols = policy_cols(np.random.default_rng(9), nb, gb)
    weights = (32, 8, 3)[:len(terms)]
    want = jax_oracle.schedule_batch(*batch_args, policy_cols=cols, policy_terms=terms,
                                     policy_weights=weights)
    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    out = port_oracle.schedule_batch(*batch, policy=(policy_from_numpy(cols, "cpu"), terms,
                                                     weights))
    for key in HEAD_KEYS:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(want[key]), err_msg=key)
    plain, _ = _port_head(batch_args)
    folded = not torch.equal(out["capacity"], plain["capacity"])
    assert folded == ("anti-affinity" in terms), terms


def test_head_fold_matches_the_terms_product():
    """The wrapper's fold (anti and node_hash) is compose_keep_dense's
    product, the reference's."""
    rng = np.random.default_rng(12)
    batch_args, _ = padded_batch(n=30, g=10, seed=12, per_group=True)
    nb, gb = batch_args[0].shape[0], batch_args[2].shape[0]
    cols = policy_cols(rng, nb, gb, anti_share=0.8)
    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    alloc, requested, group_req, remaining, fit_mask, group_valid, _ = batch
    anti, node_hash = torch.from_numpy(cols[2]), torch.from_numpy(cols[4])
    left, cap, feasible, scores = bk.batch_head_cuda(alloc, requested, group_req, remaining,
                                                     fit_mask, group_valid, anti, node_hash)
    _, plain_cap, _, _ = bk.batch_head_plain(alloc, requested, group_req, remaining, fit_mask,
                                             group_valid)
    keep = np.asarray(jax_terms.compose_keep_dense(("anti-affinity",), cols[2], cols[4]))
    np.testing.assert_array_equal(cap.numpy(), plain_cap.numpy() * keep)
    assert (keep == 0).any() and (keep == 1).any()


@pytest.mark.parametrize("ranks", [2, 3, 4])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per-group"])
def test_mesh_modes_assemble_the_whole_head(ranks, per_group):
    """The replicated rung's modes: each rank's zero-padded block (the
    mask's rows read in place), assembled, is the whole capacity matrix;
    the finish on it gives the whole feasibility and scores; the leftover
    mode is the leftover."""
    batch_args, _ = padded_batch(n=53, g=19, per_group=per_group, seed=ranks)
    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    alloc, requested, group_req, remaining, fit_mask, group_valid, _ = batch
    left, cap, feasible, scores = bk.batch_head_cuda(alloc, requested, group_req, remaining,
                                                     fit_mask, group_valid)
    g, n = cap.shape
    gb, nb = -(-g // ranks), -(-n // ranks)
    whole = torch.full((g, n), -7, dtype=torch.int32)
    for rank in range(ranks * ranks):  # a ranks x ranks grid of blocks
        gi, ni = divmod(rank, ranks)
        glo, ghi = min(gi * gb, g), min((gi + 1) * gb, g)
        nlo, nhi = min(ni * nb, n), min((ni + 1) * nb, n)
        got_left, block = bk.head_block_cuda(alloc, requested, group_req, fit_mask,
                                             (glo, ghi), (nlo, nhi), (gb, nb),
                                             with_left=rank == 0)
        assert block.shape == (gb, nb)
        assert (block[ghi - glo:] == 0).all() and (block[:, nhi - nlo:] == 0).all()
        whole[glo:ghi, nlo:nhi] = block[:ghi - glo, :nhi - nlo]
        assert (got_left is not None) == (rank == 0)
        if got_left is not None:
            assert torch.equal(got_left, left)
    assert torch.equal(whole, cap)
    got_feasible, got_scores = bk.head_finish_cuda(whole, remaining, group_valid)
    assert torch.equal(got_feasible, feasible) and torch.equal(got_scores, scores)
    assert torch.equal(bk.head_left_cuda(alloc, requested), left)


def test_head_wrappers_refuse_bad_inputs():
    batch_args, _ = padded_batch(n=20, g=6, seed=1)
    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    alloc, requested, group_req, remaining, fit_mask, group_valid, _ = batch
    with pytest.raises(ValueError, match="fit_mask"):
        bk.batch_head_cuda(alloc, requested, group_req, remaining, fit_mask[:, :-1], group_valid)
    with pytest.raises(ValueError, match="together"):
        bk.batch_head_cuda(alloc, requested, group_req, remaining, fit_mask, group_valid,
                           anti=remaining)
    with pytest.raises(TypeError, match="int32"):
        bk.batch_head_cuda(alloc.long(), requested, group_req, remaining, fit_mask, group_valid)
    with pytest.raises(ValueError, match="does not fit"):
        bk.head_block_cuda(alloc, requested, group_req, fit_mask, (0, 5), (0, 9), (4, 9))
    before = bk.batch_head_cuda.launches
    bk.batch_head_cuda(alloc, requested, group_req, remaining, fit_mask, group_valid)
    assert bk.batch_head_cuda.launches == before  # the plain version launches nothing


# -- numpy models of the kernel's decomposition -------------------------------

def kernel_magic(d):
    """csrc/batch_head.cu's numbers for divisors d >= 1: the shift
    l = 32 - clz(d - 1) (0 for d = 1) and m = 2^(31+l) // d + 1 (32 bits)."""
    d = np.asarray(d, np.uint64)
    l = np.array([int(x - 1).bit_length() if x > 1 else 0 for x in d], np.uint64)
    m = ((np.uint64(1) << (np.uint64(31) + l)) // d + np.uint64(1)).astype(np.uint64)
    return m, l


def kernel_div(v, m, l):
    """umulhi(v, m) >> (l - 1), v itself for l = 0."""
    v = np.asarray(v, np.uint64)
    hi = (v * m) >> np.uint64(32)
    return np.where(l == 0, v, hi >> np.maximum(l, np.uint64(1)) - np.uint64(1)).astype(np.int64)


def _edge_divisors():
    ds = {1, 2, 3, 5, 7, 10, 1000, 4000, 2**30 - 1, 2**30}
    for b in range(1, 31):
        ds.update({2**b - 1, 2**b, min(2**b + 1, 2**30)})
    return np.array(sorted(ds), np.int64)


def test_magic_division_model_is_exact_on_the_edges():
    """The in-kernel numbers equal division_magic's, and floor(v / d) is
    exact for every edge of [0, 2^30] x [1, 2^30]."""
    d = _edge_divisors()
    m, l = kernel_magic(d)
    magic, shift = division_magic(torch.from_numpy(d.astype(np.int32)))
    assert np.array_equal(l.astype(np.int64), shift.numpy().astype(np.int64))
    assert np.array_equal(m.astype(np.int64), magic.numpy().astype(np.int64) % 2**32)
    rng = np.random.default_rng(0)
    for di, mi, li in zip(d, m, l):
        v = np.unique(np.clip(np.concatenate([
            [0, 1, 2, 2**30 - 1, 2**30, 2**29, 2**30 - di],
            np.array([1, 2, 3, 1000]) * di - 1, np.array([1, 2, 3, 1000]) * di,
            rng.integers(0, 2**30 + 1, size=64)]), 0, 2**30)).astype(np.int64)
        got = kernel_div(v, np.full(v.shape, mi, np.uint64), np.full(v.shape, li, np.uint64))
        np.testing.assert_array_equal(got, v // di, err_msg=f"d={di}")


def feasibility_model(cap, remaining, valid, blocks=8, threads=256):
    """The kernel's sum: each block of the row's cluster takes a chunk,
    each thread the nodes at its stride, partials in int64, summed by the
    cluster's first block."""
    g, n = cap.shape
    chunk = -(-n // blocks)
    clipped = np.minimum(cap.astype(np.int64), remaining.astype(np.int64)[:, None])
    total = np.zeros(g, np.int64)
    for b in range(blocks):
        part = clipped[:, b * chunk:(b + 1) * chunk]
        per_thread = [part[:, t::threads].sum(axis=1) for t in range(min(threads, part.shape[1]))]
        total += np.sum(per_thread, axis=0) if per_thread else 0
    return (total >= remaining) & valid, total


def test_feasibility_sum_model_is_exact_past_int32():
    """At 2^21 nodes a 2^18-member gang's clipped sum reaches 2^39: the
    kernel's int64 partials keep it exact where an int32 sum wraps (here
    to a value below the need); on a small batch the model is the
    reference's feasibility."""
    n, need = 2**21, 2**18
    cap = np.full((1, n), 2**30, np.int32)
    ok, total = feasibility_model(cap, np.array([need], np.int32), np.array([True]))
    assert total[0] == n * need == 2**39 and ok[0]
    assert np.int64(total[0]).astype(np.int32) < need  # what an int32 sum would compare
    batch_args, _ = padded_batch(n=61, g=17, per_group=True, seed=21, rem_hi=60)
    want = jax_oracle.schedule_batch(*batch_args)
    got, _ = feasibility_model(np.asarray(want["capacity"]), batch_args[3], batch_args[5],
                               blocks=3, threads=8)
    np.testing.assert_array_equal(got, np.asarray(want["gang_feasible"]))


def test_head_work_counts_the_north_star():
    """head_work at the north star [1024, 8192, 5] with a broadcast mask:
    its two [G, N] int32 writes dominate (64 MiB), so it is bound by bytes;
    head_bound counts the same from the tensors."""
    g, n, r = 1024, 8192, 5
    nbytes, ops = bounds.head_work(n, r, g, 1, 3 * g)
    assert nbytes == (2 * n * r * 4 + g * r * 4 + g * 4 + g + n + n * r * 4
                      + 2 * g * n * 4 + g)
    assert 2 * g * n * 4 < nbytes < 2 * g * n * 4 + 2**20
    assert ops == n * 9 * g + 5 * g * n
    assert bounds.bound(nbytes, ops)[1] == "bytes"
    batch_args, _ = padded_batch(n=40, g=12, per_group=True, seed=3)
    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    alloc, requested, group_req, remaining, fit_mask, group_valid, _ = batch
    got = bounds.head_bound(alloc, requested, group_req, remaining, fit_mask, group_valid)
    gb, nb = group_req.shape[0], alloc.shape[0]
    want = bounds.head_work(nb, alloc.shape[1], gb, gb, int((group_req > 0).sum()))
    assert got[2:] == want and got[:2] == bounds.bound(*want)


def test_head_source_limits_match_the_wrapper():
    """batch_head.cu is a library of its own and its limits are the
    wrapper's (32 lanes, 8 hash lanes)."""
    assert "batch_head" not in _build.VARIANTS
    text = (_build.CSRC_DIR / "batch_head.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kMaxLanes"]) == bk._MAX_LANES
    assert int(consts["kMaxHash"]) == bk._MAX_HASH >= port_terms.HASH_LANES
    assert "bst_batch_head" in text and "cudaLaunchKernelEx" in text


# -- on the card ---------------------------------------------------------------

def _card_head_cases(rng):
    for n, g, r, per_group, anti in ((8, 8, 3, False, False), (5003, 1000, 11, True, False),
                                     (8192, 1024, 5, False, False), (3000, 40, 5, True, True),
                                     (2**21, 16, 4, False, False), (1000, 3000, 5, False, True)):
        left = rng.integers(0, 3000, size=(n, r)).astype(np.int32)
        left[rng.random(n) < 0.05] = -5
        requested = rng.integers(0, 40, size=(n, r)).astype(np.int32)
        req = rng.integers(0, 40, size=(g, r)).astype(np.int32)
        req[rng.random(g) < 0.05] = 0
        rem = rng.integers(0, 2000, size=g).astype(np.int32)
        mask = rng.random((g if per_group else 1, n)) < 0.8
        valid = rng.random(g) < 0.9
        extra = None
        if anti:
            cols = policy_cols(rng, n, g)
            extra = (cols[2], cols[4])
        yield (left + requested, requested, req, rem, mask, valid), extra


@pytest.mark.cuda
def test_head_kernel_matches_plain_on_card():
    """Every mode of the head kernel against its plain version on the
    card: the whole batch (both mask modes, 3-11 lanes, the anti-affinity
    fold, 2^21 nodes), blocks of the replicated rung, the finish and the
    leftover alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(4)
    for args, extra in _card_head_cases(rng):
        cpu = tuple(torch.from_numpy(a) for a in args)
        fold = tuple(torch.from_numpy(a) for a in extra) if extra else (None, None)
        want = bk.batch_head_plain(*cpu, *fold)
        got = bk.batch_head_cuda(*(t.cuda() for t in cpu),
                                 *(t.cuda() if t is not None else None for t in fold))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), tuple(a.shape)
        g, n = want[1].shape
        cuda = tuple(t.cuda() for t in cpu)
        for ranks in (2, 4):
            gb, nb = -(-g // ranks), -(-n // ranks)
            for rank in range(ranks * ranks):
                gi, ni = divmod(rank, ranks)
                blk = ((min(gi * gb, g), min((gi + 1) * gb, g)),
                       (min(ni * nb, n), min((ni + 1) * nb, n)), (gb, nb))
                _, b_cpu = bk.head_block_cuda(cpu[0], cpu[1], cpu[2], cpu[4], *blk)
                left, b_gpu = bk.head_block_cuda(cuda[0], cuda[1], cuda[2], cuda[4], *blk,
                                                 with_left=True)
                assert torch.equal(b_gpu.cpu(), b_cpu) and torch.equal(left.cpu(), want[0])
        cap = want[1].cuda()
        feasible, scores = bk.head_finish_cuda(cap, cuda[3], cuda[5])
        ref = bk.head_finish_cuda(want[1], cpu[3], cpu[5])
        assert torch.equal(feasible.cpu(), ref[0]) and torch.equal(scores.cpu(), ref[1])
        assert torch.equal(bk.head_left_cuda(cuda[0], cuda[1]).cpu(), want[0])


@pytest.mark.cuda
def test_topk_kernel_after_the_head_kernel_on_card():
    """The top-K kernel right after the head kernel (whose static shared
    memory it then finds on the SMs) on uniform north-star waves: equal to
    the plain top-K scan on every run. Its uniform branch read the member
    stream's total before the block barrier that publishes it, and so the
    value the previous kernel left in shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_topk_cuda

    rng = np.random.default_rng(3)
    n, g, r = 8192, 1024, 5
    alloc = np.tile(np.array([[64000, 256 << 10, 110, 8, 100]], np.int32), (n, 1))
    requested = (alloc * (rng.random((n, r)) < 0.3) // 2).astype(np.int32)
    req = np.tile(np.array([[4000, 8 << 10, 1, 1, 0]], np.int32), (g, 1))
    rem = np.full(g, 10, np.int32)
    mask = np.ones((1, n), bool)
    valid = np.ones(g, bool)
    order = np.arange(g, dtype=np.int32)
    cpu = [torch.from_numpy(a) for a in (alloc, requested, req, rem, mask, valid, order)]
    left = cpu[0] - cpu[1]
    for k in (16, 128):
        want = port_oracle.assign_gangs_topk(left, cpu[2], cpu[3], cpu[4], cpu[6], wave=8, k=k,
                                             with_stats=True)
        cuda = [t.cuda() for t in cpu]
        for _ in range(4):
            head = bk.batch_head_cuda(*cuda[:6])
            got = assign_gangs_topk_cuda(head[0], cuda[2], cuda[3], cuda[4], cuda[6], 8, k)
            for a, b in zip(list(got[:3]) + list(got[3]), list(want[:3]) + list(want[3])):
                assert torch.equal(a.cpu(), b), k
