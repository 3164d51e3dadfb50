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
    """csrc/batch_head.cu's div2: umulhi(2v, m) >> l, which is umulhi(v, m)
    >> (l - 1) for l >= 1 and v itself for l = 0 (2v <= 2^31 fits 32 bits)."""
    v2 = np.asarray(v, np.uint64) * np.uint64(2)
    assert (v2 < np.uint64(2**32)).all()
    return (((v2 * m) >> np.uint64(32)) >> l).astype(np.int64)


def _edge_divisors():
    ds = {1, 2, 3, 5, 7, 10, 1000, 4000, 2**30 - 1, 2**30}
    for b in range(1, 31):
        ds.update({2**b - 1, 2**b, min(2**b + 1, 2**30)})
    return np.array(sorted(ds), np.int64)


def test_magic_division_model_is_exact_on_the_edges():
    """The in-kernel numbers equal division_magic's, and the kernel's
    umulhi(2v, m) >> l is floor(v / d) (and the former umulhi(v, m) >>
    (l - 1), v for d = 1) for every edge of [0, 2^30] x [1, 2^30]."""
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
        former = v if li == 0 else ((v.astype(np.uint64) * mi) >> np.uint64(32)) >> (li - 1)
        np.testing.assert_array_equal(got, former.astype(np.int64), err_msg=f"d={di}")


def feasibility_model(cap, remaining, valid, blocks=8, threads=256, per=4):
    """The kernel's sum: a row's nodes in tiles of threads * per, block c
    of the row's cluster taking tiles c, c + blocks, ..., each thread its
    per consecutive nodes of a tile into its own int64 slot; the slots
    summed a warp and then a block at a time, the blocks' partials by the
    cluster's first block."""
    g, n = cap.shape
    tile = threads * per
    tiles = max(1, -(-n // tile))
    clipped = np.minimum(cap.astype(np.int64), remaining.astype(np.int64)[:, None])
    padded = np.zeros((g, tiles * tile), np.int64)
    padded[:, :n] = clipped
    quads = padded.reshape(g, tiles, threads, per).sum(axis=3)  # a thread's tile partial
    total = np.zeros(g, np.int64)
    for b in range(min(blocks, tiles)):
        slots = quads[:, b::blocks].sum(axis=1)  # [g, threads]
        warps = slots.reshape(g, -1, min(32, threads)).sum(axis=2)
        total += warps.sum(axis=1)
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
    """batch_head.cu is a library of its own, its limits are the wrapper's
    (32 lanes, 8 hash lanes) and its launch constants are
    head_kernel_plan's."""
    assert "batch_head" not in _build.VARIANTS
    text = (_build.CSRC_DIR / "batch_head.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kMaxLanes"]) == bk._MAX_LANES
    assert int(consts["kMaxHash"]) == bk._MAX_HASH >= port_terms.HASH_LANES
    for name, value in (("kThreads", bk._HEAD_THREADS), ("kNodesThread", bk._HEAD_NODES_THREAD),
                        ("kRegLanes", bk._HEAD_REG_LANES), ("kMaxCluster", bk._HEAD_MAX_CLUSTER),
                        ("kMinTile", bk._HEAD_MIN_TILE),
                        ("kMaxTile", bk._HEAD_MAX_TILE), ("kMinBlocks", bk._HEAD_MIN_BLOCKS),
                        ("kSharedBudget", bk._HEAD_SHARED_BUDGET)):
        assert int(consts[name]) == value, name
    assert "kTileNodes = kThreads * kNodesThread;" in text
    assert bk._HEAD_TILE_NODES == bk._HEAD_THREADS * bk._HEAD_NODES_THREAD
    # the Python twin's rule is the source's: largest TG with enough blocks
    assert "blocks >= kMinBlocks && fixed + acc <= kSharedBudget" in text
    assert "bst_batch_head" in text and "cudaLaunchKernelEx" in text
    assert "__stcs(reinterpret_cast<int4*>" in text  # the 16-byte streaming stores


# -- numpy model of the kernel's walk (csrc/batch_head.cu head_kernel) --------

LANE_NONE = np.uint64(2**32 - 1)  # the gang table's shift of a lane that asks nothing


def gang_table(req_rows, r, lanes):
    """s_div of one block: (magic, shift) a gang and lane, shift 2^32 - 1
    where the gang asks nothing of the lane (or past r)."""
    tg = req_rows.shape[0]
    m = np.zeros((tg, lanes), np.uint64)
    l = np.full((tg, lanes), LANE_NONE, np.uint64)
    for b in range(tg):
        for x in range(min(r, lanes)):
            q = int(req_rows[b, x])
            if q > 0:
                mm, ll = kernel_magic([min(q, 2**30)])
                m[b, x], l[b, x] = mm[0], ll[0]
    return m, l


def row_stores(js, lane, nb, s):
    """(thread, node, source) of every entry store_row writes in one row
    whose first 16-byte boundary is ``s`` nodes into each quad: ``source``
    0-3 the thread's own nodes, 4-6 the next lane's first three (by
    shuffle); and whether the quad went as one 16-byte store."""
    t = np.arange(js.shape[0])
    parts, vector = [], np.zeros(js.shape[0], bool)
    body = np.ones(js.shape[0], bool)
    if s:
        for i in range(s):  # lane 0: its first s nodes (no lane before it)
            sel = (lane == 0) & (js + i < nb)
            parts.append((t[sel], js[sel] + i, np.full(sel.sum(), i)))
        for k in range(4 - s):  # lane 31: its last 4 - s nodes (no lane after it)
            sel = (lane == 31) & (js + s + k < nb)
            parts.append((t[sel], js[sel] + s + k, np.full(sel.sum(), s + k)))
        body = lane != 31
    j = js + s
    vector = body & (j + 3 < nb)
    for k in range(4):
        sel = body & (j + k < nb)
        parts.append((t[sel], j[sel] + k, np.full(sel.sum(), s + k)))
    th, node, src = (np.concatenate(p) for p in zip(*parts))
    return th, node, src, vector


def row_shift(elem_offset):
    """Nodes before a row's first 16-byte boundary, its start ``elem_offset``
    int32 elements past a 16-byte aligned base."""
    return (4 - elem_offset % 4) % 4


def mask_model(buf, start, js, nv):
    """mask_bits: [threads, 4] allowed bits of the row at byte ``start`` of
    ``buf``, and which threads took the one 32-bit load (aligned, inside
    the row)."""
    j = js[:, None] + np.arange(4)
    word = (js + 3 < nv) & ((start + js) % 4 == 0)
    inside = j < nv
    bits = np.zeros(j.shape, bool)
    bits[inside] = buf[start + j[inside]] != 0
    return bits, word


def head_walk(plan, *, alloc=None, requested=None, req=None, remaining=None, mask=None,
              mask_start=0, mask_stride=0, valid=None, anti=None, node_hash=None, cap_in=None,
              n_lo=0, nv=0, gv=0, gb=0, nb=0, left=False, cap=True, scores=True,
              feasible=True):
    """The kernel's launch, block by block and thread by thread (numpy,
    every thread of a tile at once): the gang tables, the clamped leftover
    loaded once a tile, the divisions, the masks (``mask`` a flat byte
    buffer, row g at ``mask_start + g * mask_stride``), the fold, the int64
    feasibility slots and their warp, block and cluster sums, the stores
    through row_stores with the next lane's capacities by shuffle (a lane
    31 never reads one). Returns the outputs and per-entry write counts."""
    threads, per = plan.threads, plan.nodes_thread
    tile = threads * per
    tid = np.arange(threads)
    lane = tid % 32
    r = alloc.shape[1] if alloc is not None else 1
    h = 0 if node_hash is None else node_hash.shape[1]
    out = {"cap": np.full((gb, nb), -7, np.int64), "scores": np.full((gb, nb), -7, np.int64),
           "cap_count": np.zeros((gb, nb), int), "scores_count": np.zeros((gb, nb), int),
           "feasible": np.full(gv, -1, np.int64), "words": 0, "loads": 0, "vector_stores": 0}
    if left:
        n_total = alloc.shape[0]
        out["left"] = np.full((n_total, r), -7, np.int64)
        out["left_count"] = np.zeros((n_total, r), int)
        rest = np.ones(n_total, bool)
        rest[n_lo:n_lo + nv] = False  # the grid-strided pass over the nodes no tile holds
        out["left"][rest] = alloc[rest].astype(np.int64) - requested[rest]
        out["left_count"][rest] += 1
    lanes = _HEAD_LANES if plan.leftover != "shared" else 32
    for gt in range(plan.gang_tiles):
        g0 = gt * plan.tg
        gangs = np.arange(g0, min(g0 + plan.tg, gb))
        rows = gangs.shape[0]
        if plan.leftover != "none":
            rq = np.zeros((plan.tg, r), np.int64)
            live = gangs[gangs < gv]
            rq[:live.shape[0]] = req[live]
            magic, shift = gang_table(rq, r, lanes)
        partials = []
        for c in range(plan.cluster):
            acc = np.zeros((rows, threads), np.int64)
            for t in range(c, plan.tiles, plan.cluster):
                js = t * tile + per * tid
                j = js[:, None] + np.arange(per)
                inb = j < nv
                if plan.leftover != "none":
                    n = n_lo + np.where(inb, j, 0)
                    raw = alloc[n].astype(np.int64) - requested[n]
                    v = np.where(inb[..., None], np.clip(raw, 0, 2**30), 0)
                    if left and gt == 0:
                        out["left"][n[inb]] = raw[inb]
                        np.add.at(out["left_count"], n[inb], 1)
                    hashes = node_hash[n] if h else None
                    allow = inb.copy()
                    if mask_stride == 0:
                        bits, word = mask_model(mask, mask_start, js, nv)
                        allow &= bits
                        out["words"] += int(word.sum())
                        out["loads"] += threads
                    # the leftover is 0 where allow leaves a node out
                    v = np.where(allow[..., None], v, 0)
                for b in range(rows):
                    g = int(gangs[b])
                    if plan.leftover == "none":
                        capv = np.where(j < nb, cap_in[g][np.minimum(j, nb - 1)], 0)
                    elif g >= gv:
                        capv = np.zeros(j.shape, np.int64)
                    else:
                        capv = np.full(j.shape, 2**30, np.int64)
                        for x in range(min(r, lanes)):
                            if shift[b, x] != LANE_NONE:
                                q = kernel_div(v[..., x], np.full(j.shape, magic[b, x]),
                                               np.full(j.shape, shift[b, x]))
                                capv = np.minimum(capv, q)
                        # the zeros the divisions do not give
                        ok = allow.copy()
                        if mask_stride:
                            bits, word = mask_model(mask, mask_start + g * mask_stride, js, nv)
                            ok &= bits
                            out["words"] += int(word.sum())
                            out["loads"] += threads
                        if h and anti[g] > 0:
                            ok &= ~(hashes == anti[g]).any(axis=-1)
                        if not (rq[b] > 0).any() or mask_stride or (h and anti[g] > 0):
                            capv = np.where(ok, capv, 0)
                    if feasible:
                        rem = int(remaining[g]) if g < gv else 0
                        acc[b] += np.where(inb, np.minimum(capv, rem), 0).sum(axis=1)
                    nxt = np.roll(capv, -1, axis=0)[:, :3]
                    nxt[lane == 31] = -10**12  # a lane 31 reads no next lane
                    vals = np.concatenate([capv, nxt], axis=1)
                    for key, on in (("cap", cap), ("scores", scores)):
                        if not on:
                            continue
                        th, node, src, vec = row_stores(js, lane, nb, row_shift(g * nb))
                        got = vals[th, src]
                        assert (got > -10**12).all(), "a lane 31 stored its next lane's node"
                        if key == "scores":
                            got = np.where(got > 0, 2**30 - got, -(2**30))
                        out[key][g, node] = got
                        np.add.at(out[f"{key}_count"], (np.full(node.shape, g), node), 1)
                        out["vector_stores"] += int(vec.sum())
            # the block's sums: a warp's 32 slots, then the block's warps
            partials.append(acc.reshape(rows, threads // 32, 32).sum(axis=2).sum(axis=1))
        if feasible:
            total = np.sum(partials, axis=0)
            for b in range(rows):
                g = int(gangs[b])
                if g < gv:
                    out["feasible"][g] = int(total[b] >= int(remaining[g]) and valid[g])
    return out


_HEAD_LANES = bk._HEAD_REG_LANES  # the register path's lanes (csrc kRegLanes)


def _walk_inputs(n, g, r, seed, per_group=False, h=0, zero_rows=0.05, big=False):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 3000, size=(n, r)).astype(np.int64)
    left[rng.random(n) < 0.05] = -5
    if big:
        left[:] = 2**30  # capacities 2^30 / small requests: sums past 2^31
    requested = rng.integers(0, 40, size=(n, r)).astype(np.int64)
    alloc = left + requested
    req = rng.integers(0, 40, size=(g, r)).astype(np.int64)
    req[rng.random(g) < zero_rows] = 0
    rem = rng.integers(0, 2000, size=g).astype(np.int64)
    if big:
        rem[:] = 2**31 - 1
    mask = rng.random((g if per_group else 1, n)) < 0.8
    valid = rng.random(g) < 0.9
    fold = None
    if h:
        vocab = np.array([0, 11, 12, 13, 14, 15], np.int64)
        node_hash = vocab[rng.integers(0, len(vocab), size=(n, h))]
        anti = np.where(rng.random(g) < 0.5, vocab[rng.integers(1, len(vocab), size=g)], 0)
        fold = (anti.astype(np.int32), node_hash.astype(np.int32))
    return ((alloc.astype(np.int32), requested.astype(np.int32), req.astype(np.int32),
             rem.astype(np.int32), mask, valid), fold)


def _plain(args, fold):
    cpu = tuple(torch.from_numpy(a) for a in args)
    extra = tuple(torch.from_numpy(a) for a in fold) if fold else (None, None)
    return [t.numpy() for t in bk.batch_head_plain(*cpu, *extra)]


WALK_CASES = {
    # (n, g, r, per_group, h, big): nb % 4 of the whole batch in {0, 1, 2, 3}
    "r1-broadcast": (1000, 37, 1, False, 0, False),
    "r5-per-group-nb1": (1001, 40, 5, True, 0, False),
    "r8-broadcast-nb2": (1002, 70, 8, False, 0, False),
    "r9-shared-nb3": (1003, 45, 9, True, 0, False),
    "r32-shared": (1100, 33, 32, False, 0, False),
    "h8-fold-per-group": (1500, 50, 5, True, 8, False),
    "tiles-past-the-cluster": (9300, 5, 3, False, 0, False),
    "int64-partials": (3000, 6, 2, False, 0, True),
    "repeated-rows": (1200, 600, 5, False, 4, False),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_head_walk_model_matches_plain(case):
    """The numpy model of the kernel's walk equals the plain head on the
    whole batch (every output and every entry written once), whatever the
    row alignment (nb % 4), the leftover path (registers for R <= 6, shared
    memory past), the mask mode and the fold; the int64 partials hold sums
    past 2^31."""
    n, g, r, per_group, h, big = WALK_CASES[case]
    args, fold = _walk_inputs(n, g, r, seed=len(case), per_group=per_group, h=h, big=big)
    alloc, requested, req, rem, mask, valid = args
    if case == "repeated-rows":  # runs of gangs asking the same (the north star's all do)
        req[:] = req[np.arange(g) // 7 * 7]
    want = _plain(args, fold)
    plan = bk.head_kernel_plan(g, n, r, h)
    assert plan.leftover == ("shared" if r > bk._HEAD_REG_LANES else "registers")
    got = head_walk(plan, alloc=alloc, requested=requested, req=req, remaining=rem,
                    mask=mask.reshape(-1).astype(np.uint8), mask_stride=n if per_group else 0,
                    valid=valid, anti=fold[0] if fold else None,
                    node_hash=fold[1] if fold else None, n_lo=0, nv=n, gv=g, gb=g, nb=n,
                    left=True)
    for key in ("cap_count", "scores_count", "left_count"):
        assert (got[key] == 1).all(), key
    np.testing.assert_array_equal(got["left"], want[0])
    np.testing.assert_array_equal(got["cap"], want[1])
    np.testing.assert_array_equal(got["feasible"].astype(bool), want[2])
    np.testing.assert_array_equal(got["scores"], want[3])
    assert got["vector_stores"] > 0
    if big:  # every clipped sum past int32
        sums = np.minimum(want[1].astype(np.int64), rem[:, None].astype(np.int64)).sum(axis=1)
        assert (sums > 2**31).all() and want[2][valid].all()


@pytest.mark.parametrize("ranks", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per-group"])
def test_head_walk_model_mesh_blocks(ranks, per_group):
    """head_block's blocks at N = 5,003 (nb 2,502 or 1,251: rows not
    16-byte aligned, the mask pointer offset by glo * n + nlo, often odd)
    and the finish on the assembled matrix: the model equals the plain
    modes; each entry is written once; the mask's 32-bit loads are aligned
    and inside the block."""
    n, g, r = 5003, 130, 11
    args, _ = _walk_inputs(n, g, r, seed=5, per_group=per_group)
    alloc, requested, req, rem, mask, valid = args
    whole = _plain(args, None)
    gs, ns = ranks
    gb, nb = -(-g // gs), -(-n // ns)
    flat = mask.reshape(-1).astype(np.uint8)
    assembled = np.zeros((g, n), np.int64)
    odd_start = False
    for gi in range(gs):
        for ni in range(ns):
            glo, ghi = min(gi * gb, g), min((gi + 1) * gb, g)
            nlo, nhi = min(ni * nb, n), min((ni + 1) * nb, n)
            start = (glo * n if per_group else 0) + nlo
            odd_start |= start % 4 != 0
            plan = bk.head_kernel_plan(gb, nb, r, feasible=False)
            got = head_walk(plan, alloc=alloc, requested=requested, req=req[glo:ghi],
                            mask=flat, mask_start=start, mask_stride=n if per_group else 0,
                            n_lo=nlo, nv=nhi - nlo, gv=ghi - glo, gb=gb, nb=nb,
                            left=(gi, ni) == (0, 0), scores=False, feasible=False)
            assert (got["cap_count"] == 1).all()
            block = got["cap"]
            assert (block[ghi - glo:] == 0).all() and (block[:, nhi - nlo:] == 0).all()
            np.testing.assert_array_equal(block[:ghi - glo, :nhi - nlo],
                                          whole[1][glo:ghi, nlo:nhi])
            if (gi, ni) == (0, 0):
                assert (got["left_count"] == 1).all()
                np.testing.assert_array_equal(got["left"], whole[0])
            assembled[glo:ghi, nlo:nhi] = block[:ghi - glo, :nhi - nlo]
    assert odd_start == (ns > 1 or per_group)
    plan = bk.head_kernel_plan(g, n, 1, finish=True)
    fin = head_walk(plan, cap_in=assembled, remaining=rem, valid=valid, nv=n, gv=g, gb=g, nb=n,
                    cap=False)
    assert (fin["scores_count"] == 1).all()
    np.testing.assert_array_equal(fin["scores"], whole[3])
    np.testing.assert_array_equal(fin["feasible"].astype(bool), whole[2])


@pytest.mark.parametrize("nlo", [2, 3])
def test_head_walk_mask_words_only_where_aligned(nlo):
    """A per-group mask read through a pointer offset by nlo nodes (row g
    at byte nlo + 1,030 g): a row takes the 32-bit loads where its quads
    are aligned (nlo = 2: the odd rows; nlo = 3: none), the rest byte by
    byte, and the capacity is the same either way."""
    n, g, r = 1030, 20, 4
    args, _ = _walk_inputs(n, g, r, seed=8, per_group=True)
    alloc, requested, req, rem, mask, valid = args
    flat = mask.reshape(-1).astype(np.uint8)
    nv = n - nlo
    plan = bk.head_kernel_plan(g, nv, r, feasible=False)
    got = head_walk(plan, alloc=alloc, requested=requested, req=req, mask=flat,
                    mask_start=nlo, mask_stride=n, n_lo=nlo, nv=nv, gv=g, gb=g, nb=nv,
                    scores=False, feasible=False)
    np.testing.assert_array_equal(got["cap"], _plain(args, None)[1][:, nlo:])
    full_quads = nv // 4  # threads whose 4 bytes lie inside the row
    assert got["loads"] == g * plan.tiles * plan.threads
    assert got["words"] == (full_quads * (g // 2) if nlo == 2 else 0)


@pytest.mark.parametrize("case", ["broadcast", "per-group", "fold"])
def test_head_walk_model_matches_reference(case):
    """The model's whole-batch walk on a padded batch equals the
    reference's schedule_batch head (with the anti-affinity fold for
    "fold")."""
    batch_args, _ = padded_batch(n=700, g=40, r=5, per_group=case == "per-group", seed=31)
    alloc, requested, req, rem, mask, valid = (np.asarray(a) for a in batch_args[:6])
    gb, nb = req.shape[0], alloc.shape[0]
    kw = {}
    fold = None
    if case == "fold":
        cols = policy_cols(np.random.default_rng(31), nb, gb, anti_share=0.7)
        fold = (cols[2], cols[4])
        want = jax_oracle.schedule_batch(*batch_args, policy_cols=cols,
                                         policy_terms=("anti-affinity",), policy_weights=(8,))
        kw = dict(anti=cols[2], node_hash=cols[4])
    else:
        want = jax_oracle.schedule_batch(*batch_args)
    plan = bk.head_kernel_plan(gb, nb, alloc.shape[1], fold[1].shape[1] if fold else 0)
    got = head_walk(plan, alloc=alloc, requested=requested, req=req, remaining=rem,
                    mask=mask.reshape(-1).astype(np.uint8),
                    mask_stride=nb if mask.shape[0] != 1 else 0, valid=valid, n_lo=0, nv=nb,
                    gv=gb, gb=gb, nb=nb, left=True, **kw)
    np.testing.assert_array_equal(got["left"], np.asarray(want["left"]))
    np.testing.assert_array_equal(got["cap"], np.asarray(want["capacity"]))
    np.testing.assert_array_equal(got["feasible"].astype(bool), np.asarray(want["gang_feasible"]))
    np.testing.assert_array_equal(got["scores"], np.asarray(want["scores"]))


def _plan_coverage(plan, gb, nb, nv):
    """Every (gang, node) of a [gb, nb] block written exactly once by the
    plan's launch (gang tiles, the cluster's tiles, the threads' quads and
    store_row's vector body, head and tail for each row alignment), and
    each of the nv nodes' leftover read by exactly one block of a gang
    tile."""
    gangs = np.zeros(gb, int)
    for gt in range(plan.gang_tiles):
        gangs[gt * plan.tg:(gt + 1) * plan.tg] += 1
    assert (gangs == 1).all()
    tiles = np.zeros(plan.tiles, int)
    for c in range(plan.cluster):
        tiles[c::plan.cluster] += 1
    assert (tiles == 1).all()
    tid = np.arange(plan.tiles * plan.threads)
    js = (tid // plan.threads) * plan.threads * plan.nodes_thread + plan.nodes_thread * (
        tid % plan.threads)
    held = np.zeros(max(nv, 1), int)
    j = (js[:, None] + np.arange(plan.nodes_thread)).reshape(-1)
    np.add.at(held, j[j < nv], 1)
    assert (held[:nv] == 1).all()
    shifts = sorted({row_shift(g * nb) for g in range(min(gb, 4))})
    for s in shifts:
        _, node, _, vec = row_stores(js, tid % 32, nb, s)
        count = np.bincount(node, minlength=nb)
        assert count.shape[0] == nb and (count == 1).all(), s
        assert vec.any() or nb < 8
    return shifts


HEAD_PLAN_SHAPES = {
    "north-star": (1024, 8192, 5),
    "xl": (4096, 131072, 6),
    "cli-quarter": (256, 2048, 5),
    "race": (8, 8, 3),
}


@pytest.mark.parametrize("mode", ["whole", "block", "finish"])
@pytest.mark.parametrize("shape", sorted(HEAD_PLAN_SHAPES))
def test_head_plan_covers_every_entry_once(shape, mode):
    """head_kernel_plan at the north star, XL, the CLI's quarter width and
    a race batch: at most 8 blocks a cluster, every (gang, node) written
    once, a TG that gives the card two blocks an SM where the gangs allow,
    the dynamic shared memory within budget."""
    g, n, r = HEAD_PLAN_SHAPES[shape]
    plan = bk.head_kernel_plan(g, n, r, feasible=mode != "block", finish=mode == "finish")
    assert 1 <= plan.cluster <= 8 and plan.blocks == plan.cluster * plan.gang_tiles
    assert plan.shared_bytes <= bk._HEAD_SHARED_BUDGET
    assert plan.blocks >= bk._HEAD_MIN_BLOCKS or plan.tg == bk._HEAD_MIN_TILE
    assert _plan_coverage(plan, g, n, n) == [0]
    assert plan.path == "vector"
    if shape == "north-star":
        assert (plan.tg, plan.cluster, plan.blocks) == (16, 8, 512)
    if shape == "xl":
        assert (plan.tg, plan.tiles, plan.cluster, plan.blocks) == (32, 128, 8, 1024)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("per_group", [False, True], ids=["broadcast", "per-group"])
def test_head_plan_covers_the_sharded_blocks(ranks, per_group):
    """The replicated rung's blocks of the sharded cells' per-group input
    at N = 5,003 (R = 11: the shared leftover) over 2 and 4 ranks
    (1 x S and 2 x S/2 grids): nb 2,502 or 1,251 and their rows out of
    16-byte alignment are each written once."""
    n, g, r = 5003, 1024, 11
    for gs in (1, 2):
        ns = ranks // gs
        gb, nb = -(-g // gs), -(-n // ns)
        for ni in range(ns):
            nv = min((ni + 1) * nb, n) - min(ni * nb, n)
            plan = bk.head_kernel_plan(gb, nb, r, feasible=False)
            assert plan.leftover == "shared" and plan.cluster <= 8
            assert plan.path == ("vector" if nb % 4 == 0 else "edges")
            shifts = _plan_coverage(plan, gb, nb, nv)
            assert (len(shifts) > 1) == (nb % 4 != 0)
    whole = bk.head_kernel_plan(g, n, r, finish=True)
    assert whole.path == "edges" and _plan_coverage(whole, g, n, n) == [0, 1, 2, 3]
    del per_group  # the plan does not depend on the mask mode; the walk's tests do


# -- on the card ---------------------------------------------------------------

def _card_head_cases(rng):
    # (n, g, r, per-group mask, hash lanes of the anti-affinity fold): the
    # race batch, mixed's per-group input at N = 5,003 (G not a multiple of
    # TG, the shared leftover), the north star, the fold, 2^21 nodes, more
    # gangs than nodes, and nb % 4 in {1, 2, 3} with R = 1, 32 and 8 and
    # h = 8 (the mesh blocks below then start at unaligned nodes)
    for n, g, r, per_group, h in ((8, 8, 3, False, 0), (5003, 1000, 11, True, 0),
                                  (8192, 1024, 5, False, 0), (3000, 40, 5, True, 4),
                                  (2**21, 16, 4, False, 0), (1000, 3000, 5, False, 4),
                                  (1001, 300, 1, True, 0), (1002, 77, 32, False, 0),
                                  (1003, 129, 8, True, 8), (4099, 515, 9, False, 8)):
        left = rng.integers(0, 3000, size=(n, r)).astype(np.int32)
        left[rng.random(n) < 0.05] = -5
        requested = rng.integers(0, 40, size=(n, r)).astype(np.int32)
        req = rng.integers(0, 40, size=(g, r)).astype(np.int32)
        req[rng.random(g) < 0.05] = 0
        rem = rng.integers(0, 2000, size=g).astype(np.int32)
        mask = rng.random((g if per_group else 1, n)) < 0.8
        valid = rng.random(g) < 0.9
        extra = None
        if h:
            cols = policy_cols(rng, n, g)
            node_hash = cols[4]
            if h > node_hash.shape[1]:
                node_hash = np.concatenate([node_hash, node_hash[::-1, :h - node_hash.shape[1]]],
                                           axis=1)
            extra = (cols[2], np.ascontiguousarray(node_hash[:, :h]))
        yield (left + requested, requested, req, rem, mask, valid), extra


@pytest.mark.cuda
def test_head_kernel_matches_plain_on_card():
    """Every mode of the head kernel against its plain version on the
    card: the whole batch (both mask modes, 1-32 lanes, the anti-affinity
    fold on 4 and 8 hash lanes, 2^21 nodes, rows out of 16-byte alignment),
    blocks of the replicated rung (at unaligned first nodes where nb % 4 !=
    0), the finish and the leftover alone."""
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
def test_head_plan_matches_the_source_on_card():
    """The source's head_plan (bst_batch_head_plan) is head_kernel_plan at
    the main shapes and at the edges of its rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library builds only there")
    import ctypes

    fn = _build.library("batch_head").bst_batch_head_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None
    modes = {0: "registers", 1: "shared", 2: "none"}
    for g, n, r, h in ((1024, 8192, 5, 0), (4096, 131072, 6, 0), (256, 2048, 5, 0), (8, 8, 3, 0),
                       (1024, 2502, 11, 0), (512, 1251, 11, 0), (1024, 8192, 32, 8),
                       (1024, 8192, 5, 4), (16, 2**21, 4, 0), (3000, 1000, 5, 4), (0, 0, 1, 0)):
        for feasible, finish in ((True, False), (False, False), (True, True)):
            out = (ctypes.c_int * 7)()
            fn(g, n, r, h, int(feasible), int(finish), out)
            plan = bk.head_kernel_plan(g, n, r, h, feasible, finish)
            assert (modes[out[0]], *out[1:]) == (plan.leftover, plan.tg, plan.tiles, plan.cluster,
                                                 plan.gang_tiles, plan.blocks,
                                                 plan.shared_bytes), (g, n, r, h, feasible, finish)


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
