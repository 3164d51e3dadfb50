"""The decomposition the two node-sharded wave kernels (``csrc/shard_wave.cu``,
``csrc/shard_topk.cu``) run, modelled in numpy and held against the plain
steps of the port (``ops/oracle.py`` ``shard_wave_summary`` /
``shard_wave_apply`` / ``shard_topk_summary`` / ``shard_topk_apply``) and the
JAX reference's selections (``batch_scheduler_tpu/ops/oracle.py``
``_hist_select``, ``_select_best_fit``, ``_coarse_rank`` and ``lax.top_k``)
on the CPU:

- a rank's nodes split over a cluster of blocks (consecutive chunks of at
  least 256 nodes, at most 16 blocks) and each block's over its warps
  (consecutive segments of whole 32-node steps), so nl need not be a
  multiple of the block count;
- the histograms a block at a time, summed by the leader;
- the threshold bucket's prefix in node order: each block's partial,
  pushed to the later blocks, plus the earlier warps' partials, plus an
  exclusive scan a 32-node step; a uniform wave's boundaries scan once for
  a run of equal thresholds;
- a speculative wave's conflict check only at nodes an earlier gang takes
  from;
- the top-K summary's candidates from per-block counts and ballot ranks in
  node order, sorted by composite;
- the top-K apply's S-way merge: a composite's merged rank is its index in
  its own sorted list plus a binary-search count in each other list (the
  lower rank first on equal values: only the sentinels tie), and the
  selection on the merged (key-ordered) candidates from each one's prefix.

Every value is an integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from batch_scheduler_tpu.ops import oracle as jax_oracle
except ImportError:  # a machine without JAX compares with the port alone
    jax = jnp = jax_oracle = None
from batch_scheduler_tpu_torch.ops import oracle as port

BINS = 128
BIG = 2**30
MIN_CHUNK, MAX_BLOCKS = 256, 16  # shard_common.cuh kMinChunk, kMaxBlocks


def split_nodes(nl, max_blocks=MAX_BLOCKS):
    """shard_common.cuh ``split_nodes``: (blocks, chunk, threads)."""
    blocks = max(1, min(max_blocks, -(-nl // MIN_CHUNK)))
    chunk = -(-nl // blocks)
    return blocks, chunk, 512 if chunk >= 4096 else 256


def segments(index, chunk, nl, threads):
    """``segment_of`` for every warp of block ``index`` (< 0: no nodes)."""
    c0 = nl if index < 0 else min(index * chunk, nl)
    c1 = nl if index < 0 else min(c0 + chunk, nl)
    nw = threads // 32
    seg = ((c1 - c0 + nw - 1) // nw + 31) & ~31
    out = []
    for w in range(nw):
        s0 = min(c0 + w * seg, c1)
        out.append((s0, min(s0 + seg, c1)))
    return out


def cluster_segments(nl, leader_walks=True):
    """Every (block, warp) segment of the rank's nodes in node order: the
    apply of shard_topk gives its leader no nodes."""
    if leader_walks:
        blocks, chunk, threads = split_nodes(nl)
        return [segments(b, chunk, nl, threads) for b in range(blocks)]
    blocks, chunk, threads = split_nodes(nl, MAX_BLOCKS - 1)
    threads = max(threads, 256)
    return [segments(b - 1, chunk, nl, threads) for b in range(blocks + 1)]


def member_cap(left, req):
    """[k, nl] members of each request row on each leftover row."""
    left = np.clip(left.astype(np.int64), 0, BIG)[None, :, :]
    req = req.astype(np.int64)[:, None, :]
    per = np.where(req > 0, left // np.clip(req, 1, BIG), BIG)
    return per.min(axis=2)


def plans(mode, merged, rank, needs):
    """Each row's (thresh, rem, clip, ok) as ``warp_plan`` derives them."""
    tot = merged.astype(np.int64).sum(0)
    off = merged[:rank].astype(np.int64).sum(0)
    needs = needs.astype(np.int64)
    out = []
    if mode == port.SHARD_MEGA:
        cum = tot[0].cumsum()
        total = int(needs.sum())
        for bound in np.concatenate([[0], needs.cumsum()]):
            th = int((cum <= bound).sum())
            tc = min(th, BINS - 1)
            out.append((th, int(bound - tot[0][:tc].sum() - off[0][tc]), total, True))
        return out
    for j, need in enumerate(needs):
        cum = tot[j].cumsum()
        th = min(int((cum < need).sum()), BINS - 1)
        out.append((th, int(need - tot[j][:th].sum() - off[j][th]), int(need),
                    bool(cum[-1] >= need)))
    return out


def model_takes(cap_rows, row_plans, segs, shared=False):
    """Each row's take vector in the kernel's decomposition: the segments'
    partials of the threshold bucket, each block's total pushed to the later
    blocks, the warps' carries, then a 32-node step's exclusive scan. Rows
    of one ``shared`` capacity row (a uniform wave's boundaries) scan once
    for a run of equal thresholds."""
    rows = len(row_plans)
    nl = cap_rows[0].shape[0]
    takes = np.zeros((rows, nl), np.int64)
    key = [np.minimum(c, BINS - 1) for c in cap_rows]
    capc = [np.minimum(c, p[2]) for c, p in zip(cap_rows, row_plans)]
    part = [[[int(np.where(key[j][a:b] == row_plans[j][0], capc[j][a:b], 0).sum())
              for j in range(rows)] for a, b in block] for block in segs]
    block_tot = [[sum(w[j] for w in block) for j in range(rows)] for block in part]
    for bi, block in enumerate(segs):
        slots = [sum(block_tot[c][j] for c in range(bi)) for j in range(rows)]
        for wi, (a, b) in enumerate(block):
            carry = [slots[j] + sum(part[bi][x][j] for x in range(wi)) for j in range(rows)]
            for base in range(a, b, 32):
                hi = min(base + 32, b)
                pre = None
                for j, (th, rem, _, ok) in enumerate(row_plans):
                    k, c = key[j][base:hi], capc[j][base:hi]
                    if pre is None or not shared or th != row_plans[j - 1][0]:
                        x = np.where(k == th, c, 0)
                        pre = carry[j] + np.cumsum(x) - x
                        carry[j] += int(x.sum())
                    t = np.where(k < th, c, np.where(k == th, np.clip(rem - pre, 0, c), 0))
                    takes[j, base:hi] = t if ok else 0
    return takes


def model_wave_apply(mode, merged, rank, cap, needs, left, req, mask):
    """``csrc/shard_wave.cu``'s apply in numpy: (takes, feas, left_out, verify)."""
    w = needs.shape[0]
    nl = left.shape[0]
    segs = cluster_segments(nl)
    row_plans = plans(mode, merged, rank, needs)
    cap = cap.astype(np.int64)
    left = left.astype(np.int64)
    if mode == port.SHARD_MEGA:
        taken = model_takes([cap[0]] * (w + 1), row_plans, segs, shared=True)
        verify = np.minimum(cap[0][None, :] - taken[:-1], needs[:, None].astype(np.int64)).sum(1)
        return (taken[1:] - taken[:-1], np.ones(w, bool), left - taken[-1][:, None] * req[0],
                verify)
    takes = model_takes(list(cap), row_plans, segs)
    feas = np.array([p[3] for p in row_plans])
    if mode == port.SHARD_REPLAY:
        return takes, feas, left - takes[0][:, None] * req[0], None
    out = np.maximum(left, -BIG)
    conflict = False
    for n in np.flatnonzero((takes != 0).any(0)):
        first = int(np.flatnonzero(takes[:, n])[0])
        acc = np.maximum(left[n], -BIG)
        for j in range(first, w):
            if j > first:
                m = mask[j if mask.shape[0] != 1 else 0, n]
                v = member_cap(acc[None, :], req[j][None, :])[0, 0] if m else 0
                conflict |= v != cap[j, n]
            acc = np.maximum(acc - takes[j, n] * req[j], -BIG)
        out[n] = acc
    return takes, feas, out, np.array([int(conflict)])


def wave_inputs(seed, s, nl, w, r=3, per_group=False, ties=False, uniform=False):
    """One wave's blocks of S ranks (nl nodes each, the last padded with zero
    rows) and its requests and needs."""
    rng = np.random.default_rng(seed)
    n = s * nl - int(rng.integers(0, nl // 3 + 1))
    hi = 6 if ties else 120
    left = rng.integers(0, hi, size=(n, r)).astype(np.int32)
    req = rng.integers(1, 4, size=(w, r)).astype(np.int32)
    if uniform:
        req[:] = req[0]
    needs = rng.integers(0, 3 * nl if ties else 40, size=w).astype(np.int32)
    mask = rng.random((w if per_group else 1, n)) < 0.8
    blocks = []
    for rank in range(s):
        lo, up = min(rank * nl, n), min(rank * nl + nl, n)
        bl = np.zeros((nl, r), np.int32)
        bl[:up - lo] = left[lo:up]
        ml = np.zeros((mask.shape[0], nl), bool)
        ml[:, :up - lo] = mask[:, lo:up]
        blocks.append((bl, ml))
    return blocks, req, needs


WAVE_CASES = [(seed, s, nl, w, kw) for seed, (s, nl, w, kw) in enumerate([
    (1, 700, 8, {}), (2, 600, 8, {"ties": True}), (2, 4096, 8, {"per_group": True}),
    (4, 300, 4, {"ties": True, "per_group": True}), (4, 1000, 1, {}), (2, 5003, 8, {"ties": True}),
    (1, 129, 2, {"uniform": True}), (2, 2600, 8, {"uniform": True, "ties": True}),
])]


@pytest.mark.parametrize("mode", [port.SHARD_SPECULATIVE, port.SHARD_MEGA, port.SHARD_REPLAY])
@pytest.mark.parametrize("seed,s,nl,w,kw", WAVE_CASES)
def test_shard_wave_decomposition_matches_the_plain_steps(mode, seed, s, nl, w, kw):
    if mode == port.SHARD_REPLAY:
        w = 1
    blocks, req, needs = wave_inputs(seed, s, nl, w, **kw)
    k = w if mode == port.SHARD_SPECULATIVE else 1
    clip = needs if k == w else np.array([needs.sum()], np.int32)
    hists, caps = [], []
    for rank, (bl, ml) in enumerate(blocks):
        cap = member_cap(bl, req[:k]) * ml[:k]
        # the summary: each block's histogram of its chunk, summed
        blocks_n, chunk, _ = split_nodes(nl)
        h = np.zeros((k, BINS), np.int64)
        for b in range(blocks_n):
            c = cap[:, b * chunk:(b + 1) * chunk]
            for j in range(k):
                capc = np.minimum(c[j], clip[j])
                np.add.at(h[j], np.minimum(c[j], BINS - 1), np.where(capc > 0, capc, 0))
        hist = torch.empty((s, k, BINS), dtype=torch.int32)
        want_cap = port.shard_wave_summary(torch.from_numpy(bl), torch.from_numpy(req[:k]),
                                           torch.from_numpy(clip), torch.from_numpy(ml[:k]),
                                           hist, rank)
        np.testing.assert_array_equal(want_cap.numpy(), cap)
        np.testing.assert_array_equal(hist[rank].numpy(), h)
        hists.append(hist)
        caps.append(cap)
    merged = torch.stack(hists).sum(0, dtype=torch.int32)
    for rank, (bl, ml) in enumerate(blocks):
        takes = torch.full((w, nl), -7, dtype=torch.int32)
        feas = torch.zeros(w, dtype=torch.bool)
        left_out = torch.full_like(torch.from_numpy(bl), -7)
        verify = None if mode == port.SHARD_REPLAY else torch.zeros(w if k == 1 else 1,
                                                                    dtype=torch.int32)
        port.shard_wave_apply(mode, merged, rank, torch.from_numpy(caps[rank].astype(np.int32)),
                              torch.from_numpy(needs), torch.from_numpy(bl), torch.from_numpy(req),
                              torch.from_numpy(ml), takes, feas, left_out, verify)
        got = model_wave_apply(mode, merged.numpy(), rank, caps[rank], needs, bl, req, ml)
        np.testing.assert_array_equal(got[0], takes.numpy())
        np.testing.assert_array_equal(got[1], feas.numpy())
        np.testing.assert_array_equal(got[2], left_out.numpy())
        if verify is not None:
            np.testing.assert_array_equal(got[3], verify.numpy())
        if jax_oracle is not None and mode != port.SHARD_MEGA:
            # the reference's selection from the same merged histograms
            m = merged.numpy()
            key = np.minimum(caps[rank], BINS - 1)
            capc = np.minimum(caps[rank], needs[:k, None])
            jt, jf = jax_oracle._hist_select(jnp.asarray(m.sum(0)), jnp.asarray(m[:rank].sum(0)),
                                             jnp.asarray(key.astype(np.int32)),
                                             jnp.asarray(capc.astype(np.int32)),
                                             jnp.asarray(needs[:k]))
            np.testing.assert_array_equal(np.asarray(jt), got[0])
            np.testing.assert_array_equal(np.asarray(jf), got[1])


# -- the top-K wave --------------------------------------------------------


def model_topk_row(cap_row, s, rank, kk_l):
    """The summary's candidates of one capacity row: each block's counts of
    the keys, the global cut bin, each block's nodes below it and its first
    ones in it (earlier blocks' counts plus ranks in node order), sorted by
    the composite key * (S nl + 1) + global index. Returns (composites,
    capacities) of at most kk_l candidates."""
    nl = cap_row.shape[0]
    segs = cluster_segments(nl)
    key = np.minimum(cap_row, BINS - 1)
    fit = cap_row > 0
    counts = []
    for block in segs:
        a, b = block[0][0], block[-1][1]
        counts.append(np.bincount(key[a:b][fit[a:b]], minlength=BINS))
    g = np.sum(counts, 0)
    cum = g.cumsum()
    hit = np.flatnonzero(cum >= kk_l)
    tb = int(hit[0]) if len(hit) else BINS
    lt = int(g[:tb].sum())
    want = kk_l - lt if tb < BINS else 0
    ncand = kk_l if tb < BINS else lt
    slots = [None] * ncand
    span, off = s * nl + 1, rank * nl
    for bi, block in enumerate(segs):
        rlt = int(sum(c[:tb].sum() for c in counts[:bi]))
        rtb = int(sum(c[tb] for c in counts[:bi])) if tb < BINS else 0
        for a, b in block:
            for base in range(a, b, 32):
                for n in range(base, min(base + 32, b)):  # a ballot's ranks
                    if not fit[n]:
                        continue
                    if key[n] < tb:
                        slots[rlt] = (int(key[n]) * span + off + n, int(cap_row[n]))
                        rlt += 1
                    elif key[n] == tb:
                        if rtb < want:
                            slots[lt + rtb] = (int(key[n]) * span + off + n, int(cap_row[n]))
                        rtb += 1
    assert all(x is not None for x in slots)
    slots.sort()
    return [c for c, _ in slots], [v for _, v in slots]


def topk_inputs(seed, s, nl, w, kind):
    rng = np.random.default_rng(seed)
    blocks, req, needs = wave_inputs(seed, s, nl, w, ties=kind == "ties",
                                     per_group=kind == "per_group", uniform=kind == "uniform")
    if kind == "sparse":  # fewer fitting nodes than a list holds: sentinels
        for bl, ml in blocks:
            ml[:] = False
            ml[:, rng.choice(nl, size=3, replace=False)] = True
    return blocks, req, needs


def merged_candidates(merged, row, s, nl, rank, kk_l, kk, col):
    """A row's kk smallest merged composites by the binary-search merge
    rank, decoded: (key, column ``col`` of the payload, local node or -1)."""
    lists = [merged[x, row, :kk_l] for x in range(s)]
    key = np.full(kk, BINS - 1, np.int64)
    val = np.zeros(kk, np.int64)
    lidx = np.full(kk, -1, np.int64)
    span, off = s * nl + 1, rank * nl
    for x in range(s):
        for i, v in enumerate(lists[x]):
            at = i + sum(np.searchsorted(lists[y], v, side="right" if y < x else "left")
                         for y in range(s) if y != x)
            if at < kk:
                key[at] = min(int(v) // span, BINS - 1)
                val[at] = merged[x, row, col * kk_l + i]
                g = int(v) - (int(v) // span) * span
                lidx[at] = g - off if v < BIG and off <= g < off + nl else -1
    return key, val, lidx


def select_merged(key, capc, need):
    """The selection on key-ordered candidates: (take, ok)."""
    incl = np.cumsum(capc)
    ok = bool(incl[-1] >= need)
    reach = np.flatnonzero(incl >= need)
    thresh = 0 if need <= 0 else (int(key[reach[0]]) if ok else BINS - 1)
    pre = incl - capc
    take = np.where(key < thresh, capc, np.where(key == thresh, np.clip(need - pre, 0, capc), 0))
    return take * ok, ok


def model_topk_apply(mode, merged, rank, cap, needs, left, req, mask, k):
    """``csrc/shard_topk.cu``'s apply in numpy: (takes, feas, left_out,
    verify, dense): the leader's merge and selection, the candidates'
    commit, or a replayed gang's dense-column selection over the chunk
    blocks (the leader walks no nodes)."""
    s, rows = merged.shape[:2]
    nl, w = left.shape[0], needs.shape[0]
    kk_l, kk = port.shard_topk_widths(k, nl, s)
    left = left.astype(np.int64)
    cap = cap.astype(np.int64)
    needs = needs.astype(np.int64)
    takes = np.zeros((w, nl), np.int64)
    if mode == port.TOPK_MEGA:
        key, c, lidx = merged_candidates(merged, 0, s, nl, rank, kk_l, kk, 1)
        _, cx, _ = merged_candidates(merged, 0, s, nl, rank, kk_l, kk, 2)
        pre = np.cumsum(c) - c
        bounds = np.concatenate([[0], needs.cumsum()])
        taken = np.clip(bounds[:, None] - pre[None, :], 0, None)
        taken = np.minimum(taken, c[None, :])
        d = (np.minimum(cx[None, :], needs[:, None])
             - np.minimum(cx[None, :] - taken[:-1], needs[:, None])).sum(1)
        pooled = merged[:, 0, 3 * kk_l:3 * kk_l + w].astype(np.int64).sum(0)
        ok = c.sum() >= needs.sum() and bool((pooled - d >= needs).all())
        out = left.copy()
        for ci in np.flatnonzero(lidx >= 0):
            takes[:, lidx[ci]] = taken[1:, ci] - taken[:-1, ci]
            out[lidx[ci]] = left[lidx[ci]] - taken[-1, ci] * req[0]
        return takes, np.ones(w, bool), out, np.array([int(ok)]), 0
    sel = []
    for j in range(rows):
        key, c, lidx = merged_candidates(merged, j, s, nl, rank, kk_l, kk, 1)
        need = int(needs[j if mode == port.TOPK_SPECULATIVE else 0])
        take, ok = select_merged(key, c, need)
        pooled = int(merged[:, j, 2 * kk_l].astype(np.int64).sum())
        sel.append((take, ok, ok or pooled < need, lidx))
    if mode == port.TOPK_REPLAY:
        take, ok, flag, lidx = sel[0]
        if flag:
            takes[0, lidx[lidx >= 0]] = take[lidx >= 0]
            return takes, np.array([ok]), left - takes[0][:, None] * req[0], None, 0
        hist = merged[:, 0, 2 * kk_l + 1:][:, None, :]
        row_plans = plans(port.SHARD_REPLAY, hist, rank, needs)
        takes = model_takes([cap[0]], row_plans, cluster_segments(nl, leader_walks=False))
        return (takes, np.array([row_plans[0][3]]), left - takes[0][:, None] * req[0], None, 1)
    for j, (take, _, _, lidx) in enumerate(sel):
        takes[j, lidx[lidx >= 0]] = take[lidx >= 0]
    out = np.maximum(left, -BIG)
    conflict = False
    for n in np.flatnonzero((takes != 0).any(0)):
        first = int(np.flatnonzero(takes[:, n])[0])
        acc = np.maximum(left[n], -BIG)
        for j in range(first, w):
            if j > first:
                m = mask[j if mask.shape[0] != 1 else 0, n]
                v = member_cap(acc[None, :], req[j][None, :])[0, 0] if m else 0
                conflict |= v != cap[j, n]
            acc = np.maximum(acc - takes[j, n] * req[j], -BIG)
        out[n] = acc
    bad = conflict or not all(flag for _, _, flag, _ in sel)
    return takes, np.array([ok for _, ok, _, _ in sel]), out, np.array([int(bad)]), 0


TOPK_CASES = [(seed, s, nl, w, kind, k) for seed, (s, nl, w, kind, k) in enumerate([
    (1, 700, 8, "random", 16), (2, 600, 8, "ties", 16), (2, 4096, 8, "per_group", 16),
    (4, 300, 4, "ties", 4), (2, 1000, 8, "sparse", 16), (4, 257, 2, "uniform", 128),
    (2, 2600, 8, "uniform", 16), (1, 5003, 8, "ties", 128),
])]


@pytest.mark.parametrize("mode", [port.TOPK_SPECULATIVE, port.TOPK_MEGA, port.TOPK_REPLAY])
@pytest.mark.parametrize("seed,s,nl,w,kind,k", TOPK_CASES)
def test_shard_topk_decomposition_matches_the_plain_steps(mode, seed, s, nl, w, kind, k):
    blocks, req, needs = topk_inputs(seed, s, nl, w, kind)
    rows = w if mode == port.TOPK_SPECULATIVE else 1
    if mode == port.TOPK_REPLAY:
        needs = needs[:1]
    kk_l, kk = port.shard_topk_widths(k, nl, s)
    p = port.shard_topk_payload(mode, kk_l, needs.shape[0])
    bufs, caps = [], []
    for rank, (bl, ml) in enumerate(blocks):
        buf = torch.empty((s, rows, p), dtype=torch.int32)
        cap = port.shard_topk_summary(mode, torch.from_numpy(bl), torch.from_numpy(req[:rows]),
                                      torch.from_numpy(needs), torch.from_numpy(ml[:rows]), buf,
                                      rank, k).numpy()
        for j in range(rows):
            comp, vals = model_topk_row(cap[j], s, rank, kk_l)
            got = buf[rank, j, :kk_l].numpy()
            np.testing.assert_array_equal(got[:len(comp)], comp)
            assert (got[len(comp):] == BIG).all()
            clip = needs.sum() if mode == port.TOPK_MEGA else needs[j if rows > 1 else 0]
            np.testing.assert_array_equal(buf[rank, j, kk_l:kk_l + len(vals)].numpy(),
                                          np.minimum(vals, clip))
            if jax_oracle is not None:
                # the reference's coarse rank of the same row, global positions
                pos = jnp.asarray((rank * nl + np.arange(nl)).astype(np.int32))
                _, jv = jax_oracle._coarse_rank(jnp.asarray(cap[j].astype(np.int32)), kk_l,
                                                s * nl, pos=pos)
                np.testing.assert_array_equal(np.asarray(jv), got)
        bufs.append(buf)
        caps.append(cap)
    merged_t = torch.stack(bufs).sum(0, dtype=torch.int32)
    merged = merged_t.numpy()
    for rank, (bl, ml) in enumerate(blocks):
        w = needs.shape[0]
        takes = torch.full((w, nl), -7, dtype=torch.int32)
        feas = torch.zeros(w, dtype=torch.bool)
        left_out = torch.full_like(torch.from_numpy(bl), -7)
        verify = None if mode == port.TOPK_REPLAY else torch.full((1,), -7, dtype=torch.int32)
        dense = torch.zeros(1, dtype=torch.int32)
        port.shard_topk_apply(mode, merged_t, rank, torch.from_numpy(caps[rank].astype(np.int32)),
                              torch.from_numpy(needs), torch.from_numpy(bl),
                              torch.from_numpy(req[:rows]), torch.from_numpy(ml[:rows]), takes,
                              feas, left_out, verify, dense, k)
        got = model_topk_apply(mode, merged, rank, caps[rank], needs, bl, req[:rows], ml[:rows], k)
        np.testing.assert_array_equal(got[0], takes.numpy())
        np.testing.assert_array_equal(got[1], feas.numpy())
        np.testing.assert_array_equal(got[2], left_out.numpy())
        if verify is not None:
            np.testing.assert_array_equal(got[3], verify.numpy())
        assert got[4] == int(dense[0])
    # the apply's S-way merge of each row's sorted lists
    for j in range(rows):
        lists = [merged[x, j, :kk_l] for x in range(s)]
        flat = np.concatenate(lists)
        ranks = np.array([i + sum(np.searchsorted(lists[y], v, side="right" if y < x else "left")
                                  for y in range(s) if y != x)
                          for x in range(s) for i, v in enumerate(lists[x])])
        assert sorted(ranks.tolist()) == list(range(s * kk_l))
        want = np.argsort(flat, kind="stable")[:kk]
        np.testing.assert_array_equal(np.argsort(ranks)[:kk], want)
        if jax is not None:
            _, jidx = jax.lax.top_k(-jnp.asarray(flat), min(kk, flat.size))
            np.testing.assert_array_equal(np.asarray(jidx), want)
    if mode == port.TOPK_MEGA:
        return
    # the selection on the merged candidates: the threshold is the key of
    # the first candidate whose prefix reaches the need, a take its need
    # less the prefix before it (clipped), as _select_best_fit's
    span = s * nl + 1
    for j in range(rows):
        vals = np.concatenate([merged[x, j, :kk_l] for x in range(s)])
        capc = np.concatenate([merged[x, j, kk_l:2 * kk_l] for x in range(s)])
        pick = np.argsort(vals, kind="stable")[:kk]
        v = np.concatenate([vals[pick], np.full(kk - len(pick), BIG)])
        c = np.concatenate([capc[pick], np.zeros(kk - len(pick), np.int64)]).astype(np.int64)
        key = np.minimum(v // span, BINS - 1)
        need = int(needs[j if rows > 1 else 0])
        take, ok = select_merged(key, c, need)
        pt, pf = port._select_best_fit(torch.from_numpy(key), torch.from_numpy(c), need)
        np.testing.assert_array_equal(take, pt.numpy())
        assert bool(pf) == ok
        if jax_oracle is not None:
            jt, jf = jax_oracle._select_best_fit(jnp.asarray(key[None, :].astype(np.int32)),
                                                 jnp.asarray(c[None, :].astype(np.int32)), need)
            np.testing.assert_array_equal(np.asarray(jt)[0], take)
            assert bool(jf) == ok
