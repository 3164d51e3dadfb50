"""The decomposition the top-K kernel (``csrc/assign_topk.cu``) runs,
modelled in numpy and held against the candidate rank of the JAX reference
(``batch_scheduler_tpu/ops/oracle.py`` ``_coarse_rank``) and of the port
(``ops/oracle.py`` ``_coarse_rank``) on the CPU:

- one exchange a rank: each block of consecutive nodes publishes its
  cumulative count histogram of the key min(cap, 127) and its own first L
  fitting nodes by the composite key * 2^25 + node, sorted; the global cut
  of the summed histograms says how many entries each block gives, and the
  entries merged are exactly the first L (ties in capacity, fewer fitting
  nodes than L, one to sixteen blocks);
- the pooled sum of min(cap, need) from the histogram: a key below 127 is
  the capacity itself, and only nodes of key 127 need their exact sum;
- a replay on carried lists: a gang's live top-kk is the top-kk of its
  list from the wave's exchange (kk + m entries) with the nodes earlier
  gangs took from at their live capacity, and its live pooled sum the
  listed one less what those nodes lost, whenever at most m listed nodes
  have left (or the list held every fitting node); past that the kernel
  ranks afresh.

Every value is an integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from batch_scheduler_tpu.ops import oracle as jax_oracle
except ImportError:  # a machine without JAX compares with the port alone
    jnp = jax_oracle = None
from batch_scheduler_tpu_torch.ops import oracle as port_oracle

BINS = 128
SHIFT = 25  # the kernel's composite: key << 25 | node
BIG = 2**30


def composite(cap, node):
    return (min(int(cap), BINS - 1) << SHIFT) | int(node)


def blocks_of(n, blocks):
    """The kernel's node split: consecutive blocks of ceil(N / C) nodes."""
    size = -(-n // blocks)
    return [(b * size, min((b + 1) * size, n)) for b in range(blocks)]


def publish(cap, lo, hi, length):
    """One block's publish buffer: its cumulative count histogram of the
    fitting nodes' keys (bin 0 empty) and its first ``length`` fitting nodes
    by composite, sorted."""
    keys = np.minimum(cap[lo:hi], BINS - 1)
    counts = np.bincount(keys[keys > 0], minlength=BINS)
    listed = sorted(composite(cap[i], i) for i in range(lo, hi) if cap[i] > 0)[:length]
    return np.cumsum(counts), listed


def exchange(cap, blocks, length):
    """The kernel's rank of one capacity row: every block's publish buffer,
    then the global cut and each block's share (its entries below the cut
    bin, and the cut bin's first ones by index, lower blocks first).
    Returns (the merged list of (node, capacity), complete)."""
    pubs = [publish(cap, lo, hi, length) for lo, hi in blocks_of(len(cap), blocks)]
    g = sum(c for c, _ in pubs)
    total = int(g[-1])
    bs = int((g < length).sum())
    merged, lower = [], 0
    for cum, listed in pubs:
        if bs < BINS:
            below = int(cum[bs - 1])
            at = int(cum[bs]) - below
            take = below + min(max(length - int(g[bs - 1]) - lower, 0), at)
            lower += at
        else:
            take = int(cum[-1])
        assert take <= len(listed)
        merged += listed[:take]
    merged.sort()
    return [(c & ((1 << SHIFT) - 1), int(cap[c & ((1 << SHIFT) - 1)])) for c in merged], \
        total <= length


def reference_ranks(cap, length):
    """The first min(length, fitting) candidates of both packages'
    ``_coarse_rank``: (port nodes, JAX nodes or None)."""
    fitting = int((cap > 0).sum())
    k = min(length, len(cap))
    idx, v = port_oracle._coarse_rank(torch.from_numpy(cap.astype(np.int32)), k, len(cap))
    port = idx[v < port_oracle._BIG][: min(fitting, k)].tolist()
    jax_nodes = None
    if jax_oracle is not None:
        jidx, jv = jax_oracle._coarse_rank(jnp.asarray(cap.astype(np.int32)), k, len(cap))
        jidx, jv = np.asarray(jidx), np.asarray(jv)
        jax_nodes = jidx[jv < jax_oracle._BIG][: min(fitting, k)].tolist()
    return port, jax_nodes


def capacities(rng, n, kind):
    """A capacity row: random, few distinct values (ties), mostly empty
    (fewer fitting nodes than a list holds), or past key 127."""
    if kind == "ties":
        return rng.choice([0, 1, 3, 3, 7], size=n).astype(np.int64)
    if kind == "sparse":
        cap = np.zeros(n, np.int64)
        cap[rng.choice(n, size=min(n, 5), replace=False)] = rng.integers(1, 9, size=min(n, 5))
        return cap
    if kind == "wide":
        return rng.integers(0, 400, size=n).astype(np.int64)
    return rng.integers(0, 40, size=n).astype(np.int64)


@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("length", [2, 5, 16, 64, 160])
@pytest.mark.parametrize("kind", ["random", "ties", "sparse"])
def test_one_exchange_merges_the_global_first_entries(blocks, length, kind):
    rng = np.random.default_rng(blocks * 1000 + length * 7 + len(kind))
    n = int(rng.integers(max(blocks, 2), 700))
    cap = capacities(rng, n, kind)
    merged, complete = exchange(cap, blocks, length)
    port, jax_nodes = reference_ranks(cap, length)
    assert [x for x, _ in merged][: len(port)] == port
    if jax_nodes is not None:
        assert [x for x, _ in merged][: len(jax_nodes)] == jax_nodes
    fitting = int((cap > 0).sum())
    assert len(merged) == min(length, fitting) and complete == (fitting <= length)


def test_one_exchange_merges_the_global_first_entries_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(seed=st.integers(0, 2**31 - 1), blocks=st.integers(1, 16),
           length=st.integers(2, 256), kind=st.sampled_from(["random", "ties", "sparse"]))
    def check(seed, blocks, length, kind):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(blocks, 400))
        cap = capacities(rng, n, kind)
        merged, complete = exchange(cap, blocks, length)
        port, _ = reference_ranks(cap, length)
        assert [x for x, _ in merged][: len(port)] == port
        assert complete == (int((cap > 0).sum()) <= length)

    assert hypothesis is not None
    check()


@pytest.mark.parametrize("kind", ["random", "ties", "wide"])
def test_pooled_sums_from_the_histogram(kind):
    rng = np.random.default_rng(len(kind))
    cap = capacities(rng, 900, kind)
    keys = np.minimum(cap, BINS - 1)
    counts = np.bincount(keys, minlength=BINS)
    for need in (0, 1, 5, 126, 127, 300, 1000):
        hist_part = sum(int(counts[k]) * min(k, need) for k in range(1, BINS - 1))
        exact_top = int(np.minimum(cap[keys == BINS - 1], need).sum())
        assert hist_part + exact_top == int(np.minimum(cap, need).sum())


# -- a replay on carried lists -------------------------------------------------

def member_cap(left, req):
    """Members of a request row fitting each leftover row (the kernel's
    member_cap: lanes clamped to [0, 2^30], a lane with no request free)."""
    lpos = np.clip(left, 0, BIG)
    per_lane = np.where(req[None, :] > 0, lpos // np.maximum(req, 1)[None, :], BIG)
    return per_lane.min(axis=1)


def replay_case(rng, n, g, r, kind):
    left = rng.integers(0, 60, size=(n, r)).astype(np.int64)
    if kind == "uniform":
        reqs = np.tile(rng.integers(1, 6, size=(1, r)), (g, 1))
    elif kind == "tight":
        left[:] = 8
        reqs = np.full((g, r), 4)
    else:
        reqs = rng.integers(0, 6, size=(g, r))
    needs = rng.integers(1, 25, size=g)
    mask = rng.random((g, n)) < 0.85
    return left, reqs.astype(np.int64), needs, mask


def carried_replay(left_seed, reqs, needs, mask, kk, margin, blocks):
    """Gangs in order against a leftover that their takes lower, each
    ranked on its list from the wave-entry exchange (kk + margin entries)
    plus the touched nodes at their live capacity, held to a fresh rank of
    the live leftover (both packages' _coarse_rank, and the pooled sum)
    whenever at most `margin` listed nodes have left or the list held every
    fitting node. Each gang takes on its true candidates (the port's
    _select_best_fit). Returns (gangs served by the lists, gangs past the
    margin)."""
    n = left_seed.shape[0]
    length = kk + margin
    seed_caps = [member_cap(left_seed, reqs[j]) * mask[j] for j in range(len(needs))]
    lists = [exchange(c, blocks, length) for c in seed_caps]
    live = left_seed.copy()
    touched = set()
    served = past = 0
    for j, need in enumerate(needs):
        cap_live = member_cap(live, reqs[j]) * mask[j]
        listed, complete = lists[j]
        listed_nodes = {x for x, _ in listed}
        left_count, corr, pool = 0, 0, []
        for x in touched:
            c0, c1 = int(seed_caps[j][x]), int(cap_live[x])
            corr += min(c0, need) - min(c1, need)
            if x in listed_nodes and c1 == 0:
                left_count += 1
            if c1 > 0:
                pool.append((composite(c1, x), x, c1))
        pool += [(composite(c, x), x, c) for x, c in listed if x not in touched]
        pool.sort()
        if complete or left_count <= margin:
            served += 1
            port, jax_nodes = reference_ranks(cap_live, kk)
            assert [x for _, x, _ in pool[:kk]][: len(port)] == port
            if jax_nodes is not None:
                assert [x for _, x, _ in pool[:kk]][: len(jax_nodes)] == jax_nodes
            assert [c for _, _, c in pool[: len(port)]] == [int(cap_live[x]) for x in port]
            pooled_seed = int(np.minimum(seed_caps[j], need).sum())
            assert pooled_seed - corr == int(np.minimum(cap_live, need).sum())
        else:
            past += 1
        # the gang's take on its live candidates
        k = min(kk, n)
        idx, v = port_oracle._coarse_rank(torch.from_numpy(cap_live.astype(np.int32)), k, n)
        live_mask = (v < port_oracle._BIG).to(torch.int32)
        cap_k = torch.from_numpy(cap_live.astype(np.int32))[idx] * live_mask
        take, feasible = port_oracle._select_best_fit(cap_k, cap_k.clamp(max=int(need)), int(need))
        for x, t in zip(idx.tolist(), take.tolist()):
            if t > 0:
                live[x] -= t * reqs[j]
                touched.add(x)
    return served, past


@pytest.mark.parametrize("kind", ["random", "uniform"])
@pytest.mark.parametrize("kk,margin", [(2, 2), (4, 4), (16, 16), (16, 0), (64, 32)])
@pytest.mark.parametrize("blocks", [1, 4, 16])
def test_carried_lists_equal_a_fresh_rank(kind, kk, margin, blocks):
    rng = np.random.default_rng(kk * 31 + margin + blocks)
    left, reqs, needs, mask = replay_case(rng, 300, 8, 3, kind)
    served, past = carried_replay(left, reqs, needs, mask, kk, margin, blocks)
    assert served + past == len(needs) and served >= 1


def test_carried_lists_equal_a_fresh_rank_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=25, deadline=None, derandomize=True)
    @given(seed=st.integers(0, 2**31 - 1), kk=st.integers(2, 40), margin=st.integers(0, 32),
           blocks=st.integers(1, 16), kind=st.sampled_from(["random", "uniform", "tight"]))
    def check(seed, kk, margin, blocks, kind):
        rng = np.random.default_rng(seed)
        left, reqs, needs, mask = replay_case(rng, int(rng.integers(40, 200)), 8, 2, kind)
        served, past = carried_replay(left, reqs, needs, mask, kk, margin, blocks)
        assert served + past == len(needs)

    check()


def test_more_listed_nodes_leaving_than_the_margin_ranks_afresh():
    """One member a node, every gang the same row: each gang empties the
    tightest listed nodes, so after a few gangs more than m listed nodes
    have left and the model (as the kernel) ranks afresh."""
    n, g = 200, 8
    left = np.full((n, 2), 4, np.int64)
    reqs = np.full((g, 2), 4, np.int64)
    needs = np.full(g, 6)
    mask = np.ones((g, n), bool)
    served, past = carried_replay(left, reqs, needs, mask, kk=8, margin=8, blocks=4)
    assert past >= 1 and served >= 2
