"""The batch tail (``ops.batch_kernels.batch_tail_cuda``: the compact
top-K of the assignment in ``lax.top_k``'s order, the packed form,
findMaxPG and the host blob) against the JAX package on the CPU: the
port's ``_batch_blob`` and ``schedule_batch`` against the reference's on
padded batches on the serial, wave and top-K rungs, with invalid groups,
rows holding more nonzero takes than k (with ties), k = N, counts above
65,535 and the ``pack`` gate's boundaries; numpy models of the kernel's
row walk (threshold 0, radix select, ordered fill, rank sort) against
``lax.top_k`` and of its first-occurrence argmax against
``find_max_group``; the bound's count; and, on a card, the CUDA kernel
against the plain version. Every output is an integer: every comparison is
exact (tolerance zero)."""

import re

import numpy as np
import pytest
import torch

try:
    import jax

    from batch_scheduler_tpu.ops import oracle as jax_oracle
except ImportError:  # a GPU machine without JAX runs only the `cuda` tests here
    jax = jax_oracle = None
from batch_scheduler_tpu_torch.ops import _build, batch_kernels as bk, bounds
from batch_scheduler_tpu_torch.ops import oracle as port_oracle
from batch_scheduler_tpu_torch.ops.convert import batch_from_numpy
from test_torch_batch_head import padded_batch

BLOB_KEYS = ("assignment_nodes", "assignment_counts", "placed", "gang_feasible")


def _wide(seed=0, n=400, g=6, members=300):
    """Gangs of ``members`` on nodes that each fit one or two members: each
    placed row has more nonzero takes than k = 128, with ties at 1 and 2."""
    rng = np.random.default_rng(seed)
    left = rng.integers(10, 25, size=(n, 2)).astype(np.int64)
    req = np.full((g, 2), 10)
    rem = np.full(g, members)
    rem[1] = 0
    return dict(left=left, group_req=req, remaining=rem, g=g, n=n, seed=seed)


def _huge_counts():
    """One node takes 70,000 members of a gang (counts past 65,535: the
    packed tail saturates, the counts keep the full take)."""
    left = np.array([[100000, 8], [90000, 8], [5, 8]] + [[3, 8]] * 5, np.int64)
    req = np.array([[1, 0], [1, 0], [2, 1]])
    return dict(left=left, group_req=req, remaining=np.array([70000, 80000, 3]), g=3, n=8)


BLOB_CASES = {
    "broadcast": (dict(n=37, g=11), 0, 0),
    "per-group-invalid": (dict(n=50, g=13, per_group=True, invalid=(2, 7), seed=1), 0, 0),
    "wide-rows-ties": (_wide(), 0, 0),
    "wide-rows-wave": (_wide(seed=3, g=9), 8, 0),
    "k-equals-n": (dict(n=8, g=10, rem_hi=30, seed=4), 0, 0),
    "counts-past-65535": (_huge_counts(), 0, 0),
    "wave-w4": (dict(n=45, g=19, per_group=True, seed=5), 4, 0),
    "topk-k16": (dict(n=60, g=17, seed=6, rem_hi=25), 8, 16),
    "topk-k4-per-group": (dict(n=40, g=16, per_group=True, seed=7), 4, 4),
}


def _gates(batch_args):
    """dispatch_batch's pack gate and top-K width for these padded args."""
    nb = batch_args[0].shape[0]
    rmax = int(batch_args[3].max(initial=0))
    return nb <= 2**15 and rmax <= 2**16 - 1, port_oracle.batch_top_k(nb, rmax)


def _blobs(batch_args, progress_args, wave, topk):
    pack, top_k = _gates(batch_args)
    kw = dict(pack_assignment=pack, top_k=top_k, scan_wave=wave, scan_topk=topk)
    want_blob, want = jax_oracle._batch_blob(*batch_args, *progress_args, **kw)
    batch, progress = batch_from_numpy(batch_args, progress_args, "cpu")
    got_blob, got = port_oracle._batch_blob(*batch, *progress, **kw)
    return (np.asarray(want_blob), want), (got_blob.numpy(), got), pack, top_k


@pytest.mark.parametrize("case", sorted(BLOB_CASES))
def test_blob_matches_reference(case):
    """The blob (placed, feasible, progress, best, the compact tail, the
    rung's stats) and the out dict's compaction equal the reference's."""
    kw, wave, topk = BLOB_CASES[case]
    batch_args, progress_args = padded_batch(**kw)
    (want_blob, want), (got_blob, got), pack, k = _blobs(batch_args, progress_args, wave, topk)
    assert got_blob.dtype == want_blob.dtype == np.int32
    np.testing.assert_array_equal(got_blob, want_blob)
    keys = BLOB_KEYS + (("assignment_packed",) if "assignment_packed" in want else ())
    assert ("assignment_packed" in got) == ("assignment_packed" in want)
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    counts = got["assignment_counts"].numpy()
    nonzero = (got["assignment"].numpy() > 0).sum(axis=1)
    if case.startswith("wide"):
        assert (nonzero > k).any() and (counts[:, -1] > 0).any()
    if case == "k-equals-n":
        assert k == batch_args[0].shape[0]
    if case == "counts-past-65535":
        assert not pack and counts.max() > 65535
        assert (got["assignment_packed"].numpy() & 0xffff).max() == 65535


@pytest.mark.parametrize("n,rmax,packed", [
    (2**15, 2**16 - 1, True), (2**15 + 1, 100, False), (16, 2**16 - 1, True),
    (16, 2**16, False),
], ids=["n-2^15-rem-65535", "n-past-2^15", "rem-65535", "rem-65536"])
def test_pack_gate_boundaries_match_reference(n, rmax, packed):
    """At the gate's edges (n_bucket <= 2^15 and remaining_max <= 65,535)
    the host dicts through execute_batch_host equal the reference's, and
    the out dict carries the packed form exactly when N <= 2^15."""
    left = np.full((n, 1), 2**17, np.int64)
    kw = dict(left=left, group_req=np.array([[1], [1]]), remaining=np.array([rmax, 5]),
              g=2, n=n, roomy=0.0)
    batch_args, progress_args = padded_batch(**kw)
    assert _gates(batch_args)[0] == packed
    want, _ = jax_oracle.execute_batch_host(batch_args, progress_args)
    got, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    for key in ("placed", "gang_feasible", "progress", "best", "best_exists",
                "assignment_nodes", "assignment_counts"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    batch, _ = batch_from_numpy(batch_args, progress_args, "cpu")
    out = port_oracle.schedule_batch(*batch)
    assert ("assignment_packed" in out) == (batch_args[0].shape[0] <= 2**15)


def test_schedule_batch_compaction_matches_reference_on_a_policy_batch():
    """The compaction alone (schedule_batch, no blob) on the policy rung."""
    from test_torch_batch_head import policy_cols

    batch_args, _ = padded_batch(n=41, g=12, seed=8)
    cols = policy_cols(np.random.default_rng(8), batch_args[0].shape[0],
                       batch_args[2].shape[0])
    terms, weights = ("affinity", "anti-affinity", "spread"), (32, 8, 3)
    want = jax_oracle.schedule_batch(*batch_args, policy_cols=cols, policy_terms=terms,
                                     policy_weights=weights, top_k=16)
    from batch_scheduler_tpu_torch.ops.convert import policy_from_numpy

    batch, _ = batch_from_numpy(batch_args, (np.zeros(1, np.int32),) * 5, "cpu")
    got = port_oracle.schedule_batch(*batch, top_k=16,
                                     policy=(policy_from_numpy(cols, "cpu"), terms, weights))
    for key in ("assignment_nodes", "assignment_counts", "assignment_packed", "placed"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


# -- numpy models of the kernel's decomposition -------------------------------

TILE = 1024  # csrc/batch_tail.cu kTile: 256 threads x 4 entries


def _walk(row, t, need_eq, k, stop_past_k):
    """One ordered walk: the entries above t (at most 128 kept) and the
    first need_eq equal to t, both in node order; the count above t, or a
    count past k once seen."""
    above, equal, count = [], [], 0
    for tile in range(0, row.shape[0], TILE):
        part = row[tile:tile + TILE]
        for i in np.flatnonzero(part > t):
            if len(above) < 128:
                above.append((int(part[i]), tile + int(i)))
        count += int((part > t).sum())
        for i in np.flatnonzero(part == t):
            if len(equal) < need_eq:
                equal.append(tile + int(i))
        if stop_past_k and count > k:
            break
    return above, equal, count


def tail_row_model(row, k):
    """The kernel's row: (counts[k], nodes[k])."""
    above, equal, count = _walk(row, 0, k, k, True)
    t = 0
    if count > k:
        prefix, hi, kk = 0, 0, k
        for shift in (24, 16, 8, 0):
            sel = row[(row.astype(np.int64) & hi) == prefix]
            hist = np.bincount((sel.astype(np.int64) >> shift) & 255, minlength=256)
            cum, b = 0, 255
            while b > 0 and cum + hist[b] < kk:
                cum += hist[b]
                b -= 1
            prefix |= b << shift
            hi |= 255 << shift
            kk -= cum
        t = prefix
        above, equal, count = _walk(row, t, kk, k, False)
    ranked = [None] * count
    for i, (v, node) in enumerate(above[:count]):
        slot = sum(1 for j, (w, _) in enumerate(above[:count]) if w > v or (w == v and j < i))
        ranked[slot] = (v, node)
    out = ranked + [(t, node) for node in equal[:k - count]]
    return (np.array([v for v, _ in out], np.int32), np.array([x for _, x in out], np.int32))


def _rows():
    rng = np.random.default_rng(11)
    yield "no-take", np.zeros(40, np.int32), 16
    yield "k-equals-n", rng.integers(0, 3, size=16).astype(np.int32), 16
    row = np.zeros(3000, np.int32)
    row[rng.choice(3000, 40, replace=False)] = rng.integers(1, 4, size=40)
    yield "few-takes-ties", row, 64
    yield "wide-ties", rng.integers(0, 3, size=2500).astype(np.int32), 128
    row = np.zeros(5000, np.int32)
    row[rng.choice(5000, 700, replace=False)] = rng.integers(1, 2**18, size=700)
    yield "wide-large-counts", row, 100
    row = np.zeros(2100, np.int32)
    row[rng.choice(2100, 300, replace=False)] = rng.choice([7, 2**16 + 3, 2**30], size=300)
    yield "wide-high-digits", row, 128
    yield "all-ones", np.ones(1500, np.int32), 128


@pytest.mark.parametrize("name,row,k", list(_rows()), ids=[r[0] for r in _rows()])
def test_row_model_equals_lax_top_k(name, row, k):
    counts, nodes = tail_row_model(row, k)
    want_counts, want_nodes = jax.lax.top_k(row[None, :], k)
    np.testing.assert_array_equal(counts, np.asarray(want_counts)[0])
    np.testing.assert_array_equal(nodes, np.asarray(want_nodes)[0])
    got_counts, got_nodes = port_oracle._top_k_ties_by_index(torch.from_numpy(row)[None], k)
    np.testing.assert_array_equal(got_counts.numpy()[0], counts)
    np.testing.assert_array_equal(got_nodes.numpy()[0], nodes)


def first_max_model(keys, threads=256):
    """The O(G) block's argmax: each thread's first maximum over its
    strided share, a warp tree and a block pass preferring the larger key,
    then the smaller index."""
    best = []
    for t in range(threads):
        share = keys[t::threads]
        if share.size:
            i = int(np.argmax(share))
            best.append((int(share[i]), t + i * threads))
    key, idx = best[0]
    for k2, i2 in best[1:]:
        if k2 > key or (k2 == key and i2 < idx):
            key, idx = k2, i2
    return idx, key >= 0


@pytest.mark.parametrize("g,seed", [(8, 0), (300, 1), (1024, 2), (4099, 3)])
def test_first_max_model_equals_find_max_group(g, seed):
    """Ties of find_max_group's key across threads' shares and all
    ineligible groups (best 0, none exists)."""
    rng = np.random.default_rng(seed)
    min_member = rng.integers(1, 5, size=g).astype(np.int32)
    scheduled = rng.integers(0, 2, size=g).astype(np.int32)
    matched = np.zeros(g, np.int32)
    creation_rank = np.zeros(g, np.int32)  # equal ranks: many tied keys
    for ineligible in (rng.random(g) < 0.5, np.ones(g, bool)):
        args = (min_member, scheduled, matched, ineligible, creation_rank)
        best, exists, progress = (np.asarray(x) for x in jax_oracle.find_max_group(*args))
        key = (progress.astype(np.int64) * (2 * g + 2) + np.where(scheduled == 0, g + 1, 0)
               + (g - creation_rank))
        key = np.where(ineligible, -1, key)
        assert first_max_model(key) == (int(best), bool(exists))


def test_tail_work_counts_the_north_star():
    """tail_work at the north star [1024, 8192], k = 16: the [G, N] read
    dominates (32 MiB): bound by bytes; tail_bound counts one read of the
    assignment whatever the rows' widths."""
    g, n, k = 1024, 8192, 16
    nbytes, ops = bounds.tail_work(g, n, k)
    assert g * n * 4 < nbytes < g * n * 4 + 2**20
    assert ops == g * n
    assert bounds.bound(nbytes, ops)[1] == "bytes"
    a = torch.zeros((4, 300), dtype=torch.int32)
    a[0, :200] = 1  # wide at k = 16
    a[1, :5] = 2
    got = bounds.tail_bound(a, 16, blob=False)
    want = bounds.tail_work(4, 300, 16, False)
    assert got[2:] == want
    assert got == bounds.tail_bound(torch.zeros_like(a), 16, blob=False)


def test_tail_wrapper_refuses_bad_inputs():
    a = torch.zeros((4, 10), dtype=torch.int32)
    p = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="k must be"):
        bk.batch_tail_cuda(a, p, p, 11)
    with pytest.raises(ValueError, match="together"):
        bk.batch_tail_cuda(a, p, p, 4, feasible=p)
    big = torch.zeros((2, 2**15 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed"):
        bk.batch_tail_cuda(big, p[:2], p[:2], 4, progress=(a[:2, 0],) * 3 + (p[:2], a[:2, 0]),
                           feasible=p[:2], pack=True)
    before = bk.batch_tail_cuda.launches
    bk.batch_tail_cuda(a, p, p, 4)
    assert bk.batch_tail_cuda.launches == before  # the plain version launches nothing


def test_tail_source_limits_match_the_wrapper():
    assert "batch_tail" not in _build.VARIANTS
    text = (_build.CSRC_DIR / "batch_tail.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kMaxK"]) == bk._MAX_K == port_oracle.ASSIGNMENT_TOP_K
    assert int(consts["kThreads"]) * int(consts["kItems"]) == TILE


def test_bucket_report_prices_the_head_and_the_tail(monkeypatch):
    """/debug/buckets' rung entry carries the head's and the tail's bound
    beside the scan's, from the batch's shapes."""
    monkeypatch.setattr(port_oracle, "_bucket_costs", {})
    monkeypatch.setenv("BST_BUCKET_COST", "1")
    batch_args, progress_args = padded_batch(**_wide(seed=2, n=300, g=4))
    host, _ = port_oracle.execute_batch_host(batch_args, progress_args, device="cpu")
    g, n = host["telemetry"]["g_bucket"], host["telemetry"]["n_bucket"]
    rung = port_oracle.bucket_cost_report()[f"{g}x{n}"]["rungs"]["serial"]
    lanes = int((batch_args[2] > 0).sum())
    head = bounds.head_work(n, batch_args[0].shape[1], g, 1, lanes)
    assert rung["head"]["kernel"] == "batch_head"
    assert (rung["head"]["bytes"], rung["head"]["int_ops"]) == head
    batch, _ = batch_from_numpy(batch_args, progress_args, "cpu")
    out = port_oracle.schedule_batch(*batch, top_k=host["assignment_nodes"].shape[1])
    k = host["assignment_nodes"].shape[1]
    nonzero = (out["assignment"] > 0).sum(dim=1)
    wide = int((nonzero > k).sum())
    assert wide >= 1
    tail = bounds.tail_work(g, n, k, True)  # one read, wide rows or not
    assert rung["tail"]["kernel"] == "batch_tail"
    assert (rung["tail"]["bytes"], rung["tail"]["int_ops"]) == tail


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_tail_kernel_matches_plain_on_card():
    """The tail kernel against its plain version on the card: rows with no
    take, ties, more nonzero takes than k, counts past 65,535, k = N, both
    blob layouts, the stats of the wave and top-K rungs, and G from 1 to
    1,024, N up to 131,072."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for g, n, k, kind in ((1, 16, 16, "ties"), (64, 300, 16, "wide"), (1024, 8192, 16, "sparse"),
                          (8, 2**15, 128, "huge"), (33, 40000, 64, "wide"),
                          (512, 131072, 128, "sparse")):
        a = np.zeros((g, n), np.int32)
        if kind == "ties":
            a[:] = rng.integers(0, 3, size=(g, n))
        elif kind == "wide":
            a[:, :] = (rng.random((g, n)) < 0.6) * rng.integers(1, 4, size=(g, n))
        elif kind == "huge":
            a[:, 0] = 70000
            a[:, 1:200] = rng.integers(0, 5, size=(g, 199))
        else:
            for row in range(0, g, 3):
                cols = rng.choice(n, 10, replace=False)
                a[row, cols] = rng.integers(1, 5, size=10)
        placed = torch.from_numpy(rng.random(g) < 0.7)
        valid = torch.from_numpy(rng.random(g) < 0.9)
        feasible = torch.from_numpy(rng.random(g) < 0.8)
        progress = (torch.from_numpy(rng.integers(1, 9, size=g).astype(np.int32)),
                    torch.from_numpy(rng.integers(0, 3, size=g).astype(np.int32)),
                    torch.from_numpy(rng.integers(0, 9, size=g).astype(np.int32)),
                    torch.from_numpy(rng.random(g) < 0.3),
                    torch.from_numpy(rng.permutation(g).astype(np.int32)))
        steps = max(1, g // 8)
        stats = (torch.from_numpy(rng.random(steps) < 0.3), torch.from_numpy(rng.random(steps) < 0.5),
                 torch.from_numpy(rng.integers(0, 3, size=steps).astype(np.int32)))
        assignment = torch.from_numpy(a)
        for blob_kw in ({}, dict(progress=progress, feasible=feasible, pack=n <= 2**15),
                        dict(progress=progress, feasible=feasible, pack=False, stats=stats[:2]),
                        dict(progress=progress, feasible=feasible, pack=False, stats=stats)):
            want = bk.batch_tail_plain(assignment, placed, valid, k, **blob_kw)
            cuda_kw = {key: (tuple(t.cuda() for t in v) if isinstance(v, tuple)
                             else v.cuda() if torch.is_tensor(v) else v)
                       for key, v in blob_kw.items()}
            got = bk.batch_tail_cuda(assignment.cuda(), placed.cuda(), valid.cuda(), k, **cuda_kw)
            for x, y in zip(got, want):
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x.cpu(), y), (g, n, k, kind, sorted(blob_kw))
