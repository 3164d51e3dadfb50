"""The port's node-sharded scan (``ops.oracle.assign_gangs_sharded`` on a
``parallel.ShardMesh``) on gloo CPU ranks, held against the JAX package's
``assign_gangs_sharded`` on the conftest's 8-device CPU mesh at the same S
and against the serial scan: the assignment, the placement, the leftover
and the per-wave conflict and mega stats, bit for bit (every tolerance here
is exact equality). The cases mirror ``tests/test_sharded_scan.py``:
shard-count invariance, contended waves that demote, uniform waves that
take the mega path, uneven node counts, the broadcast and per-group masks,
and the tie-break on the global node index; then ``sharded_schedule_batch``
on both rungs against ``schedule_batch``, and the scan's collective budget.

The ranks (meshes of S = 1, 2 and 4) are spawned once for the module by
``tests/torch_mesh_worker.py`` and run every case; the JAX side runs here.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from batch_scheduler_tpu.ops.oracle import assign_gangs, assign_gangs_sharded, schedule_batch
from batch_scheduler_tpu.ops.snapshot import ClusterSnapshot, GroupDemand
from batch_scheduler_tpu.parallel.mesh import make_mesh
from batch_scheduler_tpu.sim.scenarios import make_sim_node

from torch_mesh_worker import spawn

SIZES = (1, 2, 4)


def _scan_case(n=48, g=14, r=3, per_group=False, uniform=False, seed=7, uniform_mask=False):
    """Raw scan inputs (unbucketed, so N can split unevenly): the
    reference test's ``_scan_case``, plus per-group masks whose rows are
    all equal (``uniform_mask``: the mask-uniformity reduce lets their
    waves take the mega path)."""
    rng = np.random.RandomState(seed)
    left = rng.randint(0, 120, size=(n, r)).astype(np.int32)
    if uniform:
        req = np.tile(rng.randint(1, 6, size=(1, r)), (g, 1)).astype(np.int32)
    else:
        req = rng.randint(0, 6, size=(g, r)).astype(np.int32)
    rem = rng.randint(0, 30, size=(g,)).astype(np.int32)
    if uniform_mask:
        mask = np.tile(rng.randint(0, 2, size=(1, n)), (g, 1)).astype(bool)
    elif per_group:
        mask = rng.randint(0, 2, size=(g, n)).astype(bool)
    else:
        mask = np.ones((1, n), bool)
    order = rng.permutation(g).astype(np.int32)
    return left, req, rem, mask, order


def _tiebreak_case():
    n, g, r = 16, 2, 2
    return (np.full((n, r), 10, np.int32), np.full((g, r), 2, np.int32),
            np.array([6, 6], np.int32), np.ones((1, n), bool), np.array([0, 1], np.int32))


# name -> (scan inputs, wave); the reference test's cases first
SCAN_CASES = {
    **{f"counts_seed{3 + s}": (_scan_case(seed=3 + s), 4) for s in SIZES},
    "contended": (_scan_case(n=24, g=12, per_group=True, seed=11), 4),
    "uniform_mega": (_scan_case(n=64, g=16, uniform=True, seed=5), 4),
    **{f"uneven_n{n}": (_scan_case(n=n, g=9, uniform=True, seed=n), 4) for n in (37, 50, 61)},
    "tiebreak": (_tiebreak_case(), 2),
    "per_group_uniform_masks": (_scan_case(n=40, g=16, uniform=True, seed=13,
                                           uniform_mask=True), 4),
    "wide_per_group": (_scan_case(n=90, g=40, r=5, per_group=True, seed=21), 8),
}


def _snapshot_args(num_nodes=48, num_groups=18):
    nodes = [make_sim_node(f"n{i:03d}", {"cpu": "16", "memory": "64Gi", "pods": "32"})
             for i in range(num_nodes)]
    groups = [GroupDemand(full_name=f"default/g{x:03d}", min_member=4 + (x % 3),
                          member_request={"cpu": 2000, "memory": 4 * 1024**3},
                          creation_ts=float(x))
              for x in range(num_groups)]
    return tuple(np.asarray(a) for a in ClusterSnapshot(nodes, {}, groups).device_args())


BATCH_ARGS = _snapshot_args()


def _suite():
    suite = [(f"scan/{name}", "scan", (*args, wave)) for name, (args, wave) in SCAN_CASES.items()]
    suite += [("batch/sharded", "batch", (BATCH_ARGS, False, True, 4)),
              ("batch/sharded_w8", "batch", (BATCH_ARGS, False, True, 0)),
              ("batch/replicated", "batch", (BATCH_ARGS, True, False, 0)),
              ("budget", "budget", [(_snapshot_args(64, 8), 8), (_snapshot_args(64, 32), 8)])]
    return suite


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{S: {case: rank 0's result}}`` from one spawn of every mesh."""
    out = spawn(_suite(), SIZES, str(tmp_path_factory.mktemp("shard_ranks")))
    for s, res in out.items():
        for name, r in res.items():
            assert not (isinstance(r, dict) and "error" in r), (s, name, r["error"])
    return out


def _jax_sharded(args, s, wave):
    j = [jnp.asarray(a) for a in args]
    alloc, placed, left, (conf, megas) = assign_gangs_sharded(
        *j, mesh=make_mesh(s), wave=wave, with_stats=True)
    return tuple(np.asarray(x) for x in (alloc, placed, left, conf, megas))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_sharded_scan_matches_reference_and_serial(ranks, name, s):
    """The port's sharded scan at S ranks equals the reference's at S
    devices on all five outputs, and the serial scan on the first three."""
    args, wave = SCAN_CASES[name]
    got = ranks[s][f"scan/{name}"]
    want = _jax_sharded(args, s, wave)
    for label, a, b in zip(("alloc", "placed", "left", "conflicts", "megas"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} S={s} {label}")
    serial = [np.asarray(x) for x in assign_gangs(*(jnp.asarray(a) for a in args))]
    for label, a, b in zip(("alloc", "placed", "left"), got, serial):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} S={s} {label} (serial)")
    assert got[0].shape == (args[1].shape[0], args[0].shape[0])


@pytest.mark.parametrize("s", SIZES)
def test_branches_are_exercised(ranks, s):
    """The contended case demotes (its verify reduce fired), the uniform
    case commits waves on the mega path, and per-group masks whose rows
    agree take it too (the once-a-batch uniformity reduce)."""
    assert ranks[s]["scan/contended"][3].any()
    assert ranks[s]["scan/uniform_mega"][4].any() and not ranks[s]["scan/uniform_mega"][3].any()
    assert ranks[s]["scan/per_group_uniform_masks"][4].all()
    assert not ranks[s]["scan/wide_per_group"][4].any()


@pytest.mark.parametrize("s", SIZES)
def test_tiebreak_is_global_node_index(ranks, s):
    """Identical nodes split across ranks: the members sit on the lowest
    global node indices (0, 1, 2), whichever rank merged first."""
    alloc, placed = ranks[s]["scan/tiebreak"][:2]
    assert np.where(alloc.sum(axis=0) > 0)[0].tolist() == [0, 1, 2]
    assert placed.all()


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("rung", ["sharded", "sharded_w8", "replicated"])
def test_sharded_schedule_batch_matches_single_device(ranks, rung, s):
    """``sharded_schedule_batch`` on either rung equals the reference's
    single-device ``schedule_batch`` on every output key both return."""
    want = {k: np.asarray(v) for k, v in schedule_batch(*BATCH_ARGS).items()}
    got = ranks[s][f"batch/{rung}"]
    keys = sorted(set(want) & set(got) - {"wave_conflicts", "wave_megas"})
    assert {"gang_feasible", "placed", "capacity", "assignment", "scores",
            "left_after", "assignment_nodes", "assignment_counts"} <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rung} S={s} {k}")
    if rung != "replicated":
        wave = 4 if rung == "sharded" else 8
        assert got["wave_conflicts"].shape == (-(-BATCH_ARGS[2].shape[0] // wave),)


@pytest.mark.parametrize("s", SIZES)
def test_scan_collective_budget(ranks, s):
    """The scan's collectives at G = 8 and G = 32: the same call sites,
    every call at most the [S, W, 128] summary, never node state, and 2 a
    wave on the fast path (the merge and the verify)."""
    small, big = ranks[s]["budget"]
    assert small["counts"] == big["counts"] == {"all_reduce": 2, "broadcast": 0, "gather": 0}
    assert big["waves"] > small["waves"]
    for rep in (small, big):
        assert rep["max_collective_bytes"] <= rep["summary_bytes"] == s * 8 * 128 * 4, rep
        assert rep["fastpath_collectives_per_wave"] == 2, rep
        assert rep["calls"]["all_reduce"] == 2 * rep["waves"] + rep["sites"].get("replay", 0)


@pytest.mark.parametrize("mode", ["speculative", "mega", "replayed"])
def test_shard_work_counts_each_tensor_once(mode):
    """``ops.bounds.shard_work`` of one wave at S = 2 counts the bytes of
    the tensors its summary and apply read and write, each once: a uniform
    wave's merged buffer is [S, 1, 128] (its one stream row), a
    speculative wave's [S, W, 128], and a replayed wave adds a [S, 1, 128]
    merge for each of its gangs."""
    import torch

    from batch_scheduler_tpu_torch.ops import oracle
    from batch_scheduler_tpu_torch.ops.bounds import shard_work

    s, nl, r, w = 2, 24, 3, 4
    left = torch.zeros((nl, r), dtype=torch.int32)
    req = torch.ones((w, r), dtype=torch.int32)
    needs = torch.ones(w, dtype=torch.int32)
    mask = torch.ones((1, nl), dtype=torch.bool)
    rows = 1 if mode == "mega" else w
    merged = torch.zeros((s, rows, oracle._BINS), dtype=torch.int32)
    takes = torch.zeros((w, nl), dtype=torch.int32)
    feas = torch.zeros(w, dtype=torch.bool)
    verify = torch.zeros(w, dtype=torch.int32)
    reads = (left, req, needs, mask, merged)
    writes = (takes, feas, left, merged, verify)
    nbytes = sum(t.numel() * t.element_size() for t in reads + writes)
    conflicts = int(mode == "replayed")
    if conflicts:  # each gang's merge: its buffer read and written
        nbytes += w * 2 * s * oracle._BINS * 4
    got, _ = shard_work(nl, r, w, s, w, int((req > 0).sum()), 1, conflicts,
                        int(mode == "mega"))
    assert got == nbytes
