"""The port's node-sharded top-K scan (``ops.oracle.assign_gangs_topk_sharded``
on a ``parallel.ShardMesh``) on gloo CPU ranks, held against the JAX
package's ``assign_gangs_topk_sharded`` on the conftest's 8-device CPU mesh
at the same S and against the serial scan: the assignment, the placement,
the leftover and the per-wave conflict, mega and dense-demotion stats, bit
for bit (every tolerance here is exact equality). The cases are the
reference's ``tests/test_topk_scan.py``: a K sweep, per-group masks, uniform
waves, uneven node counts, an adversarial tight fit that forces dense-column
demotions, and a pooled-infeasible gang. Then the rank's two steps
(``shard_topk_summary`` / ``shard_topk_apply``) against the scan's own
waves, ``sharded_schedule_batch(scan_topk=16)`` against the reference's, the
scan's collective budget, and a pinned rung that never runs sharded.

The ranks (meshes of S = 1, 2 and 4) are spawned once for the module by
``tests/torch_mesh_worker.py`` and run every case; the JAX side runs here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from batch_scheduler_tpu.ops.oracle import assign_gangs, assign_gangs_topk_sharded
from batch_scheduler_tpu.ops.snapshot import ClusterSnapshot, GroupDemand
from batch_scheduler_tpu.parallel.mesh import make_mesh, sharded_schedule_batch
from batch_scheduler_tpu.sim.scenarios import make_sim_node

from batch_scheduler_tpu_torch.ops import oracle as port
from batch_scheduler_tpu_torch.ops.assign_scan import (
    shard_topk_apply_cuda,
    shard_topk_summary_cuda,
)

from torch_mesh_worker import spawn

SIZES = (1, 2, 4)


def _scan_case(n=48, g=14, r=3, per_group=False, uniform=False, seed=7):
    """Raw scan inputs (unbucketed, so N can split unevenly): the reference
    test's ``_scan_case``."""
    rng = np.random.RandomState(seed)
    left = rng.randint(0, 120, size=(n, r)).astype(np.int32)
    if uniform:
        req = np.tile(rng.randint(1, 6, size=(1, r)), (g, 1)).astype(np.int32)
    else:
        req = rng.randint(0, 6, size=(g, r)).astype(np.int32)
    rem = rng.randint(0, 30, size=(g,)).astype(np.int32)
    mask = (rng.randint(0, 2, size=(g, n)) if per_group else np.ones((1, n))).astype(bool)
    order = rng.permutation(g).astype(np.int32)
    return left, req, rem, mask, order


def _tight_case():
    """One member per node: a gang of 10 cannot be covered by 4 candidates
    while the pooled capacity says it fits (the reference's adversarial
    tight fit)."""
    n, g, r = 40, 3, 2
    return (np.full((n, r), 5, np.int32), np.full((g, r), 5, np.int32),
            np.array([10, 10, 10], np.int32), np.ones((1, n), bool),
            np.array([0, 1, 2], np.int32))


def _infeasible_case():
    n, g, r = 24, 2, 2
    return (np.full((n, r), 5, np.int32), np.full((g, r), 5, np.int32),
            np.array([n + 10, 4], np.int32), np.ones((1, n), bool),
            np.array([0, 1], np.int32))


# name -> (scan inputs, wave, k)
SCAN_CASES = {
    **{f"k{k}": (_scan_case(seed=k), 4, k) for k in (4, 16, 64)},
    "per_group": (_scan_case(n=32, g=10, per_group=True, seed=17), 4, 8),
    "uniform": (_scan_case(n=64, g=16, uniform=True, seed=5), 4, 16),
    "uneven_n37": (_scan_case(n=37, g=9, seed=37), 4, 8),
    "tight_k4": (_tight_case(), 4, 4),
    "tight_k16": (_tight_case(), 4, 16),
    "pooled_infeasible": (_infeasible_case(), 4, 4),
}


def _snapshot_args(num_nodes=48, num_groups=18):
    nodes = [make_sim_node(f"n{i:03d}", {"cpu": "16", "memory": "64Gi", "pods": "32"})
             for i in range(num_nodes)]
    groups = [GroupDemand(full_name=f"default/g{x:03d}", min_member=4 + (x % 3),
                          member_request={"cpu": 2000, "memory": 4 * 1024**3},
                          creation_ts=float(x))
              for x in range(num_groups)]
    snap = ClusterSnapshot(nodes, {}, groups)
    return (tuple(np.asarray(a) for a in snap.device_args()),
            tuple(np.asarray(a) for a in snap.progress_args()))


BATCH_ARGS, BATCH_PROGRESS = _snapshot_args()


def _suite():
    suite = [(f"scan/{name}", "topk_scan", (*args, wave, k))
             for name, (args, wave, k) in SCAN_CASES.items()]
    suite += [("batch/topk16", "batch", (BATCH_ARGS, False, True, 0, 16)),
              ("budget", "budget", [(_snapshot_args(64, 8)[0], 8, 16),
                                    (_snapshot_args(64, 32)[0], 8, 16),
                                    (_snapshot_args(64, 96)[0], 8, 16)]),
              ("pinned", "pinned", _snapshot_args(24, 8))]
    return suite


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{S: {case: rank 0's result}}`` from one spawn of every mesh."""
    out = spawn(_suite(), SIZES, str(tmp_path_factory.mktemp("topk_ranks")))
    for s, res in out.items():
        for name, r in res.items():
            assert not (isinstance(r, dict) and "error" in r), (s, name, r["error"])
    return out


def _jax_topk_sharded(args, s, wave, k):
    j = [jnp.asarray(a) for a in args]
    alloc, placed, left, stats = assign_gangs_topk_sharded(
        *j, mesh=make_mesh(s), wave=wave, k=k, with_stats=True)
    return tuple(np.asarray(x) for x in (alloc, placed, left, *stats))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_sharded_topk_matches_reference_and_serial(ranks, name, s):
    """The port's sharded top-K scan at S ranks equals the reference's at S
    devices on the three outputs and the three per-wave stats, and the
    serial scan on the outputs."""
    args, wave, k = SCAN_CASES[name]
    got = ranks[s][f"scan/{name}"]
    want = _jax_topk_sharded(args, s, wave, k)
    labels = ("alloc", "placed", "left", "conflicts", "megas", "dense_demotions")
    for label, a, b in zip(labels, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} S={s} {label}")
    serial = [np.asarray(x) for x in assign_gangs(*(jnp.asarray(a) for a in args))]
    for label, a, b in zip(labels, got, serial):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} S={s} {label} (serial)")
    assert got[0].shape == (args[1].shape[0], args[0].shape[0])
    assert got[2].shape == args[0].shape


@pytest.mark.parametrize("s", SIZES)
def test_branches_and_demotions_are_exercised(ranks, s):
    """The tight fit demotes every gang to the dense-column replay at K=4
    and none at K=16; the pooled-infeasible gang needs none; uniform waves
    take the mega path; per-group masks replay."""
    assert ranks[s]["scan/tight_k4"][5].sum() >= 3
    assert ranks[s]["scan/tight_k16"][5].sum() == 0
    assert ranks[s]["scan/pooled_infeasible"][5].sum() == 0
    assert not ranks[s]["scan/pooled_infeasible"][1][0]
    assert ranks[s]["scan/uniform"][4].all()
    assert ranks[s]["scan/per_group"][3].any()


def _emulated_wave(args, s, wave, k, mode):
    """The first wave of ``args`` through ``s`` emulated ranks of one
    process: each rank's summary (the wrappers, which run the plain steps
    for CPU tensors), the merge as the sum of their buffers, each rank's
    apply. Returns the ranks' takes concatenated over the node axis, the
    feasibility, the verify words and the demotions."""
    left, req, rem, mask, order = (torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    mask = mask.bool()
    n, r = left.shape
    nl = -(-n // s)
    idx = order.long()[:wave]
    req_c, need_c = req[idx], rem[idx]
    rows = wave if mode == port.TOPK_SPECULATIVE else 1
    kk_l, _ = port.shard_topk_widths(k, nl, s)
    p = port.shard_topk_payload(mode, kk_l, need_c.shape[0] if mode != port.TOPK_REPLAY else 1)
    blocks, caps = [], []
    merged = torch.zeros((s, rows, p), dtype=torch.int32)
    for rank in range(s):
        block = left.new_zeros((nl, r))
        block[:max(0, min(n, (rank + 1) * nl) - rank * nl)] = left[rank * nl:(rank + 1) * nl]
        mrow = torch.zeros((1, nl), dtype=torch.bool)
        mrow[0, :block.shape[0]] = True
        mrow[0, max(0, min(n, (rank + 1) * nl) - rank * nl):] = False
        buf = torch.empty((s, rows, p), dtype=torch.int32)
        needs = need_c[:1] if mode == port.TOPK_REPLAY else need_c
        cap = shard_topk_summary_cuda(mode, block, req_c[:rows], needs, mrow, buf, rank, k)
        merged += buf
        blocks.append((block, mrow, needs))
        caps.append(cap)
    takes, feas, verify, dense = [], [], [], []
    for rank, ((block, mrow, needs), cap) in enumerate(zip(blocks, caps)):
        w = needs.shape[0]
        t = torch.full((w, nl), -1, dtype=torch.int32)
        f = torch.zeros(w, dtype=torch.bool)
        v = None if mode == port.TOPK_REPLAY else torch.zeros(1, dtype=torch.int32)
        d = torch.zeros(1, dtype=torch.int32)
        shard_topk_apply_cuda(mode, merged, rank, cap, needs, block, req_c[:rows], mrow, t, f,
                              torch.empty_like(block), v, d, k, torch.empty(nl, dtype=torch.int32))
        takes.append(t)
        feas.append(f)
        verify.append(None if v is None else int(v))
        dense.append(int(d))
    return torch.cat(takes, 1)[:, :n].numpy(), feas, verify, dense


@pytest.mark.parametrize("s", (1, 2, 4))
@pytest.mark.parametrize("mode,case", [(0, "k16"), (1, "uniform"), (2, "k16"), (2, "tight_k4")])
def test_rank_steps_compose_to_the_scan(mode, case, s):
    """The two steps on emulated ranks: every rank derives the same
    feasibility and verdict from the merged buffer (the replicated
    selection), and the ranks' takes, concatenated, are the single-device
    top-K scan's first wave (a committed speculative or uniform wave), or
    the serial scan's first gang (a replayed gang, dense-column demoted in
    the tight fit on every rank alike)."""
    args, wave, k = SCAN_CASES[case]
    takes, feas, verify, dense = _emulated_wave(args, s, wave, k, mode)
    assert all(torch.equal(f, feas[0]) for f in feas)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    t[3] = t[3].bool()
    order = t[4].long()
    if mode == port.TOPK_REPLAY:
        alloc, placed, _ = port.assign_gangs(*t)
        np.testing.assert_array_equal(takes[0], alloc[order[0]].numpy())
        assert bool(feas[0][0]) == bool(placed[order[0]])
        assert len(set(dense)) == 1 and dense[0] == int(case == "tight_k4")
        return
    alloc, placed, _, (conflicts, megas, _) = port.assign_gangs_topk(*t, wave=wave, k=k,
                                                                     with_stats=True)
    if mode == port.TOPK_MEGA:
        assert bool(megas[0]) and len(set(verify)) == 1  # replicated: no reduce
        committed = verify[0] == 1
    else:
        committed = sum(verify) == 0  # the verify reduce
    assert committed == (not bool(conflicts[0]))
    if committed:
        np.testing.assert_array_equal(takes, alloc[order[:wave]].numpy())
        assert torch.equal(feas[0], placed[order[:wave]])


@pytest.mark.parametrize("s", SIZES)
def test_sharded_schedule_batch_topk_matches_reference(ranks, s):
    """``sharded_schedule_batch(sharded_scan=True, scan_topk=16)`` equals the
    reference's on its own S-device mesh on every output both return, and
    carries the per-wave flags and the demotions."""
    want = jax.device_get(sharded_schedule_batch(make_mesh(s), BATCH_ARGS, sharded_scan=True,
                                                 scan_topk=16))
    got = ranks[s]["batch/topk16"]
    keys = sorted(set(want) & set(got))
    assert {"gang_feasible", "placed", "capacity", "assignment", "scores", "left_after",
            "assignment_nodes", "assignment_counts"} <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"S={s} {k}")
    steps = -(-BATCH_ARGS[2].shape[0] // 8)
    assert got["wave_conflicts"].shape == (steps,) and "topk_demotions" in got


@pytest.mark.parametrize("s", SIZES)
def test_topk_collective_budget(ranks, s):
    """The sharded top-K scan's collectives at G = 8, 32 and 96: the same
    call sites whatever G, every call at most the largest candidate payload
    (``summary_bytes``), never node state, at most 2 a wave on the fast
    path (a uniform wave 1) and one merge a replayed gang."""
    reps = ranks[s]["budget"]
    for rep in reps:
        assert rep["counts"]["broadcast"] == rep["counts"]["gather"] == 0
        assert set(rep["sites"]) <= {"merge", "verify", "replay"}, rep
        assert rep["max_collective_bytes"] <= rep["summary_bytes"], rep
        assert rep["fastpath_collectives_per_wave"] <= 2, rep
        merges = rep["sites"].get("merge", 0)
        assert merges == rep["waves"] and rep["sites"].get("verify", 0) <= rep["waves"]
    assert reps[2]["waves"] > reps[0]["waves"]


@pytest.mark.parametrize("s", SIZES)
def test_pinned_rung_runs_replicated_never_sharded(ranks, s):
    """A ``forced_scan_rung(8, 16)`` pin on a mesh runs the top-K rung
    replicated (``scan_sharded`` False), the unpinned batch with
    ``BST_SCAN_TOPK`` set the sharded top-K rung; both equal one device."""
    res = ranks[s]["pinned"]
    pinned, free = res["pinned"]["telemetry"], res["free"]["telemetry"]
    assert pinned["scan_topk"] == 16 and pinned["scan_sharded"] is False
    assert free["scan_topk"] == 16 and free["scan_sharded"] is True
    assert free["shard_count"] == s and "topk_demotions" in free
    for key in ("placed", "gang_feasible", "assignment_nodes", "assignment_counts"):
        np.testing.assert_array_equal(res["pinned"][key], res["single"][key])
        np.testing.assert_array_equal(res["free"][key], res["single"][key])


@pytest.mark.parametrize("mode", ["speculative", "mega", "replayed"])
def test_shard_topk_work_counts_each_tensor_once(mode):
    """``ops.bounds.shard_topk_work`` of one wave at S = 2 counts the bytes
    of the tensors its summary and apply read and write, each once: the
    summary buffer of the wave's branch written and read, a replayed
    wave's buffer for each of its gangs, and a verify and a demotion word."""
    from batch_scheduler_tpu_torch.ops.bounds import shard_topk_work

    s, nl, r, w, k = 2, 24, 3, 4, 8
    kk_l, _ = port.shard_topk_widths(k, nl, s)
    rows = 1 if mode == "mega" else w
    branch = port.TOPK_MEGA if mode == "mega" else port.TOPK_SPECULATIVE
    t = {
        "left": (nl, r, 4), "req": (w, r, 4), "needs": (w, 1, 4), "mask": (1, nl, 1),
        "takes": (w, nl, 4), "feas": (w, 1, 1), "left_out": (nl, r, 4),
        "words": (2, 1, 4), "buffer": (s * rows, port.shard_topk_payload(branch, kk_l, w), 4),
    }
    nbytes = sum(a * b * c for a, b, c in t.values()) + t["buffer"][0] * t["buffer"][1] * 4
    conflicts = int(mode == "replayed")
    if conflicts:  # each gang's merge: its buffer written and read
        nbytes += w * 2 * s * port.shard_topk_payload(port.TOPK_REPLAY, kk_l, 1) * 4
    got, ops = shard_topk_work(nl, r, w, s, w, k, r * w, 1, conflicts, int(mode == "mega"), 0)
    assert got == nbytes and ops > 0


@pytest.mark.parametrize("lib", ["shard_wave", "shard_topk"])
def test_shard_sources_build_from_the_shared_header(tmp_path, lib):
    """Both node-sharded libraries include csrc/shard_common.cuh: an edited
    header changes each one's build digest (so both rebuild)."""
    import shutil

    from batch_scheduler_tpu_torch.ops import _build

    assert lib not in _build.VARIANTS
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    src = csrc / f"{lib}.cu"
    before = _build.digest(src)
    assert before == _build.digest(_build.CSRC_DIR / f"{lib}.cu")
    header = csrc / "shard_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.digest(src) != before
