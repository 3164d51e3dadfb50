"""The port's ``parallel`` package on gloo CPU ranks against the JAX
package's: the bootstrap without a coordinator, the mesh's grid and blocks,
``sharded_schedule_batch`` on both rungs against the reference's sharded
and single-device batches on ``tests/test_parallel.py``'s shapes, the
replicated rung's collectives, the dispatch's rung choice on a mesh (the
sharded rung by default, ``BST_SCAN_SHARDED=0`` the replicated one, a pin
or a policy batch never sharded) with its telemetry and series, and a
leader/follower ``OracleScorer(scan_mesh=...)`` whose plans equal a
single-rank scorer's. Every comparison is exact equality.

The meshes (S = 1, 2 and 4) are spawned once for the module by
``tests/torch_mesh_worker.py`` and run every case.
"""

import numpy as np
import pytest

import jax

from batch_scheduler_tpu.ops import ClusterSnapshot, GroupDemand, schedule_batch
from batch_scheduler_tpu.parallel import make_mesh as jax_make_mesh
from batch_scheduler_tpu.parallel import sharded_schedule_batch as jax_sharded_schedule_batch
from batch_scheduler_tpu.parallel.mesh import _factor_devices
from batch_scheduler_tpu.sim.scenarios import make_sim_node

from torch_mesh_worker import HOST_KEYS, spawn

SIZES = (1, 2, 4)
SHAPES = ((32, 16), (64, 32), (100, 24), (16, 8))  # tests/test_parallel.py's


def _snapshot(num_nodes=32, num_groups=16):
    nodes = [make_sim_node(f"n{i:03d}", {"cpu": "16", "memory": "64Gi", "pods": "32"})
             for i in range(num_nodes)]
    groups = [GroupDemand(full_name=f"default/g{g:03d}", min_member=4 + (g % 3),
                          member_request={"cpu": 2000, "memory": 4 * 1024**3},
                          creation_ts=float(g))
              for g in range(num_groups)]
    return ClusterSnapshot(nodes, {}, groups)


def _args(num_nodes, num_groups):
    return tuple(np.asarray(a) for a in _snapshot(num_nodes, num_groups).device_args())


def _progress(snap):
    return tuple(np.asarray(a) for a in snap.progress_args())


def _suite():
    suite = [("mesh_info", "mesh_info", [37, 48, 50, 8192])]
    for n, g in SHAPES:
        for rung, rep, sh in (("replicated", True, False), ("sharded", False, True)):
            suite.append((f"batch/{rung}/{n}x{g}", "batch", (_args(n, g), rep, sh, 0)))
    snap = _snapshot(24, 8)
    suite += [("collectives", "collectives", _args(32, 16)),
              ("shares", "shares", _args(37, 8)),
              ("dispatch", "dispatch", (_args(24, 8), _progress(snap))),
              ("scorer", "scorer", (24, 10, 4))]
    return suite


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{S: {case: rank 0's result}}`` from one spawn of every mesh."""
    out = spawn(_suite(), SIZES, str(tmp_path_factory.mktemp("parallel_ranks")))
    for s, res in out.items():
        for name, r in res.items():
            assert not (isinstance(r, dict) and "error" in r), (s, name, r["error"])
    return out


def test_init_distributed_noop_without_coordinator(monkeypatch):
    """No coordinator configured: the single-process no-op, False, in both
    packages (and the port resolves no device for it)."""
    from batch_scheduler_tpu.parallel import init_distributed as jax_init
    from batch_scheduler_tpu_torch.parallel import init_distributed

    monkeypatch.delenv("BST_COORDINATOR", raising=False)
    assert init_distributed() is False
    assert init_distributed(device="cpu") is False
    assert jax_init() is False


def test_port_imports_no_jax():
    """The parallel package and its worker import nothing of jax or the JAX
    package (the walk of tests/test_torch_slice.py covers the package; this
    covers the worker script the ranks run)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m == "jax" or m.startswith(("jax.", "batch_scheduler_tpu."))
                and not m.startswith("batch_scheduler_tpu_torch")]


@pytest.mark.parametrize("s", SIZES)
def test_mesh_grid_and_blocks(ranks, s):
    """The grid is the reference's ``_factor_devices``; rank 0's node
    block is the first ceil(N / S) nodes (padded past N), its grid block
    the first of each axis."""
    info = ranks[s]["mesh_info"]
    g, n = _factor_devices(s)
    assert info["size"] == s and info["rank"] == 0
    assert info["shape"] == {"groups": g, "nodes": n}
    assert tuple(info["axis_names"]) == ("groups", "nodes")
    for nodes, block in zip([37, 48, 50, 8192], info["node_blocks"]):
        size = -(-nodes // s)
        assert tuple(block) == (0, min(size, nodes), size)
    (gb, nb), _ = info["grid_blocks"]
    assert tuple(gb) == (0, -(-8 // g), -(-8 // g)) and tuple(nb) == (0, -(-16 // n), -(-16 // n))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("rung", ["replicated", "sharded"])
def test_sharded_schedule_batch_matches_reference(ranks, rung, shape, s):
    """Either rung on S ranks equals the reference's single-device batch
    and its sharded batch on S devices, on every key the three return
    (``tests/test_parallel.py``: gang_feasible, placed, capacity,
    assignment; here every common key)."""
    args = _args(*shape)
    single = {k: np.asarray(v) for k, v in schedule_batch(*args).items()}
    ref = jax.device_get(jax_sharded_schedule_batch(
        jax_make_mesh(s), args, replicated_scan=rung == "replicated",
        sharded_scan=rung == "sharded"))
    got = ranks[s][f"batch/{rung}/{shape[0]}x{shape[1]}"]
    keys = sorted(set(single) & set(got) & set(ref))
    assert {"gang_feasible", "placed", "capacity", "assignment"} <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], single[k], err_msg=f"{rung} {k} (single)")
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=f"{rung} {k} (mesh)")


@pytest.mark.parametrize("s", SIZES)
def test_replicated_rung_collectives(ranks, s):
    """The replicated rung's whole batch is one collective (the head's
    gather to rank 0), none inside the scan: the reference bounds its
    module at 16."""
    assert ranks[s]["collectives"] == {"all_reduce": 0, "broadcast": 0, "gather": 1}


@pytest.mark.parametrize("s", SIZES)
def test_only_rank_0_gets_the_output(ranks, s):
    """On either rung rank 0 gets the whole output dict and every other
    rank None once its collectives are done (the blocks go to rank 0
    alone)."""
    assert ranks[s]["shares"] == 0


@pytest.mark.parametrize("s", SIZES)
def test_dispatch_rungs_on_a_mesh(ranks, s):
    """``execute_batch_host(..., scan_mesh=mesh)`` on rank 0 with the other
    ranks following: the sharded rung by default (W=8, its telemetry and
    ``bst_scan_shard_count``), the replicated rung under
    ``BST_SCAN_SHARDED=0`` and under a ``forced_scan_rung`` pin, and a
    policy batch on rank 0 alone; every host dict equals the single-device
    one."""
    d = ranks[s]["dispatch"]
    host, tel = d["default"]
    assert tel["scan_sharded"] is True and tel["shard_count"] == s
    assert tel["wave_width"] == 8 and tel["waves_per_batch"] == 1
    for label in ("default", "knob_off", "pinned"):
        for k in HOST_KEYS:
            np.testing.assert_array_equal(d[label][0][k], d["single"][k], err_msg=f"{label} {k}")
    for label in ("knob_off", "pinned"):
        assert d[label][1]["scan_sharded"] is False and "shard_count" not in d[label][1]
    assert d["pinned"][1]["wave_width"] == 0
    host, tel, single = d["policy"]
    assert tel["scan_sharded"] is False and tel["scan_policy"] is True
    for k in HOST_KEYS:
        np.testing.assert_array_equal(host[k], single[k], err_msg=f"policy {k}")
    assert list(d["series"]["shard_count"].values()) == [float(s)]
    assert list(d["series"]["sharded_enabled"].values()) == [1.0]
    # rank 0 broadcast a header and the arrays of each of the three mesh
    # batches (read before the stop header); the policy batch stayed on
    # rank 0
    if s > 1:
        assert d["counts"]["broadcast/batch"]["calls"] == 3
        assert d["counts"]["broadcast/header"]["calls"] == 3


@pytest.mark.parametrize("s", SIZES)
def test_leader_follower_scorer_plans(ranks, s):
    """``OracleScorer(scan_mesh=mesh)`` on rank 0, the others in
    ``follow``: each refresh's plan equals a single-rank scorer's, every
    batch is sharded over S ranks, and ``close`` stops the followers."""
    sc = ranks[s]["scorer"]
    assert sc["stopped"] is True and sc["batches"] == 5
    for got, want in sc["plans"]:
        assert got == want
    assert any(placed for _, placed, _ in sc["plans"][0][0])
    for tel in sc["telemetry"]:
        assert tel["scan_sharded"] is True and tel["shard_count"] == s
