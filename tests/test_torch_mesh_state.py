"""The port's mesh-resident device state: a leader ``OracleScorer(scan_mesh=
...)`` on rank 0 of gloo CPU ranks whose ``DeviceStateHolder`` keeps the
packed buffers resident and whose followers keep copies of them, through a
keyframe and churn refreshes with a ``BST_SCAN_SHARDED`` flip midway.

- Every refresh's plan equals a single-device port scorer's on the same
  world (exact equality).
- The holder's keyframe reasons and rows scattered equal the JAX package's
  mesh holder's (its ``OracleScorer(scan_mesh=...)`` on the conftest's
  8-device CPU mesh) on the same refresh sequence, the ``layout`` keyframe
  of the flip included.
- A mesh holder derives nothing on the device (the single-device scorer
  does), and reports ``mesh``.
- A churn refresh broadcasts its scattered rows and the batch's O(G) tail,
  never the whole batch: its bytes follow the churned rows, not the node
  count.

The ranks (meshes of S = 1, 2 and 4) are spawned once for the module by
``tests/torch_mesh_worker.py``; the JAX side runs here.
"""

import pytest

from batch_scheduler_tpu.cache import pg_cache as ref_cm
from batch_scheduler_tpu.core.oracle_scorer import OracleScorer as RefScorer
from batch_scheduler_tpu.framework.cluster import ClusterState as RefCluster
from batch_scheduler_tpu.parallel.mesh import make_mesh
from batch_scheduler_tpu.sim import scenarios as ref_scen

from torch_mesh_worker import scorer_rounds, spawn

SIZES = (1, 2, 4)
N, G, ROUNDS, FLIP = 24, 10, 6, 4
WIDE = (96, 10, 2, 99)  # a second world: more nodes, the same churn, no flip


def _ref_world(n, g):
    """``torch_mesh_worker._scorer_world`` with the JAX package's modules."""
    cluster = RefCluster()
    for i in range(n):
        cluster.add_node(ref_scen.make_sim_node(f"n{i:03d}", {"cpu": "16", "memory": "64Gi",
                                                              "pods": "110"}))
    cache = ref_cm.PGStatusCache()
    for j in range(g):
        pg = ref_scen.make_sim_group(f"gang-{j:03d}", 2 + j % 4, creation_ts=float(j % 3))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = ref_cm.PodGroupMatchStatus(pg)
        pgs.pod = ref_scen.make_member_pods(f"gang-{j:03d}", 1, {"cpu": "3"},
                                            priority=j % 2)[0]
        cache.set(pg.full_name(), pgs)
    pods = ref_scen.make_member_pods("churn", 60, {"cpu": "1", "memory": "1Gi"})
    return cluster, cache, pods


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    suite = [("state", "mesh_state", (N, G, ROUNDS, FLIP)),
             ("wide", "mesh_state", WIDE)]
    out = spawn(suite, SIZES, str(tmp_path_factory.mktemp("mesh_state_ranks")))
    for s, res in out.items():
        for name, r in res.items():
            assert not (isinstance(r, dict) and "error" in r), (s, name, r["error"])
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX mesh scorer's holder stats after each refresh, by S."""
    out = {}
    for s in SIZES:
        cluster, cache, pods = _ref_world(N, G)
        scorer = RefScorer(scan_mesh=make_mesh(s))
        _, out[s] = scorer_rounds(scorer, cluster, cache, pods, N, ROUNDS, FLIP)
    return out


@pytest.mark.parametrize("s", SIZES)
def test_mesh_scorer_plans_equal_single_device(ranks, s):
    for name in ("state", "wide"):
        res = ranks[s][name]
        assert res["plans"] == res["single_plans"], (name, s)


@pytest.mark.parametrize("s", SIZES)
def test_keyframes_and_rows_equal_the_reference_holder(ranks, reference, s):
    """Refresh by refresh, the keyframes by reason and the rows scattered
    of the port's mesh holder equal the JAX mesh holder's: the first
    keyframe, row scatters, and the ``layout`` keyframe of the flip."""
    got = [{k: st[k] for k in ("keyframes", "rows_scattered")} for st in ranks[s]["state"]["stats"]]
    want = [{k: st[k] for k in ("keyframes", "rows_scattered")} for st in reference[s]]
    assert got == want
    assert got[-1]["keyframes"].get("layout") == 1
    assert got[-1]["rows_scattered"] > 0


@pytest.mark.parametrize("s", SIZES)
def test_no_derive_on_a_mesh(ranks, s):
    res = ranks[s]["state"]
    assert all(st["derived_batches"] == 0 for st in res["stats"])
    assert res["single_stats"][-1]["derived_batches"] > 0
    assert res["holder"]["mesh"] is True and res["holder"]["meta_resident"] is False


@pytest.mark.parametrize("s", (2, 4))
def test_churn_broadcasts_rows_and_tail_only(ranks, s):
    """The first refresh keyframes (the three buffers once) and sends the
    batch's tail; a churn refresh sends its rows and the tail, never the
    whole batch, with the same bytes whatever the node count (WIDE has 4x
    the nodes and the same churn): O(churn), not O(N)."""
    sites = [{k: v for k, v in site.items() if k.startswith("broadcast/")}
             for site in ranks[s]["state"]["sites"]]
    assert "broadcast/keyframe" in sites[0] and "broadcast/batch" not in sites[0]
    for k in range(1, FLIP):
        assert set(sites[k]) == {"broadcast/header", "broadcast/rows", "broadcast/tail"}, sites[k]
    assert "broadcast/keyframe" in sites[FLIP]  # the layout flip
    wide = [{k: v for k, v in site.items() if k.startswith("broadcast/")}
            for site in ranks[s]["wide"]["sites"]]
    assert wide[1]["broadcast/rows"] == sites[1]["broadcast/rows"]
    assert wide[0]["broadcast/keyframe"] > sites[0]["broadcast/keyframe"]


def test_one_rank_mesh_broadcasts_nothing(ranks):
    assert all(not any(k.startswith("broadcast/") for k in site)
               for site in ranks[1]["state"]["sites"])
