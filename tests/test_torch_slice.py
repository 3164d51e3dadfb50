"""The whole slice: a scaled-down north star (bench.py's deployment cut to
200 nodes and 40 gangs, R=5) through both packages' OracleScorer gives the
same answers by gang and node name; plus the port's rules — it imports
neither JAX nor the JAX package, its default device is CUDA and raises
without one, and its kernel agrees with the plain scan on the card."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "batch_scheduler_tpu_torch"
PACKAGES = ("batch_scheduler_tpu", "batch_scheduler_tpu_torch")
GPU = "nvidia.com/gpu"


class _Cluster:
    def __init__(self, nodes, requested):
        self.nodes, self.requested = nodes, requested

    def list_nodes(self):
        return list(self.nodes)

    def node_requested(self, name):
        return dict(self.requested.get(name, {}))


def _north_star_small(name):
    """200 nodes (64 cpu, 256Gi, 110 pods, 8 GPUs; some partly used, two
    labelled shapes) and 40 gangs of 1-64 members: the tail is infeasible."""
    scen = importlib.import_module(f"{name}.sim.scenarios")
    cache_mod = importlib.import_module(f"{name}.cache.pg_cache")
    phases = importlib.import_module(f"{name}.api.types").PodGroupPhase
    rng = np.random.default_rng(2024)
    nodes = [
        scen.make_sim_node(
            f"n{i:04d}",
            {"cpu": "64", "memory": "256Gi", "pods": "110", GPU: "8"},
        )
        for i in range(200)
    ]
    requested = {
        f"n{i:04d}": {"cpu": int(rng.integers(0, 60)) * 1000, "pods": int(rng.integers(0, 20)),
                      GPU: int(rng.integers(0, 8))}
        for i in range(0, 200, 3)
    }
    cache = cache_mod.PGStatusCache()
    sizes = rng.integers(1, 65, size=40)
    for g, size in enumerate(sizes):
        pg = scen.make_sim_group(f"gang-{g:03d}", int(size), creation_ts=float(g % 7))
        pg.spec.min_resources = {"cpu": 4000 * (1 + g % 3), "memory": 8 * 1024**3, GPU: 1 + g % 2}
        pg.status.phase = phases.PENDING
        pgs = cache_mod.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang-{g:03d}", 1, {"cpu": "4"}, priority=g % 2)[0]
        cache.set(pg.full_name(), pgs)
    return _Cluster(nodes, requested), cache, [n.metadata.name for n in nodes]


def _answers(name):
    cluster, cache, node_names = _north_star_small(name)
    scorer_mod = importlib.import_module(f"{name}.core.oracle_scorer")
    kwargs = {"device": "cpu"} if name.endswith("_torch") else {}
    scorer = scorer_mod.OracleScorer(**kwargs)
    scorer.ensure_fresh(cluster, cache)
    gangs = sorted(cache.snapshot())
    probe = node_names[::17]
    return {
        "max_group": scorer.max_group(),
        "gangs": {
            g: (
                scorer.placed(g),
                scorer.gang_feasible(g),
                scorer.assignment(g),
                scorer.feasible_node_count(g),
                [scorer.node_capacity(g, n) for n in probe],
                [scorer.node_score(g, n) for n in probe],
            )
            for g in gangs
        },
    }


def test_north_star_small_matches_reference():
    ref, port = (_answers(name) for name in PACKAGES)
    assert port == ref
    placed = [g for g, a in port["gangs"].items() if a[0]]
    assert 0 < len(placed) < len(port["gangs"])  # the tail does not fit


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_neither_jax_nor_reference(path):
    bad = [
        name for name in _imports(path)
        if name.split(".")[0] in ("jax", "jaxlib", "batch_scheduler_tpu")
    ]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_guard_walks_the_refresh_modules():
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"framework/cluster.py", "ops/events.py", "ops/device_state.py",
            "ops/snapshot.py", "core/oracle_scorer.py"} <= walked


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from batch_scheduler_tpu_torch.core import OracleScorer, ScheduleOperation
    from batch_scheduler_tpu_torch.cache import PGStatusCache
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OracleScorer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScheduleOperation(PGStatusCache(), _Cluster([], {}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_batch_host(*_tiny_batch())
    # asking for the CPU works
    host, _ = execute_batch_host(*_tiny_batch(), device="cpu")
    assert host["placed"].tolist()[:2] == [True, False]


def _tiny_batch():
    from batch_scheduler_tpu_torch.ops.bucketing import pad_oracle_batch

    g = 2
    return pad_oracle_batch(
        alloc=np.array([[8000, 110]], np.int32), requested=np.array([[900, 1]], np.int32),
        group_req=np.array([[1000, 1]] * g, np.int32), remaining=np.array([5, 5], np.int32),
        fit_mask=np.ones((1, 1), bool), group_valid=np.ones(g, bool),
        order=np.arange(g, dtype=np.int32), min_member=np.array([5, 5], np.int32),
        scheduled=np.zeros(g, np.int32), matched=np.zeros(g, np.int32),
        ineligible=np.zeros(g, bool), creation_rank=np.arange(g, dtype=np.int32),
    )


def _card_scan_cases(rng):
    """(name, (left, req, remaining, mask, order) as numpy, want C == 1 or
    the device's largest cluster, want leftover) for the card test."""
    def rand(n, g, rows):
        return (rng.integers(0, 2000, size=(n, 5)).astype(np.int32),
                rng.integers(0, 40, size=(g, 5)).astype(np.int32),
                rng.integers(0, 300, size=g).astype(np.int32),
                rng.random((rows, n)) < 0.8, rng.permutation(g).astype(np.int32))

    def one_bin(n, g, rows):
        # every node holds 4 members: one key, so every warp takes the
        # aggregated histogram path and a gang of 3,001 fills its threshold
        # bin across several blocks in node order (the cross-block prefix)
        # and splits a node; gangs 1 and 2 need nothing, gang 3 can never
        # fit, and the tail runs out of nodes
        left = np.tile(np.array([[4000, 16, 8, 4, 10**6]], np.int32), (n, 1))
        req = np.tile(np.array([[1000, 4, 2, 1, 0]], np.int32), (g, 1))
        rem = np.full(g, 3001, np.int32)
        rem[1] = rem[2] = 0
        rem[3] = 10**6
        mask = np.ones((rows, n), bool)
        if rows > 1:
            mask[4, ::3] = False
        return left, req, rem, mask, np.arange(g, dtype=np.int32)

    return [
        ("C=1 broadcast", rand(8, 8, 1), "one", "shared"),
        ("C=1 per-group", rand(300, 64, 64), "one", "shared"),
        ("broadcast", rand(5000, 128, 1), "max", "shared"),
        ("per-group", rand(10000, 32, 32), "max", "shared"),
        ("one bin broadcast", one_bin(8192, 16, 1), "max", "shared"),
        ("one bin per-group", one_bin(8192, 16, 16), "max", "shared"),
        ("global scratch broadcast", rand(262144, 8, 1), "max", "global"),
        ("global scratch per-group", rand(262144, 8, 8), "max", "global"),
        ("global scratch one bin", one_bin(262144, 6, 6), "max", "global"),
    ]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        CLUSTER_SIZES, assign_gangs_cuda, assign_gangs_plain, scan_plan)

    rng = np.random.default_rng(3)
    largest = scan_plan(8192, 5, torch.cuda.current_device()).cluster_blocks
    assert largest in CLUSTER_SIZES
    for name, arrays, want_c, want_leftover in _card_scan_cases(rng):
        args = [torch.from_numpy(a).cuda() for a in arrays]
        plan = scan_plan(args[0].shape[0], 5, torch.cuda.current_device())
        assert plan.cluster_blocks == (1 if want_c == "one" else largest), (name, plan)
        assert plan.leftover == want_leftover, (name, plan)
        got = assign_gangs_cuda(*args)
        want = assign_gangs_plain(*args)
        torch.cuda.synchronize()
        for field, a, b in zip(("alloc", "placed", "left_after"), got, want):
            assert torch.equal(a, b), (name, field)
        if name.startswith("one bin"):
            placed = want[1].tolist()
            assert placed[1] and placed[2] and not placed[3], name
            # gang 0 (scanned first) takes nodes 0..750, the last one split
            assert want[0][0, :751].tolist() == [4] * 750 + [1], name
