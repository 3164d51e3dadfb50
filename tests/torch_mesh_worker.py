"""One rank of the port's gloo-rank tests (tests/test_torch_sharded_scan.py,
tests/test_torch_parallel.py): the CPU counterpart of the reference's
tests/distributed_worker.py.

Run as ``python tests/torch_mesh_worker.py SUITE OUT`` with
``BST_COORDINATOR``, ``BST_NUM_PROCESSES`` and ``BST_PROCESS_ID`` set. It
joins the group through ``parallel.init_distributed`` (gloo on the CPU),
runs every case of the pickled SUITE (a list of ``(name, kind, payload)``)
on its mesh, and rank 0 pickles ``{name: result}`` to OUT. The port only:
this process never imports jax or the JAX package.
"""

import os
import pickle
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from batch_scheduler_tpu_torch.ops import oracle  # noqa: E402
from batch_scheduler_tpu_torch.parallel import (  # noqa: E402
    follow,
    global_mesh,
    init_distributed,
    make_mesh,
    sharded_collective_counts,
    sharded_scan_collective_counts,
    sharded_schedule_batch,
    stop_followers,
)

HOST_KEYS = ("placed", "gang_feasible", "progress", "best", "best_exists",
             "assignment_nodes", "assignment_counts")


def _np(x):
    return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_scan(mesh, payload):
    left, req, rem, mask, order, wave = payload
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (left, req, rem, mask, order)]
    t[3] = t[3].to(torch.bool)
    out = oracle.assign_gangs_sharded(*t, mesh=mesh, wave=wave, with_stats=True)
    if out is None:  # a rank other than 0: its share is done
        return None
    alloc, placed, left_after, (conflicts, megas) = out
    return tuple(_np(x) for x in (alloc, placed, left_after, conflicts, megas))


def run_topk_scan(mesh, payload):
    """``assign_gangs_topk_sharded`` on this mesh: rank 0's five outputs and
    the per-wave stats."""
    left, req, rem, mask, order, wave, k = payload
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (left, req, rem, mask, order)]
    t[3] = t[3].to(torch.bool)
    out = oracle.assign_gangs_topk_sharded(*t, mesh=mesh, wave=wave, k=k, with_stats=True)
    if out is None:
        return None
    alloc, placed, left_after, stats = out
    return tuple(_np(x) for x in (alloc, placed, left_after, *stats))


def run_batch(mesh, payload):
    args, replicated, sharded, wave, *topk = payload
    out = sharded_schedule_batch(mesh, args, replicated_scan=replicated,
                                 sharded_scan=sharded, scan_wave=wave,
                                 scan_topk=topk[0] if topk else 0)
    return None if out is None else {k: _np(v) for k, v in out.items()}


def run_shares(mesh, payload):
    """Both rungs of ``sharded_schedule_batch`` on every rank: the ranks
    (summed over the mesh) whose output was not rank 0's dict or, on the
    other ranks, None."""
    bad = 0
    for replicated in (True, False):
        out = sharded_schedule_batch(mesh, payload, replicated_scan=replicated,
                                     sharded_scan=not replicated)
        bad += int((out is None) != (mesh.rank != 0))
    total = torch.tensor([bad])
    torch.distributed.all_reduce(total)
    return int(total.item())


def run_budget(mesh, payload):
    return [sharded_scan_collective_counts(mesh, args, wave=w, topk=topk[0] if topk else 0)
            for args, w, *topk in payload]


def run_pinned(mesh, payload):
    """A ``forced_scan_rung`` pin on a mesh batch with ``BST_SCAN_TOPK``
    set: the telemetry of the pinned batch (its rung runs replicated) and of
    the unpinned one (sharded top-K)."""
    args, progress = payload

    def lead(m):
        os.environ["BST_SCAN_TOPK"] = "16"
        try:
            with oracle.forced_scan_rung(8, 16):
                pinned, _ = oracle.execute_batch_host(args, progress, scan_mesh=m)
            free, _ = oracle.execute_batch_host(args, progress, scan_mesh=m)
        finally:
            os.environ.pop("BST_SCAN_TOPK")
        single, _ = oracle.execute_batch_host(args, progress, device="cpu")
        return {"pinned": pinned, "free": free, "single": single}

    return _led(mesh, lead)


def run_collectives(mesh, payload):
    return sharded_collective_counts(mesh, payload, replicated_scan=True)


def run_mesh_info(mesh, payload):
    m = global_mesh(device="cpu")
    return {"size": m.size, "rank": m.rank, "shape": m.shape, "axis_names": m.axis_names,
            "node_blocks": [m.node_block(n) for n in payload],
            "grid_blocks": [(m.group_block(g, False), m.node_block(n, False))
                            for g, n in [(8, 16), (5, 37)]]}


def _led(mesh, lead):
    """One leader/follower session on a fresh mesh: rank 0 runs ``lead``
    and stops the followers; the others follow. Returns rank 0's result,
    with the batches each follower ran."""
    session = make_mesh(device="cpu")
    if session.rank != 0:
        return {"followed": follow(session)}
    try:
        return lead(session)
    finally:
        stop_followers(session)


def _policy_batch():
    """A small policy batch (the port's packer with every term on):
    ``(batch_args, progress_args, policy payload)``."""
    from batch_scheduler_tpu_torch.ops.snapshot import DeltaSnapshotPacker, GroupDemand
    from batch_scheduler_tpu_torch.policy import engine
    from batch_scheduler_tpu_torch.policy.terms import label_hash
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    nodes = [make_sim_node(f"n{i}", {"cpu": "8", "pods": "20"},
                           labels={"zone": f"z{i % 3}", "team": "blue",
                                   **({"pool": "gpu"} if i % 2 else {})}) for i in range(6)]
    groups = [
        GroupDemand(full_name="default/g0", min_member=3, member_request={"cpu": 1000},
                    affinity_hash=label_hash("pool", "gpu"), spread=True,
                    placed_nodes={"n0": 1, "n1": 2}, priority=7),
        GroupDemand(full_name="default/g1", min_member=2, member_request={"cpu": 2000},
                    anti_hash=label_hash("team", "blue")),
        GroupDemand(full_name="default/g2", min_member=4, member_request={"cpu": 500},
                    spread=True, placed_nodes={"n5": 3}),
    ]
    config = engine.PolicyConfig(terms=("affinity", "anti-affinity", "spread"),
                                 spread_node_key="zone")
    snap = DeltaSnapshotPacker(policy_engine=engine.PolicyEngine(config)).pack(nodes, {}, groups)
    return snap.device_args(), snap.progress_args(), snap.policy_payload()


def run_dispatch(mesh, payload):
    args, progress = payload
    policy = _policy_batch()

    def lead(m):
        out = {}
        single, _ = oracle.execute_batch_host(args, progress, device="cpu")
        out["single"] = {k: single[k] for k in HOST_KEYS}
        os.environ.pop("BST_SCAN_SHARDED", None)
        host, _ = oracle.execute_batch_host(args, progress, scan_mesh=m)
        out["default"] = ({k: host[k] for k in HOST_KEYS}, host["telemetry"])
        os.environ["BST_SCAN_SHARDED"] = "0"
        try:
            host, _ = oracle.execute_batch_host(args, progress, scan_mesh=m)
        finally:
            os.environ.pop("BST_SCAN_SHARDED")
        out["knob_off"] = ({k: host[k] for k in HOST_KEYS}, host["telemetry"])
        with oracle.forced_scan_rung(0):
            host, _ = oracle.execute_batch_host(args, progress, scan_mesh=m)
        out["pinned"] = ({k: host[k] for k in HOST_KEYS}, host["telemetry"])
        host, _ = oracle.execute_batch_host(policy[0], policy[1], scan_mesh=m,
                                            policy=policy[2])
        single, _ = oracle.execute_batch_host(policy[0], policy[1], device="cpu",
                                              policy=policy[2])
        out["policy"] = ({k: host[k] for k in HOST_KEYS}, host["telemetry"],
                         {k: single[k] for k in HOST_KEYS})
        from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

        out["series"] = {
            "shard_count": DEFAULT_REGISTRY.gauge("bst_scan_shard_count").values(),
            "sharded_enabled": DEFAULT_REGISTRY.gauge("bst_scan_sharded_enabled").values(),
        }
        out["counts"] = m.collective_counts()
        return out

    return _led(mesh, lead)


def _scorer_world(n, g):
    from batch_scheduler_tpu_torch.cache import pg_cache as cm
    from batch_scheduler_tpu_torch.framework.cluster import ClusterState
    from batch_scheduler_tpu_torch.sim import scenarios as scen

    cluster = ClusterState()
    for i in range(n):
        cluster.add_node(scen.make_sim_node(f"n{i:03d}", {"cpu": "16", "memory": "64Gi",
                                                          "pods": "110"}))
    cache = cm.PGStatusCache()
    for j in range(g):
        pg = scen.make_sim_group(f"gang-{j:03d}", 2 + j % 4, creation_ts=float(j % 3))
        pg.spec.min_resources = {"cpu": 3000 * (1 + j % 2), "memory": 2**30}
        pgs = cm.PodGroupMatchStatus(pg)
        pgs.pod = scen.make_member_pods(f"gang-{j:03d}", 1, {"cpu": "3"}, priority=j % 2)[0]
        cache.set(pg.full_name(), pgs)
    pods = scen.make_member_pods("churn", 60, {"cpu": "1", "memory": "1Gi"})
    return cluster, cache, pods


def run_scorer(mesh, payload):
    n, g, rounds = payload

    def lead(m):
        from batch_scheduler_tpu_torch.core.oracle_scorer import OracleScorer

        cluster, cache, pods = _scorer_world(n, g)
        leader = OracleScorer(scan_mesh=m)
        single = OracleScorer(device="cpu")
        plans, telemetry = [], []
        for k in range(rounds + 1):
            if k:
                for p in pods[3 * k:3 * k + 3]:
                    cluster.assume(p, f"n{(7 * k) % n:03d}")
            leader.refresh(cluster, cache)
            single.refresh(cluster, cache)
            names = sorted(leader._state.snapshot.group_names)
            plans.append(([(x, leader.placed(x), leader.assignment(x)) for x in names],
                          [(x, single.placed(x), single.assignment(x)) for x in names]))
            telemetry.append(leader.last_telemetry)
        leader.close()
        return {"plans": plans, "telemetry": telemetry, "stopped": m.stopped,
                "batches": leader.batches_run}

    return _led(mesh, lead)


def scorer_rounds(scorer, cluster, cache, pods, n, rounds, flip_at, on_round=None):
    """The mesh-state drive, for either package's scorer: a first refresh,
    then ``rounds`` churn refreshes of 3 pod assumes each, with
    ``BST_SCAN_SHARDED=0`` set from round ``flip_at`` on (a layout flip).
    Returns each refresh's plan and holder stats; ``on_round(k)`` runs after
    each refresh."""
    plans, stats = [], []
    try:
        for k in range(rounds + 1):
            if k:
                for p in pods[3 * k:3 * k + 3]:
                    cluster.assume(p, f"n{(7 * k) % n:03d}")
            if k == flip_at:
                os.environ["BST_SCAN_SHARDED"] = "0"
            scorer.refresh(cluster, cache)
            names = sorted(scorer._state.snapshot.group_names)
            plans.append([(x, scorer.placed(x), scorer.assignment(x)) for x in names])
            st = scorer._device_state.stats()
            stats.append({key: st[key] for key in ("keyframes", "rows_scattered",
                                                   "deltas_applied", "derived_batches")})
            if on_round is not None:
                on_round(k)
    finally:
        os.environ.pop("BST_SCAN_SHARDED", None)
    return plans, stats


def run_mesh_state(mesh, payload):
    """A leader scorer on a fresh mesh through ``scorer_rounds``, with a
    single-device scorer on the same world: the plans, the holder stats
    (and the single scorer's), the bytes each refresh broadcast by site,
    and the followers' batch count."""
    n, g, rounds, flip_at = payload

    def lead(m):
        from batch_scheduler_tpu_torch.core.oracle_scorer import OracleScorer

        cluster, cache, pods = _scorer_world(n, g)
        single_world = _scorer_world(n, g)
        leader = OracleScorer(scan_mesh=m)
        single = OracleScorer(device="cpu")
        sites = []
        last = [m.collective_counts()]

        def on_round(k):
            now = m.collective_counts()
            sites.append({key: v["bytes"] - last[0].get(key, {"bytes": 0})["bytes"]
                          for key, v in now.items()
                          if v["bytes"] != last[0].get(key, {"bytes": 0})["bytes"]})
            last[0] = now

        plans, stats = scorer_rounds(leader, cluster, cache, pods, n, rounds, flip_at, on_round)
        s_plans, s_stats = scorer_rounds(single, *single_world, n, rounds, flip_at)
        leader.close()
        return {"plans": plans, "single_plans": s_plans, "stats": stats,
                "single_stats": s_stats, "sites": sites,
                "holder": leader._device_state.stats()}

    return _led(mesh, lead)


def run_mesh_serve(mesh, payload):
    """A mesh ``serve_background`` on rank 0 (the followers follow): the raw
    answers to each script of wire frames, each under its ``BST_SCAN_TOPK``
    (``(topk, frames)`` pairs), with the rank's kernel-path telemetry, and
    what a ``coalesce=True`` mesh server does."""
    import contextlib
    import io

    from batch_scheduler_tpu_torch.service import client as tclient
    from batch_scheduler_tpu_torch.service import server as tserver

    def lead(m):
        answers = []
        srv = tserver.serve_background(device="cpu", scan_mesh=m)
        try:
            for topk, frames in payload:
                if topk:
                    os.environ["BST_SCAN_TOPK"] = str(topk)
                try:
                    client = tclient.OracleClient(*srv.address, timeout=120)
                    out = []
                    for msg_type, body in frames:
                        try:
                            out.append(client._round_trip(msg_type, body))
                        except RuntimeError as e:
                            out.append(("error", str(e)))
                    client.close()
                finally:
                    os.environ.pop("BST_SCAN_TOPK", None)
                answers.append(out)
        finally:
            srv.shutdown()
            srv.server_close()
        stopped = m.stopped
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            coal = tserver.OracleServer(device="cpu", coalesce=True, scan_mesh=m)
        coal.server_close()
        return {"answers": answers, "stopped": stopped, "coalescer": coal.coalescer,
                "note": err.getvalue(), "counts": m.collective_counts()}

    return _led(mesh, lead)


RUNNERS = {
    "scan": run_scan,
    "topk_scan": run_topk_scan,
    "batch": run_batch,
    "budget": run_budget,
    "pinned": run_pinned,
    "shares": run_shares,
    "collectives": run_collectives,
    "mesh_info": run_mesh_info,
    "dispatch": run_dispatch,
    "scorer": run_scorer,
    "mesh_state": run_mesh_state,
    "mesh_serve": run_mesh_serve,
}


def spawn(suite, sizes, directory, timeout=240.0):
    """Run ``suite`` on a mesh of each size in ``sizes`` (every rank of
    every mesh started together, one process a rank, one thread each) and
    return ``{size: rank 0's results}``. Kills every rank past ``timeout``
    and fails with the ranks' output if any exits nonzero."""
    import socket
    import subprocess
    import time

    suite_path = os.path.join(directory, "suite.pkl")
    with open(suite_path, "wb") as f:
        pickle.dump(suite, f)
    procs, outs = [], {}
    for s in sizes:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        outs[s] = os.path.join(directory, f"out_{s}.pkl")
        for rank in range(s):
            env = dict(os.environ, BST_COORDINATOR=f"127.0.0.1:{port}",
                       BST_NUM_PROCESSES=str(s), BST_PROCESS_ID=str(rank),
                       OMP_NUM_THREADS="1")
            procs.append((s, rank, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite_path, outs[s]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for s, rank, p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append((s, rank, p.returncode, out))
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(s, rank, rc, out[-2000:]) for s, rank, rc, out in logs if rc != 0]
    assert not bad and len(logs) == len(procs), bad or "ranks timed out"
    results = {}
    for s, path in outs.items():
        with open(path, "rb") as f:
            results[s] = pickle.load(f)
    return results


def main() -> None:
    suite_path, out_path = sys.argv[1], sys.argv[2]
    with open(suite_path, "rb") as f:
        suite = pickle.load(f)
    assert init_distributed(device="cpu"), "BST_COORDINATOR not picked up"
    mesh = make_mesh(device="cpu")
    results = {}
    for name, kind, payload in suite:
        try:
            results[name] = RUNNERS[kind](mesh, payload)
        except Exception:  # noqa: BLE001 — reported to the test, then fatal
            results[name] = {"error": traceback.format_exc()}
            break
    if mesh.rank == 0:
        with open(out_path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(out_path + ".tmp", out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
