"""The port's sidecar on a mesh: ``OracleServer(scan_mesh=...)`` on rank 0
of gloo CPU ranks (the others run ``parallel.follow``) and the CLI's
``serve`` under ``BST_COORDINATOR``.

- A mesh server answers a wire keyframe, row deltas and row requests with
  the bytes of the JAX package's ``serve_background()`` on the conftest's
  8-device CPU mesh, with ``BST_SCAN_TOPK`` unset (the node-sharded scan)
  and at 16 (its top-K form), every answer exactly equal.
- ``coalesce=True`` on a mesh runs without the coalescer and says so.
- Two ``python -m batch_scheduler_tpu_torch serve --device cpu`` processes
  under ``BST_COORDINATOR`` serve a client from rank 0, drain on SIGTERM,
  and both exit 0.
- The process group's backend follows the ranks on each host, read from
  the coordinator's store: NCCL when no host runs more ranks than it has
  cards, whatever the job's size, gloo otherwise, the same on every rank.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from batch_scheduler_tpu_torch.service import client as tclient
from batch_scheduler_tpu_torch.service import protocol as P

from torch_mesh_worker import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 2, 4)
TOPKS = (0, 16)


def _request(seed, n=40, g=12):
    """A seeded request over 5 lanes with mixed gang demands, one broadcast
    fit row (``tests/test_torch_service.py``'s shapes)."""
    rng = np.random.default_rng(seed)
    shapes = np.array([[64000, 256 * 2**20, 100 * 2**20, 110, 8],
                       [32000, 128 * 2**20, 50 * 2**20, 110, 0],
                       [16000, 64 * 2**20, 20 * 2**20, 64, 0]], np.int64)
    alloc = shapes[rng.integers(0, 3, size=n)]
    requested = (alloc * rng.random((n, 5)) * 0.6).astype(np.int64)
    demands = np.array([[2000, 4 * 2**20, 0, 1, 0], [4000, 8 * 2**20, 0, 1, 1],
                        [8000, 32 * 2**20, 2**20, 1, 2]], np.int64)
    group_req = demands[rng.choice(3, size=g)]
    remaining = rng.integers(1, 13, size=g)
    return P.ScheduleRequest(
        alloc=alloc.astype(np.int32), requested=requested.astype(np.int32),
        group_req=group_req.astype(np.int32), remaining=remaining.astype(np.int32),
        fit_mask=(rng.random(n) > 0.05)[None, :], group_valid=np.ones(g, bool),
        order=rng.permutation(g).astype(np.int32),
        min_member=remaining.astype(np.int32), scheduled=np.zeros(g, np.int32),
        matched=np.zeros(g, np.int32), ineligible=rng.random(g) < 0.1,
        creation_rank=rng.permutation(g).astype(np.int32),
    )


def _script(seed=5, rounds=4):
    """One connection's frames: a full request, a delta keyframe, then
    ``rounds`` churn deltas (a few node rows and one group row each), with
    row requests after each batch."""
    req = _request(seed)
    n, g = req.alloc.shape[0], req.group_req.shape[0]
    rng = np.random.default_rng(seed + 1)
    T = P.MsgType
    frames = [(T.SCHEDULE_REQ, P.pack_schedule_request(req)),
              (T.ROW_REQ, P.pack_row_request("capacity", 3, 1)),
              (T.DELTA_SCHEDULE_REQ, P.pack_delta_keyframe(1, req))]
    requested = req.requested.copy()
    group_req = req.group_req.copy()
    for k in range(rounds):
        nodes = np.sort(rng.choice(n, size=3, replace=False)).astype(np.int32)
        requested[nodes] = (requested[nodes] * 0.9).astype(np.int32)
        gi = np.array([int(rng.integers(0, g))], np.int32)
        group_req[gi] = group_req[(gi + 1) % g]
        rows = P.DeltaScheduleRequest(
            node_idx=nodes, node_rows=requested[nodes], group_idx=gi,
            group_rows=group_req[gi], remaining=req.remaining, fit_mask=req.fit_mask,
            group_valid=req.group_valid, order=req.order, min_member=req.min_member,
            scheduled=req.scheduled, matched=req.matched, ineligible=req.ineligible,
            creation_rank=req.creation_rank, n=n, g=g, r=5)
        frames.append((T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(1 + k, 2 + k, rows)))
        frames.append((T.ROW_REQ, P.pack_row_request("scores", k % g, 3 + k)))
    return frames


SCRIPT = _script()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    suite = [("serve", "mesh_serve", [(topk, SCRIPT) for topk in TOPKS])]
    out = spawn(suite, SIZES, str(tmp_path_factory.mktemp("mesh_serve_ranks")))
    for s, res in out.items():
        for name, r in res.items():
            assert not (isinstance(r, dict) and "error" in r), (s, name, r["error"])
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX package's answers to the script, by ``BST_SCAN_TOPK``."""
    from batch_scheduler_tpu.service import serve_background as jserve

    srv = jserve()
    out = {}
    try:
        for topk in TOPKS:
            if topk:
                os.environ["BST_SCAN_TOPK"] = str(topk)
            try:
                client = tclient.OracleClient(*srv.address, timeout=120)
                answers = []
                for msg_type, body in SCRIPT:
                    try:
                        answers.append(client._round_trip(msg_type, body))
                    except RuntimeError as e:
                        answers.append(("error", str(e)))
                client.close()
            finally:
                os.environ.pop("BST_SCAN_TOPK", None)
            out[topk] = answers
    finally:
        srv.shutdown()
        srv.server_close()
    return out


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("topk", TOPKS)
def test_mesh_server_answers_equal_the_reference(ranks, reference, s, topk):
    got = ranks[s]["serve"]["answers"][TOPKS.index(topk)]
    want = reference[topk]
    assert [t for t, _ in got] == [t for t, _ in want]
    assert got == want
    assert not any(t in ("error", P.MsgType.DELTA_RESYNC) for t, _ in got)


@pytest.mark.parametrize("s", (2, 4))
def test_mesh_server_broadcasts_rows_not_batches_for_deltas(ranks, s):
    """The full request's batches broadcast whole (one a script), every
    delta batch its tail, the mirror its keyframe once a script and its
    rows a churn round; drain or close stopped the followers."""
    res = ranks[s]["serve"]
    c = res["counts"]
    assert c["broadcast/batch"]["calls"] == len(TOPKS)
    assert c["broadcast/keyframe"]["calls"] == len(TOPKS)
    assert c["broadcast/tail"]["calls"] == len(TOPKS) * 5
    assert c["broadcast/rows"]["calls"] == len(TOPKS) * 4
    assert c["broadcast/rows"]["max_bytes"] < c["broadcast/keyframe"]["max_bytes"]
    assert res["stopped"]


def test_coalesce_on_a_mesh_is_skipped_with_a_note(ranks):
    res = ranks[2]["serve"]
    assert res["coalescer"] is None
    assert "coalescer skipped: mesh server" in res["note"]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_serve_under_coordinator_serves_and_drains(tmp_path):
    """Two ``serve`` processes under ``BST_COORDINATOR``: rank 0 listens and
    answers a client like the single-process sidecar, rank 1 follows; a
    SIGTERM to rank 0 drains it, which stops rank 1, and both exit 0."""
    from batch_scheduler_tpu_torch.service import serve_background

    port = _free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, BST_COORDINATOR=f"127.0.0.1:{port}", BST_NUM_PROCESSES="2",
                       BST_PROCESS_ID=str(rank), OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "batch_scheduler_tpu_torch", "serve", "--port", "0",
                 "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        lines = []
        deadline = time.monotonic() + 120
        addr = None
        while addr is None and time.monotonic() < deadline:
            line = procs[0].stdout.readline()
            if not line:
                break
            lines.append(line)
            if "oracle sidecar listening on" in line:
                host, p = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
                addr = (host, int(p))
        assert addr is not None, "".join(lines)
        assert any("distributed initialized: process 0/2, backend gloo" in x for x in lines), lines
        req = _request(9)
        client = tclient.OracleClient(*addr, timeout=120)
        got = client.schedule(req)
        client.close()
        single = serve_background(device="cpu")
        try:
            c = tclient.OracleClient(*single.address, timeout=120)
            want = c.schedule(req)
            c.close()
        finally:
            single.shutdown()
            single.server_close()
        for key in ("placed", "gang_feasible", "best", "assignment_nodes", "assignment_counts"):
            np.testing.assert_array_equal(np.asarray(getattr(got, key)),
                                          np.asarray(getattr(want, key)), err_msg=key)
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
        assert "drain complete" in outs[0]
        assert "rank 1 following rank 0" in outs[1] and "rank 1 stopped after" in outs[1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("hosts,cards,expected", [
    (["a", "b", "c", "d"], {"a": 1, "b": 1, "c": 1, "d": 1}, "nccl"),
    (["a"] * 8 + ["b"] * 8, {"a": 8, "b": 8}, "nccl"),
    (["a", "a"], {"a": 1}, "gloo"),
    (["a", "a", "b"], {"a": 1, "b": 1}, "gloo"),
    (["a", "b"], {"a": 0, "b": 0}, "gloo"),
], ids=["4-hosts-1-card", "2-hosts-8-cards", "2-ranks-1-card", "one-host-shared", "cpu"])
def test_backend_follows_the_ranks_on_each_host(hosts, cards, expected):
    """``topology_backend`` on a store that every rank shares, each rank
    on its faked host: every rank chooses ``expected``."""
    import datetime

    import torch.distributed as dist

    from batch_scheduler_tpu_torch.parallel.distributed import topology_backend

    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=30))
    got = [None] * len(hosts)

    def rank(r):
        got[r] = topology_backend(store, len(hosts), r, cards[hosts[r]], host=hosts[r])

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == [expected] * len(hosts)
