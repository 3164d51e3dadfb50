"""The rank mesh and the sharded oracle batch.

The port of ``batch_scheduler_tpu/parallel/mesh.py``. The reference's mesh
is a ``jax.sharding.Mesh`` that one program spans, with XLA inserting the
collectives. PyTorch runs one process per rank, so here:

- ``ShardMesh`` (``make_mesh``) holds the ``torch.distributed`` process
  group's size S, this rank, this rank's explicit device and the
  reference's ``("groups", "nodes")`` grid (``_factor_devices``). It issues
  every collective of a mesh batch itself (an all-reduce, a broadcast or
  a gather to rank 0) and counts each one by op and call site with its bytes: the port's
  counterpart of the reference's HLO readers, which it does not have
  (there is no compiled module to read).
- Every rank holds the whole packed batch. ``ShardMesh.node_block`` /
  ``group_block`` and ``shard_snapshot_args`` give each rank's block: its
  contiguous node block, zero-padded to a multiple of S (the node-sharded
  scan's layout, ``flat_nodes``), or its ``(groups, nodes)`` block of the
  grid for the scoring head.
- ``sharded_schedule_batch`` is one batch called by every rank (SPMD), as
  the reference's ``tests/distributed_worker.py`` calls it. Rank 0 gets the
  whole output; a rank's share ends with its last collective.
- ``follow`` is the loop of the ranks other than 0 when rank 0 serves
  (``core.OracleScorer(scan_mesh=mesh)`` -> ``ops.oracle.dispatch_batch``):
  before each mesh batch rank 0 broadcasts a small header (shapes, rung,
  wave width, stop) and the packed arrays (``lead_batch``), and each
  follower runs its share of that batch, until a stop header
  (``stop_followers``).

A rank's tensors live on its ``device``. Ranks that share one card (S
processes on ``cuda:0``) join a ``gloo`` group, whose collectives take CUDA
tensors through host copies; one card a rank joins ``nccl``.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import oracle as okern
from ..ops.convert import args_from_numpy, resolve_device

__all__ = [
    "COLLECTIVES",
    "ShardMesh",
    "follow",
    "lead_batch",
    "make_mesh",
    "shard_snapshot_args",
    "sharded_collective_counts",
    "sharded_scan_collective_counts",
    "sharded_schedule_batch",
    "stop_followers",
]

# the collective ops a mesh batch issues
COLLECTIVES = ("all_reduce", "broadcast", "gather")

# the follower header: [batch?, G, N, R, mask rows, sharded, wave, topk, top_k]
_HEADER_LEN = 9
_NEXT_SLICE = ("the node-sharded top-K rung (assign_gangs_topk_sharded) is not in the port "
               "yet: it comes with the next slice (ROADMAP item 11b)")


def _factor_devices(n: int) -> tuple:
    """Split n ranks into a (groups, nodes) grid, nodes-major: node-axis
    parallelism carries the heavy lanes (N is the big dimension)."""
    g = int(math.isqrt(n))
    while g > 1 and n % g != 0:
        g -= 1
    return (g, n // g)


def _block(length: int, parts: int, index: int) -> tuple:
    """(lo, hi, size) of block ``index`` of ``length`` split into ``parts``
    blocks of ``size = ceil(length / parts)``; ``hi - lo`` real entries,
    the rest of the block is padding."""
    size = -(-length // parts)
    lo = min(index * size, length)
    return lo, min(lo + size, length), size


class ShardMesh:
    """S ranks of a process group as the reference's ``("groups",
    "nodes")`` mesh, seen from one rank. Collectives go through
    ``all_reduce`` / ``broadcast`` / ``gather``, which count them; a failed
    collective raises (nothing retries or falls back)."""

    axis_names = ("groups", "nodes")

    def __init__(self, device: torch.device):
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = device
        self.shape = dict(zip(self.axis_names, _factor_devices(self.size)))
        # held for the whole of a leader's batch: every rank must issue the
        # same collectives in the same order, whatever thread refreshes
        self.lock = threading.RLock()
        self.stopped = False  # guarded-by: lock
        self._count_lock = threading.Lock()
        self._calls: dict = {}  # guarded-by: _count_lock
        self._records: Optional[list] = None  # guarded-by: _count_lock

    def __repr__(self) -> str:
        return (f"ShardMesh(size={self.size}, rank={self.rank}, shape={self.shape}, "
                f"device={self.device}, backend={dist.get_backend()})")

    # -- blocks ---------------------------------------------------------------

    def node_block(self, n: int, flat: bool = True, rank: Optional[int] = None) -> tuple:
        """(lo, hi, size) of this rank's (or ``rank``'s) contiguous node
        block: over all S ranks (``flat``, the sharded scan's layout) or
        over the grid's ``nodes`` axis (the scoring head's)."""
        rank = self.rank if rank is None else rank
        if flat:
            return _block(n, self.size, rank)
        return _block(n, self.shape["nodes"], rank % self.shape["nodes"])

    def group_block(self, g: int, flat: bool = True, rank: Optional[int] = None) -> tuple:
        """(lo, hi, size) of this rank's (or ``rank``'s) group block: every
        group when ``flat``, else its block of the grid's ``groups`` axis."""
        rank = self.rank if rank is None else rank
        if flat:
            return 0, g, g
        return _block(g, self.shape["groups"], rank // self.shape["nodes"])

    # -- collectives ----------------------------------------------------------

    def _note(self, op: str, site: str, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        with self._count_lock:
            entry = self._calls.setdefault((op, site), [0, 0, 0])
            entry[0] += 1
            entry[1] += nbytes
            entry[2] = max(entry[2], nbytes)
            if self._records is not None:
                self._records.append((op, site, nbytes))

    def all_reduce(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (counted under ``site``)."""
        self._note("all_reduce", site, t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def broadcast(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """Rank 0's ``t`` into every rank's ``t`` (counted under ``site``)."""
        self._note("broadcast", site, t)
        dist.broadcast(t, src=0)
        return t

    def gather(self, t: torch.Tensor, site: str) -> Optional[list]:
        """Every rank's ``t`` (one shape on all ranks) on rank 0, in rank
        order; None on the other ranks (counted under ``site`` with the
        bytes this rank sends)."""
        self._note("gather", site, t)
        if self.rank != 0:
            dist.gather(t, None, dst=0)
            return None
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.gather(t, parts, dst=0)
        return parts

    def collective_counts(self) -> dict:
        """Every collective this rank issued, by ``"op/site"``: calls,
        total bytes and the largest call's bytes."""
        with self._count_lock:
            return {f"{op}/{site}": {"calls": c, "bytes": b, "max_bytes": m}
                    for (op, site), (c, b, m) in sorted(self._calls.items())}

    @contextmanager
    def recording(self):
        """Collect ``(op, site, bytes)`` of every collective issued inside
        the block (a list, filled as they happen)."""
        records: list = []
        with self._count_lock:
            prev, self._records = self._records, records
        try:
            yield records
        finally:
            with self._count_lock:
                self._records = prev


def make_mesh(device="cuda") -> ShardMesh:
    """The mesh over the default process group (``parallel.init_distributed``
    or the caller has initialized it) with this rank's tensors on
    ``device``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed (or "
                           "torch.distributed.init_process_group) first")
    return ShardMesh(resolve_device(device))


def shard_snapshot_args(mesh: ShardMesh, args: tuple, flat_nodes: bool = False) -> tuple:
    """This rank's block of ``ClusterSnapshot.device_args()`` as tensors on
    the mesh's device: the node-major arrays' rows of its node block and
    the group-major arrays' rows of its group block, each zero-padded to
    the block size (a padded node has no leftover and a zero mask, so it
    holds no capacity and never wins a member); the fit mask's block of
    both axes (a broadcast ``[1, N]`` mask keeps its one row); the scan
    order whole. ``flat_nodes`` is the node-sharded scan's layout (node
    blocks over all S ranks, every group on every rank), else the scoring
    head's ``(groups, nodes)`` grid."""
    alloc, requested, group_req, remaining, fit_mask, group_valid, order = args_from_numpy(
        args, mesh.device)
    nlo, nhi, nb = mesh.node_block(alloc.shape[0], flat_nodes)
    glo, ghi, gb = mesh.group_block(group_req.shape[0], flat_nodes)

    def rows(t, lo, hi, size):
        out = t.new_zeros((size,) + tuple(t.shape[1:]))
        out[:hi - lo] = t[lo:hi]
        return out

    if fit_mask.shape[0] == 1:
        mask = rows(fit_mask.T, nlo, nhi, nb).T.contiguous()
    else:
        mask = rows(rows(fit_mask, glo, ghi, gb).T, nlo, nhi, nb).T.contiguous()
    return (rows(alloc, nlo, nhi, nb), rows(requested, nlo, nhi, nb),
            rows(group_req, glo, ghi, gb), rows(remaining, glo, ghi, gb), mask,
            rows(group_valid, glo, ghi, gb), order)


def sharded_schedule_batch(mesh: ShardMesh, args: tuple, replicated_scan: bool = True,
                           sharded_scan: bool = False, scan_wave: int = 0,
                           scan_topk: int = 0):
    """One oracle batch over the mesh, called by every rank with the same
    packed ``args`` (``ClusterSnapshot.device_args()``); rank 0 gets
    ``ops.oracle.schedule_batch``'s whole output dict, the other ranks None
    once their share is done.

    - ``sharded_scan=True``: the node-sharded scan
      (``ops.oracle.assign_gangs_sharded``) at ``scan_wave`` or, below 2,
      8: each rank scans its node block only, a wave's merge moves
      ``[S, W, 128]`` summaries, and one gather brings the blocks' takes
      and leftover to rank 0, which computes the head on its whole inputs.
    - ``replicated_scan`` (the default without ``sharded_scan``): the head
      on each rank's ``(groups, nodes)`` block and one gather to rank 0,
      then the serial (or, at ``scan_wave`` > 1, the wavefront) kernel on
      rank 0 with the whole inputs: no collective inside the scan. (The
      reference's GSPMD copy of the scan on every device computes the same
      output; a follower's copy would be thrown away.)

    The reference's third layout (both False: GSPMD's partitioned scan) has
    no counterpart and raises, as ``scan_topk`` > 0 does until the sharded
    top-K rung is ported."""
    if scan_topk > 0:
        raise NotImplementedError(_NEXT_SLICE)
    if not (replicated_scan or sharded_scan):
        raise ValueError("the fully partitioned scan is GSPMD's layout and has no "
                         "counterpart in the port: pick replicated_scan or sharded_scan")
    batch = args_from_numpy(args, mesh.device)
    return okern.schedule_batch(*batch, scan_wave=scan_wave, scan_mesh=mesh,
                                scan_shard=sharded_scan)


def sharded_collective_counts(mesh: ShardMesh, args: tuple, replicated_scan: bool = True) -> dict:
    """The collectives one whole batch issues on this rank, by op: calls
    (the reference counts the compiled module's instruction sites; the
    replicated layout's contract is a handful a batch, none inside the
    scan). SPMD, like ``sharded_schedule_batch``."""
    with mesh.recording() as records:
        sharded_schedule_batch(mesh, args, replicated_scan=replicated_scan,
                               sharded_scan=not replicated_scan)
    return {op: sum(1 for o, _, _ in records if o == op) for op in COLLECTIVES}


def sharded_scan_collective_counts(mesh: ShardMesh, args: tuple, wave: int = 8,
                                   topk: int = 0) -> dict:
    """The collective budget of the node-sharded scan alone (the leftover,
    then ``assign_gangs_sharded`` with its outputs left in blocks, as the
    reference lowers it), run on these inputs by every rank. The
    reference's keys:

    - ``counts``: by op, the distinct call sites the scan used (the
      reference's static instruction sites); ``calls`` and ``sites`` add
      the calls by op and by site;
    - ``max_collective_bytes``: the largest call; the contract is
      ``<= summary_bytes`` (S x W x 128 int32), never ``node_state_bytes``
      (N x R lanes);
    - ``waves``: sequential steps at this (G, wave);
    - ``fastpath_collectives_per_wave``: measured, the merges and verifies
      a wave issues before it commits or replays (2 by construction; a
      replayed wave's gang merges come after and count under ``replay``)."""
    if topk > 0:
        raise NotImplementedError(_NEXT_SLICE)
    alloc, requested, group_req, remaining, fit_mask, _gv, order = args_from_numpy(
        args, mesh.device)
    w = max(int(wave), 2)
    with mesh.recording() as records:
        okern.assign_gangs_sharded(
            okern.left_resources(alloc, requested), group_req, remaining, fit_mask, order,
            mesh=mesh, wave=w, with_stats=True, gather=False)
    g = int(group_req.shape[0])
    waves = -(-g // w)
    sites: dict = {}
    for _op, site, _b in records:
        sites[site] = sites.get(site, 0) + 1
    return {
        "counts": {op: len({s for o, s, _ in records if o == op}) for op in COLLECTIVES},
        "calls": {op: sum(1 for o, _, _ in records if o == op) for op in COLLECTIVES},
        "sites": sites,
        "max_collective_bytes": max((b for _, _, b in records), default=0),
        "summary_bytes": mesh.size * w * okern._BINS * 4,
        "node_state_bytes": int(alloc.shape[0]) * int(alloc.shape[1]) * 4,
        "waves": waves,
        "fastpath_collectives_per_wave": (sites.get("merge", 0) + sites.get("verify", 0)) / waves,
    }


# -- the leader and its followers ----------------------------------------------

# the batch arrays in broadcast order: the int32 ones first, so each starts
# on a 4-byte boundary of the packed buffer
_ORDER = (0, 1, 2, 3, 6, 4, 5)  # alloc, requested, group_req, remaining, order, fit_mask, group_valid


def _shapes(g: int, n: int, r: int, mask_rows: int) -> tuple:
    return ((n, r), (n, r), (g, r), (g,), (mask_rows, n), (g,), (g,))


def lead_batch(mesh: ShardMesh, batch: tuple, sharded: bool, wave: int, topk: int,
               top_k: int) -> None:
    """Rank 0's half of a mesh batch: the header and the packed batch
    ``batch`` (the seven tensors on the mesh's device) to every follower.
    The caller holds ``mesh.lock`` from here to the end of the batch."""
    if mesh.rank != 0:
        raise ValueError(f"rank {mesh.rank} cannot lead: ranks other than 0 run follow(mesh)")
    if mesh.stopped:
        raise RuntimeError("the followers were stopped (stop_followers)")
    if mesh.size == 1:
        return
    alloc, _, group_req, _, fit_mask, _, _ = batch
    header = torch.tensor([1, group_req.shape[0], alloc.shape[0], alloc.shape[1],
                           fit_mask.shape[0], int(sharded), wave, topk, top_k],
                          dtype=torch.int64, device=mesh.device)
    mesh.broadcast(header, "header")
    packed = torch.cat([batch[i].contiguous().view(-1).view(torch.uint8) for i in _ORDER])
    mesh.broadcast(packed, "batch")


def stop_followers(mesh: ShardMesh) -> None:
    """Send the stop header: every ``follow`` returns. Once only."""
    with mesh.lock:
        if mesh.stopped or mesh.rank != 0:
            return
        mesh.stopped = True
        if mesh.size > 1:
            mesh.broadcast(torch.zeros(_HEADER_LEN, dtype=torch.int64, device=mesh.device),
                           "header")


def follow(mesh: ShardMesh) -> int:
    """The loop of a rank other than 0 while rank 0 serves: receive each
    mesh batch's header and arrays and run this rank's share of it (its
    node block of the sharded scan, or its block of the replicated rung's
    head), until the stop header.
    Returns the batches followed."""
    if mesh.rank == 0:
        raise ValueError("rank 0 leads (OracleScorer(scan_mesh=mesh)); it does not follow")
    done = 0
    while True:
        header = mesh.broadcast(torch.zeros(_HEADER_LEN, dtype=torch.int64, device=mesh.device),
                                "header")
        go, g, n, r, mask_rows, sharded, wave, topk, top_k = header.tolist()
        if not go:
            return done
        shapes = _shapes(g, n, r, mask_rows)
        dtypes = (torch.int32,) * 4 + (torch.bool, torch.bool, torch.int32)
        sizes = [int(np.prod(shapes[i])) * (4 if dtypes[i] == torch.int32 else 1)
                 for i in _ORDER]
        packed = mesh.broadcast(torch.empty(sum(sizes), dtype=torch.uint8, device=mesh.device),
                                "batch")
        batch = [None] * 7
        at = 0
        for i, size in zip(_ORDER, sizes):
            batch[i] = packed[at:at + size].view(dtypes[i]).view(shapes[i])
            at += size
        okern.schedule_batch(*batch, top_k=top_k, scan_wave=wave, scan_topk=topk,
                             scan_mesh=mesh, scan_shard=bool(sharded))
        done += 1
