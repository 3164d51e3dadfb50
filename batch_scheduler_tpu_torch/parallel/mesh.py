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
  (``core.OracleScorer(scan_mesh=mesh)`` or ``service.OracleServer(
  scan_mesh=mesh)`` -> ``ops.oracle.dispatch_batch``). Rank 0 sends
  messages, each a small header (its kind, shapes, rung, wave width, the
  holder's slot) and a packed payload:

  - a batch (``lead_batch``): the packed arrays, or only the O(G) tail
    when the batch's ``[N, R]`` / ``[G, R]`` tensors are a mesh holder's
    resident ones, which every follower keeps a copy of; each follower
    runs its share of the batch;
  - a keyframe / rows / drop (``mesh_keyframe``, ``mesh_rows``,
    ``mesh_drop``): a mesh holder (``ops.device_state.DeviceStateHolder(
    mesh=...)``) installing its resident tensors in its slot on every
    follower, scattering a refresh's churned node and group rows into
    them, or giving the slot up;
  - stop (``stop_followers``): ``follow`` returns.

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
    "mesh_drop",
    "mesh_keyframe",
    "mesh_rows",
    "shard_snapshot_args",
    "sharded_collective_counts",
    "sharded_scan_collective_counts",
    "sharded_schedule_batch",
    "stop_followers",
]

# the collective ops a mesh batch issues
COLLECTIVES = ("all_reduce", "broadcast", "gather")

# the follower header: [kind, G, N, R, mask rows, sharded, wave, topk, top_k,
# slot, node rows, group rows]; a batch's slot is -1 when it carries every array
_HEADER_LEN = 12
STOP, BATCH, KEYFRAME, ROWS, DROP = 0, 1, 2, 3, 4


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
        # rank 0: each mesh holder's slot -> the (alloc, requested,
        # group_req) tensors every follower holds a copy of
        self.resident: dict = {}  # guarded-by: lock
        self._slots = 0  # guarded-by: lock

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

    def new_slot(self) -> int:
        """A fresh slot number for a mesh holder's resident copies."""
        with self.lock:
            self._slots += 1
            return self._slots

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

    ``scan_topk`` > 0 runs the hierarchical top-K scan on whichever layout
    is live: with ``sharded_scan`` its node-sharded form
    (``ops.oracle.assign_gangs_topk_sharded``, a wave's merge moving
    candidate summaries), else the single-device top-K kernel on rank 0.
    The reference's third layout (both False: GSPMD's partitioned scan) has
    no counterpart and raises."""
    if not (replicated_scan or sharded_scan):
        raise ValueError("the fully partitioned scan is GSPMD's layout and has no "
                         "counterpart in the port: pick replicated_scan or sharded_scan")
    batch = args_from_numpy(args, mesh.device)
    return okern.schedule_batch(*batch, scan_wave=scan_wave, scan_mesh=mesh,
                                scan_shard=sharded_scan, scan_topk=scan_topk)


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
      ``<= summary_bytes`` (S x W x 128 int32; with ``topk`` > 0 the
      largest top-K payload: S x max(W (2 kk_l + 1), 3 kk_l + W, 2 kk_l +
      129) int32), never ``node_state_bytes`` (N x R lanes);
    - ``waves``: sequential steps at this (G, wave);
    - ``fastpath_collectives_per_wave``: measured, the merges and verifies
      a wave issues before it commits or replays (at most 2 by
      construction: a speculative wave's merge and verify, a uniform top-K
      wave's merge alone; a replayed wave's gang merges come after and
      count under ``replay``).

    ``topk`` > 0 runs the node-sharded top-K scan
    (``ops.oracle.assign_gangs_topk_sharded``) at that candidate width."""
    alloc, requested, group_req, remaining, fit_mask, _gv, order = args_from_numpy(
        args, mesh.device)
    w = max(int(wave), 2)
    left = okern.left_resources(alloc, requested)
    with mesh.recording() as records:
        if topk > 0:
            okern.assign_gangs_topk_sharded(left, group_req, remaining, fit_mask, order,
                                            mesh=mesh, wave=w, k=topk, with_stats=True,
                                            gather=False)
        else:
            okern.assign_gangs_sharded(left, group_req, remaining, fit_mask, order,
                                       mesh=mesh, wave=w, with_stats=True, gather=False)
    g = int(group_req.shape[0])
    waves = -(-g // w)
    sites: dict = {}
    for _op, site, _b in records:
        sites[site] = sites.get(site, 0) + 1
    if topk > 0:
        n_pad = -(-int(alloc.shape[0]) // mesh.size) * mesh.size
        kk_l, _ = okern.shard_topk_widths(topk, n_pad // mesh.size, mesh.size)
        summary_bytes = mesh.size * 4 * max(
            w * okern.shard_topk_payload(okern.TOPK_SPECULATIVE, kk_l, w),
            okern.shard_topk_payload(okern.TOPK_MEGA, kk_l, w),
            okern.shard_topk_payload(okern.TOPK_REPLAY, kk_l, 1))
    else:
        summary_bytes = mesh.size * w * okern._BINS * 4
    return {
        "counts": {op: len({s for o, s, _ in records if o == op}) for op in COLLECTIVES},
        "calls": {op: sum(1 for o, _, _ in records if o == op) for op in COLLECTIVES},
        "sites": sites,
        "max_collective_bytes": max((b for _, _, b in records), default=0),
        "summary_bytes": summary_bytes,
        "node_state_bytes": int(alloc.shape[0]) * int(alloc.shape[1]) * 4,
        "waves": waves,
        "fastpath_collectives_per_wave": (sites.get("merge", 0) + sites.get("verify", 0)) / waves,
    }


# -- the leader and its followers ----------------------------------------------

# the batch arrays in broadcast order: the int32 ones first, so each starts
# on a 4-byte boundary of the packed buffer
_ORDER = (0, 1, 2, 3, 6, 4, 5)  # alloc, requested, group_req, remaining, order, fit_mask, group_valid
_TAIL = (3, 6, 4, 5)  # what a batch on a holder's resident tensors still carries
_DTYPES = (torch.int32,) * 4 + (torch.bool, torch.bool, torch.int32)


def _shapes(g: int, n: int, r: int, mask_rows: int) -> tuple:
    return ((n, r), (n, r), (g, r), (g,), (mask_rows, n), (g,), (g,))


def _pack(tensors) -> torch.Tensor:
    return torch.cat([t.contiguous().view(-1).view(torch.uint8) for t in tensors])


def _unpack(packed: torch.Tensor, shapes, dtypes) -> list:
    out, at = [], 0
    for shape, dt in zip(shapes, dtypes):
        size = int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
        out.append(packed[at:at + size].view(dt).view(shape))
        at += size
    return out


def _check_leader(mesh: ShardMesh) -> None:
    if mesh.rank != 0:
        raise ValueError(f"rank {mesh.rank} cannot lead: ranks other than 0 run follow(mesh)")
    if mesh.stopped:
        raise RuntimeError("the followers were stopped (stop_followers)")


def _send(mesh: ShardMesh, kind: int, payload: Optional[torch.Tensor], site: str,
          shape=(0, 0, 0, 0), rung=(0, 0, 0, 0), slot: int = -1, rows=(0, 0)) -> None:
    """One message to every follower: its header, then its payload. The
    caller holds ``mesh.lock``."""
    _check_leader(mesh)
    header = torch.tensor([kind, *shape, *rung, slot, *rows], dtype=torch.int64,
                          device=mesh.device)
    mesh.broadcast(header, "header")
    if payload is not None:
        mesh.broadcast(payload, site)


def lead_batch(mesh: ShardMesh, batch: tuple, sharded: bool, wave: int, topk: int,
               top_k: int) -> None:
    """Rank 0's half of a mesh batch: the header and the packed batch
    ``batch`` (the seven tensors on the mesh's device) to every follower,
    or, when its ``[N, R]`` / ``[G, R]`` tensors are the ones a mesh holder
    keeps resident on the followers (``mesh.resident``), the holder's slot
    and the O(G) tail alone. The caller holds ``mesh.lock`` from here to the
    end of the batch."""
    _check_leader(mesh)
    if mesh.size == 1:
        return
    alloc, _, group_req, _, fit_mask, _, _ = batch
    shape = (group_req.shape[0], alloc.shape[0], alloc.shape[1], fit_mask.shape[0])
    rung = (int(sharded), wave, topk, top_k)
    for slot, held in mesh.resident.items():
        if all(a is b for a, b in zip(batch[:3], held)):
            _send(mesh, BATCH, _pack(batch[i] for i in _TAIL), "tail", shape, rung, slot)
            return
    _send(mesh, BATCH, _pack(batch[i] for i in _ORDER), "batch", shape, rung)


def mesh_keyframe(mesh: ShardMesh, slot: int, alloc, requested, group_req) -> None:
    """A mesh holder's keyframe: its resident ``alloc``, ``requested`` and
    ``group_req`` to every follower, held there in ``slot`` (rank 0 only)."""
    with mesh.lock:
        _check_leader(mesh)
        if mesh.size > 1:
            shape = (group_req.shape[0], alloc.shape[0], alloc.shape[1], 0)
            _send(mesh, KEYFRAME, _pack((alloc, requested, group_req)), "keyframe", shape,
                  slot=slot)
        mesh.resident[slot] = (alloc, requested, group_req)


def mesh_rows(mesh: ShardMesh, slot: int, node_idx, node_rows, group_idx, group_rows) -> None:
    """A mesh holder's delta: the churned rows it scattered into its
    resident ``requested`` (``node_idx`` / ``node_rows``) and ``group_req``
    (``group_idx`` / ``group_rows``), host arrays, scattered into the
    followers' copies in ``slot``: the bytes are O(churn)."""
    nr, gr = len(node_idx), len(group_idx)
    if not (nr or gr):
        return
    with mesh.lock:
        _check_leader(mesh)
        if mesh.size == 1:
            return
        r = int(np.shape(node_rows)[1] if nr else np.shape(group_rows)[1])
        block = np.empty(8 * (nr + gr) + 4 * r * (nr + gr), np.uint8)
        block[:8 * nr].view(np.int64)[:] = node_idx
        block[8 * nr:8 * (nr + gr)].view(np.int64)[:] = group_idx
        at = 8 * (nr + gr)
        block[at:at + 4 * r * nr].view(np.int32)[:] = np.asarray(node_rows, np.int32).ravel()
        block[at + 4 * r * nr:].view(np.int32)[:] = np.asarray(group_rows, np.int32).ravel()
        _send(mesh, ROWS, torch.from_numpy(block).to(mesh.device), "rows", (0, 0, r, 0),
              slot=slot, rows=(nr, gr))


def mesh_drop(mesh: ShardMesh, slot: int) -> None:
    """Give up a mesh holder's slot on every follower (a closed sidecar
    connection's mirror). Nothing to do once the followers were stopped."""
    with mesh.lock:
        if mesh.resident.pop(slot, None) is None or mesh.stopped or mesh.size == 1:
            return
        _send(mesh, DROP, None, "header", slot=slot)


def stop_followers(mesh: ShardMesh) -> None:
    """Send the stop header: every ``follow`` returns. Once only."""
    with mesh.lock:
        if mesh.stopped or mesh.rank != 0:
            return
        if mesh.size > 1:
            _send(mesh, STOP, None, "header")
        mesh.stopped = True
        mesh.resident.clear()


def follow(mesh: ShardMesh) -> int:
    """The loop of a rank other than 0 while rank 0 serves: receive each
    message and act on it — run this rank's share of a batch (its node
    block of the sharded scan, or its block of the replicated rung's
    head), reading a holder's resident copies where the batch names its
    slot; install, scatter into or drop a holder's copies — until the stop
    header. Returns the batches followed."""
    if mesh.rank == 0:
        raise ValueError("rank 0 leads (OracleScorer(scan_mesh=mesh)); it does not follow")
    def receive(nbytes: int, site: str) -> torch.Tensor:
        return mesh.broadcast(torch.empty(nbytes, dtype=torch.uint8, device=mesh.device), site)

    done = 0
    slots: dict = {}  # slot -> [alloc, requested, group_req] on this rank's device
    while True:
        header = mesh.broadcast(torch.zeros(_HEADER_LEN, dtype=torch.int64, device=mesh.device),
                                "header")
        kind, g, n, r, mask_rows, sharded, wave, topk, top_k, slot, nr, gr = header.tolist()
        if kind == STOP:
            return done
        if kind == KEYFRAME:
            packed = receive(4 * (2 * n * r + g * r), "keyframe")
            slots[slot] = [t.clone() for t in _unpack(packed, ((n, r), (n, r), (g, r)),
                                                       (torch.int32,) * 3)]
            continue
        if kind == ROWS:
            packed = receive((8 + 4 * r) * (nr + gr), "rows")
            n_idx, g_idx, n_rows, g_rows = _unpack(
                packed, ((nr,), (gr,), (nr, r), (gr, r)),
                (torch.int64, torch.int64, torch.int32, torch.int32))
            held = slots[slot]
            if nr:
                held[1].index_copy_(0, n_idx, n_rows)
            if gr:
                held[2].index_copy_(0, g_idx, g_rows)
            continue
        if kind == DROP:
            slots.pop(slot, None)
            continue
        shapes = _shapes(g, n, r, mask_rows)
        if slot >= 0:
            batch = list(slots[slot]) + [None] * 4
            order = _TAIL
            site = "tail"
        else:
            batch = [None] * 7
            order = _ORDER
            site = "batch"
        sizes = sum(int(np.prod(shapes[i])) * (4 if _DTYPES[i] == torch.int32 else 1)
                    for i in order)
        parts = _unpack(receive(sizes, site), [shapes[i] for i in order],
                        [_DTYPES[i] for i in order])
        for i, t in zip(order, parts):
            batch[i] = t
        okern.schedule_batch(*batch, top_k=top_k, scan_wave=wave, scan_topk=topk,
                             scan_mesh=mesh, scan_shard=bool(sharded))
        done += 1
