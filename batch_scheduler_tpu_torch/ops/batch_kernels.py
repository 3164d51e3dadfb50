"""The head and the tail of one oracle batch as hand-written CUDA kernels,
with their plain PyTorch versions and launch counters.

The reference computes both inside its one jit'd batch program
(``batch_scheduler_tpu/ops/oracle.py`` ``schedule_batch`` and
``_batch_blob_impl``), where XLA fuses them; they reach no ``pallas_call``.
The port runs each as one launch around the scan:

- ``batch_head_cuda`` (``csrc/batch_head.cu``): the leftover, the
  member-capacity matrix (with the policy's anti-affinity fold), the
  per-gang feasibility and the Score ranks. Plain version
  ``batch_head_plain``: ``ops.oracle`` ``left_resources`` ->
  ``group_capacity`` -> (``policy.terms.compose_keep_dense``) ->
  ``gang_feasible`` -> ``score_nodes``. The mesh's two other modes are
  ``head_block_cuda`` (a rank's zero-padded ``(groups, nodes)`` block of
  the capacity matrix, the mask read with its row stride in place) and
  ``head_finish_cuda`` (feasibility and scores from a gathered matrix);
  ``head_left_cuda`` is the leftover alone (a node-sharded follower's).
  All four are the one kernel and count into ``batch_head_cuda.launches``;
  ``head_kernel_plan`` is the twin of the source's launch plan.
- ``batch_tail_cuda`` (``csrc/batch_tail.cu``): the compact top-K of the
  ``[G, N]`` assignment in ``lax.top_k``'s order, ``placed &
  group_valid``, the packed form and, with the progress inputs, the whole
  blob of ``ops.oracle._batch_blob`` (findMaxPG included). Plain version
  ``batch_tail_plain``: ``_top_k_ties_by_index``, the pack,
  ``find_max_group`` and the ``torch.cat``.

For tensors on the CPU each wrapper runs its plain version; for CUDA
tensors it launches its kernel or raises with the kernel's CUDA error.
Nothing falls back and no switch turns a kernel off. ``ops._build``
compiles both sources with ``nvcc`` at first use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .assign_scan import _count_launch

__all__ = [
    "batch_head_cuda", "batch_head_plain", "batch_tail_cuda", "batch_tail_plain",
    "head_block_cuda", "head_finish_cuda", "head_kernel_plan", "head_left_cuda", "HeadPlan",
    "PACK_MAX_NODES",
]

_MAX_LANES = 32  # csrc/batch_head.cu kMaxLanes
_MAX_HASH = 8  # csrc/batch_head.cu kMaxHash
# csrc/batch_head.cu's launch constants, mirrored by head_kernel_plan
_HEAD_THREADS = 256  # kThreads
_HEAD_NODES_THREAD = 4  # kNodesThread: one int4 of an output row
_HEAD_TILE_NODES = _HEAD_THREADS * _HEAD_NODES_THREAD
_HEAD_REG_LANES = 6  # kRegLanes: leftover lanes a thread keeps in registers
_HEAD_MAX_CLUSTER = 8  # kMaxCluster
_HEAD_MAX_TILE = 32  # kMaxTile: gangs a block, at most
_HEAD_MIN_TILE = 4  # kMinTile: and at least
_HEAD_MIN_BLOCKS = 264  # kMinBlocks: two blocks a streaming multiprocessor of an H100
_HEAD_SHARED_BUDGET = 216064  # kSharedBudget: dynamic shared memory a block
_MAX_K = 128  # csrc/batch_tail.cu kMaxK (ops.oracle.ASSIGNMENT_TOP_K)
PACK_MAX_NODES = 2**15  # the packed form's node bound (16 bits of node index)


class HeadPlan(NamedTuple):
    """The head kernel's launch (``csrc/batch_head.cu`` ``head_plan``)."""

    leftover: str  # "registers" (R <= 6), "shared" (more lanes) or "none" (the finish)
    tg: int  # gangs a block
    tiles: int  # node tiles of a row, 1,024 nodes each
    cluster: int  # blocks a row, one cluster where they sum feasibility; block c
    # takes tiles c, c + cluster, ...
    gang_tiles: int
    blocks: int
    shared_bytes: int  # dynamic shared memory a block
    threads: int
    nodes_thread: int
    path: str  # "vector" (every row 16-byte aligned) or "edges" (nb % 4 != 0)


def head_kernel_plan(g: int, n: int, r: int, h: int = 0, feasible: bool = True,
                     finish: bool = False) -> HeadPlan:
    """The head kernel's launch for a ``[g, n]`` output block of ``r``
    lanes, ``h`` hash lanes (the anti-affinity fold), with the feasibility
    sums or as the finish from a gathered matrix: the twin of the source's
    ``head_plan``. A block of 256 threads holds a tile of TG gangs by 1,024
    nodes (4 consecutive nodes a thread), the leftover lanes in registers
    up to 6 lanes, else in shared memory; a row's node tiles are spread
    over up to 8 blocks, one thread-block cluster where they sum the
    feasibility; TG is the largest of 32, 16, 8, 4 that gives at least 264
    blocks (two an SM of an H100) within the dynamic shared memory budget (the feasibility slots, 8 bytes a gang and thread;
    the shared leftover and hash lanes, 4 bytes a node and lane). A row
    whose start is not 16-byte aligned writes a scalar head and tail around
    its 16-byte stores (``path`` "edges")."""
    leftover = "none" if finish else ("shared" if r > _HEAD_REG_LANES else "registers")
    tiles = -(-n // _HEAD_TILE_NODES) if n > _HEAD_TILE_NODES else 1
    cluster = min(tiles, _HEAD_MAX_CLUSTER)
    fixed = ((r * _HEAD_TILE_NODES * 4 if leftover == "shared" else 0)
             + (h * _HEAD_TILE_NODES * 4 if not finish else 0))
    tg = _HEAD_MAX_TILE
    while tg > _HEAD_MIN_TILE:
        acc = tg * _HEAD_THREADS * 8 if feasible else 0
        if cluster * -(-g // tg) >= _HEAD_MIN_BLOCKS and fixed + acc <= _HEAD_SHARED_BUDGET:
            break
        tg //= 2
    gang_tiles = -(-g // tg)
    return HeadPlan(leftover, tg, tiles, cluster, gang_tiles, cluster * gang_tiles,
                    fixed + (tg * _HEAD_THREADS * 8 if feasible else 0), _HEAD_THREADS,
                    _HEAD_NODES_THREAD, "vector" if n % 4 == 0 else "edges")


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _head_entry():
    """(launch, error_string) of ``csrc/batch_head.cu``."""
    lib = _build.library("batch_head")
    launch = lib.bst_batch_head
    launch.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    err = lib.bst_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return launch, err


@functools.lru_cache(maxsize=None)
def _tail_entry():
    """(launch, error_string) of ``csrc/batch_tail.cu``."""
    lib = _build.library("batch_tail")
    launch = lib.bst_batch_tail
    launch.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    err = lib.bst_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return launch, err


def _check_cuda(caller, **tensors):
    """Every given tensor on one CUDA device, contiguous, of its dtype."""
    dev = None
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{caller}: {name} must be {dtype}, got {t.dtype}")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{caller}: {name} is on {t.device}, not {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous")
    return dev


def _launch_head(caller, alloc, requested, *, req=None, remaining=None, mask=None,
                 mask_stride=0, valid=None, anti=None, node_hash=None, cap_in=None,
                 left_out=None, cap_out=None, scores_out=None, feasible_out=None,
                 n_lo=0, nv=0, gv=0, gb=0, nb=0):
    """One counted launch of the head kernel on checked CUDA tensors
    (``mask`` is a pointer already offset to the block's first row and
    node)."""
    dev = (alloc if alloc is not None else cap_in).device
    n_total, r = alloc.shape if alloc is not None else (0, 1)
    if r > _MAX_LANES:
        raise ValueError(f"{caller}: at most {_MAX_LANES} lanes on the card, got {r}")
    h = 0 if node_hash is None else node_hash.shape[1]
    if h > _MAX_HASH:
        raise ValueError(f"{caller}: at most {_MAX_HASH} hash lanes, got {h}")
    launch, err = _head_entry()
    with torch.cuda.device(dev):
        rc = launch(
            _ptr(alloc), _ptr(requested), _ptr(req), _ptr(remaining), mask, _ptr(valid),
            _ptr(anti), _ptr(node_hash), _ptr(cap_in), _ptr(left_out), _ptr(cap_out),
            _ptr(scores_out), _ptr(feasible_out), n_total, r, h, n_lo, nv, gv, gb, nb,
            mask_stride, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{caller}: batch_head kernel launch failed: "
                           f"{err(rc).decode(errors='replace')} (CUDA error {rc})")
    batch_head_cuda.launches += 1
    _count_launch("batch_head")


def _mask_rows(fit_mask, g, n, caller):
    if fit_mask.dim() != 2 or fit_mask.shape[1] != n or fit_mask.shape[0] not in (1, g):
        raise ValueError(f"{caller}: fit_mask {tuple(fit_mask.shape)} must be [1,{n}] "
                         f"or [{g},{n}]")


def batch_head_plain(alloc, requested, group_req, remaining, fit_mask, group_valid,
                     anti=None, node_hash=None):
    """The head's plain version: ``(left, capacity, gang_feasible,
    scores)``, the reference's chain (``anti`` / ``node_hash``, the policy
    columns, fold the anti-affinity term into the capacity)."""
    from ..policy.terms import compose_keep_dense
    from .oracle import gang_feasible, group_capacity, left_resources, score_nodes

    left = left_resources(alloc, requested)
    cap = group_capacity(left, group_req, fit_mask)
    if anti is not None:
        cap = cap * compose_keep_dense(("anti-affinity",), anti, node_hash)
    return left, cap, gang_feasible(cap, remaining, group_valid), score_nodes(cap)


def batch_head_cuda(alloc, requested, group_req, remaining, fit_mask, group_valid,
                    anti=None, node_hash=None):
    """The head of a whole batch: ``(left [N,R] int32, capacity [G,N]
    int32, gang_feasible [G] bool, scores [G,N] int32)``. ``fit_mask`` is
    ``[G,N]`` or a broadcast ``[1,N]`` row; ``anti`` ``[G]`` and
    ``node_hash`` ``[N,H]`` (int32, given together) fold the policy's
    anti-affinity term into the capacity, as
    ``policy.terms.compose_keep_dense`` does. The kernel for CUDA tensors
    (the feasibility sum in int64), ``batch_head_plain`` for CPU tensors.
    Every launch adds one to ``batch_head_cuda.launches``."""
    g, n = group_req.shape[0], alloc.shape[0]
    _mask_rows(fit_mask, g, n, "batch_head_cuda")
    if (anti is None) != (node_hash is None):
        raise ValueError("batch_head_cuda: anti and node_hash come together")
    i32, b8 = torch.int32, torch.bool
    dev = _check_cuda("batch_head_cuda", alloc=(alloc, i32), requested=(requested, i32),
                      group_req=(group_req, i32), remaining=(remaining, i32),
                      fit_mask=(fit_mask, b8), group_valid=(group_valid, b8),
                      anti=(anti, i32), node_hash=(node_hash, i32))
    if dev.type == "cpu":
        return batch_head_plain(alloc, requested, group_req, remaining, fit_mask, group_valid,
                                anti, node_hash)
    if dev.type != "cuda":
        raise ValueError(f"batch_head_cuda takes CPU or CUDA tensors, not {dev}")
    left = torch.empty_like(alloc)
    cap = torch.empty((g, n), dtype=i32, device=dev)
    scores = torch.empty((g, n), dtype=i32, device=dev)
    feasible = torch.empty(g, dtype=b8, device=dev)
    _launch_head("batch_head_cuda", alloc, requested, req=group_req, remaining=remaining,
                 mask=fit_mask.data_ptr(), mask_stride=n if fit_mask.shape[0] != 1 else 0,
                 valid=group_valid, anti=anti, node_hash=node_hash, left_out=left,
                 cap_out=cap, scores_out=scores, feasible_out=feasible,
                 nv=n, gv=g, gb=g, nb=n)
    return left, cap, feasible, scores


batch_head_cuda.launches = 0


def head_left_cuda(alloc, requested):
    """The leftover ``alloc - requested`` alone: the head kernel's
    leftover pass for CUDA tensors (a node-sharded follower, which scans
    its block and computes no capacity), ``ops.oracle.left_resources`` for
    CPU tensors. A launch counts into ``batch_head_cuda.launches``."""
    dev = _check_cuda("head_left_cuda", alloc=(alloc, torch.int32),
                      requested=(requested, torch.int32))
    if dev.type == "cpu":
        from .oracle import left_resources

        return left_resources(alloc, requested)
    left = torch.empty_like(alloc)
    _launch_head("head_left_cuda", alloc, requested, left_out=left)
    return left


def head_block_cuda(alloc, requested, group_req, fit_mask, groups, nodes, shape,
                    with_left=False):
    """One rank's block of the capacity matrix on the replicated mesh rung:
    ``(left or None, block [gb, nb] int32)``, the capacity of groups
    ``[glo, ghi)`` on nodes ``[nlo, nhi)`` (``groups``, ``nodes``) in the
    top-left corner of a zero ``shape = (gb, nb)`` block. The kernel reads
    the mask's rows in place with their stride (no copy of the slice);
    ``with_left`` also writes the whole leftover (rank 0 scans it). The
    plain version, for CPU tensors, is ``group_capacity`` on the slices. A
    launch counts into ``batch_head_cuda.launches``."""
    (glo, ghi), (nlo, nhi), (gb, nb) = groups, nodes, shape
    n, r = alloc.shape
    g = group_req.shape[0]
    _mask_rows(fit_mask, g, n, "head_block_cuda")
    if not (0 <= glo <= ghi <= g and ghi - glo <= gb and 0 <= nlo <= nhi <= n
            and nhi - nlo <= nb):
        raise ValueError(f"head_block_cuda: block {groups} x {nodes} of [{g}, {n}] "
                         f"does not fit {shape}")
    i32 = torch.int32
    dev = _check_cuda("head_block_cuda", alloc=(alloc, i32), requested=(requested, i32),
                      group_req=(group_req, i32), fit_mask=(fit_mask, torch.bool))
    if dev.type == "cpu":
        from .oracle import group_capacity, left_resources

        left = left_resources(alloc, requested)
        mask = fit_mask[:, nlo:nhi] if fit_mask.shape[0] == 1 else fit_mask[glo:ghi, nlo:nhi]
        block = torch.zeros((gb, nb), dtype=i32, device=dev)
        block[:ghi - glo, :nhi - nlo] = group_capacity(left[nlo:nhi], group_req[glo:ghi], mask)
        return (left if with_left else None), block
    per_group = fit_mask.shape[0] != 1
    mask_ptr = fit_mask.data_ptr() + (glo * n if per_group else 0) + nlo
    left = torch.empty_like(alloc) if with_left else None
    block = torch.empty((gb, nb), dtype=i32, device=dev)
    _launch_head("head_block_cuda", alloc, requested,
                 req=group_req[glo:ghi] if ghi > glo else group_req, mask=mask_ptr,
                 mask_stride=n if per_group else 0, left_out=left, cap_out=block,
                 n_lo=nlo, nv=nhi - nlo, gv=ghi - glo, gb=gb, nb=nb)
    return left, block


def head_finish_cuda(cap, remaining, group_valid):
    """``(gang_feasible [G] bool, scores [G,N] int32)`` of a whole capacity
    matrix gathered on the replicated mesh rung's rank 0: the head
    kernel's finish for CUDA tensors, ``gang_feasible`` and
    ``score_nodes`` for CPU tensors. A launch counts into
    ``batch_head_cuda.launches``."""
    g, n = cap.shape
    dev = _check_cuda("head_finish_cuda", cap=(cap, torch.int32),
                      remaining=(remaining, torch.int32), group_valid=(group_valid, torch.bool))
    if dev.type == "cpu":
        from .oracle import gang_feasible, score_nodes

        return gang_feasible(cap, remaining, group_valid), score_nodes(cap)
    scores = torch.empty_like(cap)
    feasible = torch.empty(g, dtype=torch.bool, device=dev)
    _launch_head("head_finish_cuda", None, None, remaining=remaining, valid=group_valid,
                 cap_in=cap, scores_out=scores, feasible_out=feasible, mask=None,
                 nv=n, gv=g, gb=g, nb=n)
    return feasible, scores


def batch_tail_plain(assignment, placed, group_valid, k: int, progress=None,
                     feasible=None, pack: bool = False, stats=None):
    """The tail's plain version: ``(placed & group_valid, nodes [G,k],
    counts [G,k], packed [G,k] or None, blob or None)``, the reference's
    ``lax.top_k`` order by ``ops.oracle._top_k_ties_by_index``, the packed
    form when N <= 2^15 and, with ``progress``, ``_batch_blob``'s blob."""
    from .oracle import _top_k_ties_by_index, find_max_group

    placed = placed & group_valid
    counts, nodes = _top_k_ties_by_index(assignment, k)
    packed = None
    if assignment.shape[1] <= PACK_MAX_NODES:
        # compact fetch: (node << 16 | count), counts saturating at 65535
        packed = nodes * (2**16) + counts.clamp(max=2**16 - 1)
    if progress is None:
        return placed, nodes, counts, packed, None
    best, exists, prog = find_max_group(*progress)
    tail = packed.reshape(-1) if pack else torch.cat([nodes.reshape(-1), counts.reshape(-1)])
    parts = [placed.to(torch.int32), feasible.to(torch.int32), prog,
             torch.stack([best, exists.to(torch.int32)]), tail.to(torch.int32)]
    if stats is not None:
        conflicts, megas = stats[0], stats[1]
        sums = [
            # a fill on the device: a host tensor here would be a pageable
            # copy, which waits for the stream (the whole scan)
            conflicts.new_full((), conflicts.shape[0], dtype=torch.int32),
            conflicts.sum(dtype=torch.int32),
            megas.sum(dtype=torch.int32),
        ]
        if len(stats) > 2:
            sums.append(stats[2].sum(dtype=torch.int32))
        parts.append(torch.stack(sums))
    return placed, nodes, counts, packed, torch.cat(parts)


def batch_tail_cuda(assignment, placed, group_valid, k: int, progress=None,
                    feasible=None, pack: bool = False, stats=None):
    """The tail of a batch: ``(placed & group_valid [G] bool, nodes [G,k]
    int32, counts [G,k] int32, packed [G,k] int32 or None, blob or None)``.

    ``assignment`` is the scan's non-negative ``[G,N]`` int32 output and
    ``k`` <= min(128, N): each row's k largest counts with ties in
    ascending node order (``lax.top_k``'s order), the zero tail being the
    ascending nodes that hold no take; ``packed`` (N <= 2^15) is
    ``node << 16 | min(count, 65535)``. With ``progress`` (``min_member,
    scheduled, matched, ineligible, creation_rank``) and ``feasible`` the
    blob of ``ops.oracle._batch_blob`` comes too, its tail packed when
    ``pack`` (N <= 2^15) else nodes then counts, then ``stats``
    (``(conflicts, megas)`` bool [S], plus the top-K rung's int32
    demotions [S]) as its 3 or 4 ints; on the card the returned nodes,
    counts or packed are views into that blob. The kernel for CUDA
    tensors, ``batch_tail_plain`` for CPU tensors. Its contract is
    non-negative counts: a signed row (``ops.explain``'s scores) takes
    ``ops.oracle._top_k_ties_by_index`` instead. Every launch adds one to
    ``batch_tail_cuda.launches``."""
    g, n = assignment.shape
    if not 1 <= k <= min(_MAX_K, n):
        raise ValueError(f"batch_tail_cuda: k must be in [1, {min(_MAX_K, n)}], got {k}")
    if pack and n > PACK_MAX_NODES:
        raise ValueError(f"batch_tail_cuda: the packed tail needs N <= {PACK_MAX_NODES}")
    if (progress is None) != (feasible is None) or (stats is not None and progress is None):
        raise ValueError("batch_tail_cuda: the blob needs progress and feasible together, "
                         "and stats only with them")
    i32, b8 = torch.int32, torch.bool
    prog = dict(zip(("min_member", "scheduled", "matched", "ineligible", "creation_rank"),
                    zip(progress or (None,) * 5, (i32, i32, i32, b8, i32))))
    st = dict(zip(("conflicts", "megas", "demotions"),
                  zip(stats or (), (b8, b8, i32))))
    dev = _check_cuda("batch_tail_cuda", assignment=(assignment, i32), placed=(placed, b8),
                      group_valid=(group_valid, b8), feasible=(feasible, b8), **prog, **st)
    if dev.type == "cpu":
        return batch_tail_plain(assignment, placed, group_valid, k, progress, feasible, pack,
                                stats)
    if dev.type != "cuda":
        raise ValueError(f"batch_tail_cuda takes CPU or CUDA tensors, not {dev}")
    steps = stats[0].shape[0] if stats is not None else 0
    with torch.cuda.device(dev):
        placed_out = torch.empty(g, dtype=b8, device=dev)
        blob = stats_out = None
        packed = None
        if progress is not None:
            tail_len = g * k if pack else 2 * g * k
            n_stats = 0 if stats is None else len(stats) + 1
            blob = torch.empty(3 * g + 2 + tail_len + n_stats, dtype=i32, device=dev)
            body = blob[3 * g + 2: 3 * g + 2 + tail_len]
            if stats is not None:
                stats_out = blob[3 * g + 2 + tail_len:]
            if pack:
                packed = body.view(g, k)
            else:
                nodes, counts = body[:g * k].view(g, k), body[g * k:].view(g, k)
        if blob is None or pack:
            nodes = torch.empty((g, k), dtype=i32, device=dev)
            counts = torch.empty((g, k), dtype=i32, device=dev)
        if packed is None and n <= PACK_MAX_NODES:
            packed = torch.empty((g, k), dtype=i32, device=dev)
        launch, err = _tail_entry()
        p = progress or (None,) * 5
        s = tuple(stats or ()) + (None,) * (3 - len(stats or ()))
        rc = launch(
            _ptr(assignment), _ptr(placed), _ptr(group_valid), _ptr(feasible),
            *(_ptr(t) for t in p), *(_ptr(t) for t in s), _ptr(placed_out), _ptr(nodes),
            _ptr(counts), _ptr(packed), _ptr(blob), _ptr(stats_out), g, n, k, steps,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"batch_tail_cuda: kernel launch failed: "
                           f"{err(rc).decode(errors='replace')} (CUDA error {rc})")
    batch_tail_cuda.launches += 1
    _count_launch("batch_tail")
    return placed_out, nodes, counts, packed, blob


batch_tail_cuda.launches = 0
