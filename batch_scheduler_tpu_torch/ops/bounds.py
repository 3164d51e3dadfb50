"""The least time an H100 could take for one assignment scan, and for the
batch's head and tail around it: the larger of the bytes the kernel must
move (each input read once, each output written once) over the card's
memory rate, and the integer operations these inputs need over its int32
rate.

One copy of the arithmetic for ``chip_smoke.py``'s ``kernels`` line and
the ``/debug/buckets`` route (``ops.oracle.bucket_cost_report``). The
``*_work`` functions count from shapes and plain numbers (what a collected
batch knows); ``scan_bound``, ``policy_bound``, ``topk_bound``,
``head_bound`` and ``tail_bound`` count from the kernel's input tensors,
as the smoke hands them.
"""

from __future__ import annotations

from typing import Tuple

__all__ = [
    "HBM_BYTES_PER_S",
    "INT32_OPS_PER_S",
    "bound",
    "scan_work",
    "policy_work",
    "topk_work",
    "shard_work",
    "shard_topk_work",
    "head_work",
    "tail_work",
    "scan_bound",
    "policy_bound",
    "topk_bound",
    "head_bound",
    "tail_bound",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# int32 rate: the data sheet's 67 TFLOP/s float32 counts an FMA as two
# operations on 128 lanes per SM; Hopper has 64 int32 lanes per SM.
INT32_OPS_PER_S = 67e12 / 4


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by) of ``nbytes`` moved and ``ops`` int32
    operations: the larger of the two times, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def scan_work(n: int, r: int, g: int, in_bytes: int, lanes: int,
              wave: int = 0) -> Tuple[int, int]:
    """(bytes, ops) of one scan of ``g`` gangs over ``n`` nodes of ``r``
    lanes whose inputs take ``in_bytes``: the outputs (the [G,N] int32
    assignment, G placed bytes, the [N,R] int32 leftover; two flag bytes a
    wave for the wavefront scan, ``wave`` > 0) written once, against per
    gang and node a division and a minimum per lane the gangs request
    (``lanes``: the nonzero entries of the [G,R] request) plus the mask,
    need clip, bin key, histogram add, threshold compare and take select."""
    out_bytes = g * n * 4 + g + n * r * 4 + (2 * -(-g // wave) if wave else 0)
    return in_bytes + out_bytes, n * (2 * lanes + 6 * g)


def policy_work(n: int, g: int, nbytes: int, ops: int) -> Tuple[int, int]:
    """``scan_work`` of the policy scan: plus the node columns it reads (4
    label hashes and a domain, 20 bytes a node) and the gang columns (aff,
    anti and 16 domain counts, 72 bytes a gang), and per gang and node the
    8 hash compares, the domain clamp and read, the penalty and the key
    (~14 operations)."""
    return nbytes + n * 20 + g * 72, ops + 14 * n * g


def topk_work(n: int, g: int, nbytes: int, ops: int, wave: int, conflicts: int,
              demotions: int) -> Tuple[int, float]:
    """``scan_work`` (without the wave flags) of the top-K scan with this
    batch's replayed waves (``conflicts``) and dense-column demotions:
    plus its three series (6 bytes a wave), and the coarse pass evaluates
    every gang's capacity on every node once (``scan_work``'s count), a
    replayed wave evaluates its gangs again and a demoted gang once more
    (the data-dependent part)."""
    nbytes += 6 * -(-g // wave)
    per_gang_node = ops / (n * g)
    return nbytes, ops + (min(conflicts * wave, g) + demotions) * n * per_gang_node


def shard_work(nl: int, r: int, g: int, s: int, wave: int, lanes: int, mask_rows: int,
               conflicts: int, megas: int) -> Tuple[int, float]:
    """(bytes, ops) of one rank's ``shard_wave`` launches over a whole
    node-sharded batch: ``g`` gangs at ``wave`` a wave over the rank's
    ``nl`` nodes of ``r`` lanes among ``s`` ranks, ``mask_rows`` mask rows
    (1 broadcast, else ``g``), ``lanes`` the nonzero entries of the [G,R]
    request, and this batch's ``conflicts`` (replayed waves) and ``megas``
    (uniform waves). Bytes: the block's leftover, the request rows and
    needs, the mask block and each wave's merged histograms read once (an
    [S, W, 128] buffer, [S, 1, 128] for a uniform wave's one stream row and
    for each replayed gang); the takes, flags, leftover, each wave's
    histogram buffer and verify words written once. Operations: every row's capacity (a division and a
    minimum per requested lane) with its key, clip, histogram add,
    threshold compare, prefix and take (~8 a node) once, where a uniform
    wave computes one row and then, per gang boundary, its take and its
    verify sum (~6 a node); the speculative waves' conflict pass (a
    capacity and a subtraction per lane, ~4 more a node); a replayed
    wave's gangs once more (the data-dependent part)."""
    steps = -(-g // wave)
    megas = min(megas, steps)
    merged_rows = (steps - megas) * wave + megas + min(conflicts * wave, g)
    nbytes = (2 * nl * r * 4 + g * r * 4 + g * 4 + mask_rows * nl + g * nl * 4 + g
              + 2 * merged_rows * s * 128 * 4 + steps * wave * 4)
    per_gang_node = 2 * lanes / max(g, 1) + 8
    spec_gangs = max(g - megas * wave, 0)
    ops = nl * ((spec_gangs + megas) * per_gang_node + megas * 6 * (wave + 1)
                + spec_gangs * (per_gang_node - 4) + min(conflicts * wave, g) * per_gang_node)
    return nbytes, ops


def shard_topk_work(nl: int, r: int, g: int, s: int, wave: int, k: int, lanes: int,
                    mask_rows: int, conflicts: int, megas: int, demotions: int,
                    replay_step: bool = False) -> Tuple[int, float]:
    """(bytes, ops) of one rank's ``shard_topk`` launches over a whole
    node-sharded top-K batch: ``g`` gangs at ``wave`` a wave and ``k``
    candidates over the rank's ``nl`` nodes of ``r`` lanes among ``s``
    ranks, ``mask_rows`` mask rows (1 broadcast, else ``g``), ``lanes`` the
    nonzero entries of the [G,R] request, and this batch's ``conflicts``
    (replayed waves), ``megas`` (uniform waves) and dense-column
    ``demotions``. Bytes, each tensor once: the block's leftover read and
    written, the request rows, needs and mask block read, the takes and
    flags written, each summary buffer written by its summary and read by
    its apply (``[S, W, 2 kk_l + 1]`` a speculative wave, ``[S, 1, 3 kk_l +
    W]`` a uniform one, ``[S, 1, 2 kk_l + 129]`` each replayed gang), and a
    verify word and a demotion word a wave. Operations: every row's
    capacity (a division and a minimum per requested lane) with its key,
    clip, count, histogram and compaction (~8 a node), the speculative
    waves' conflict pass (~4 more a node), a uniform wave's W pooled needs
    (2 a node and gang), a replayed gang's row once more and a demoted
    gang's dense take (~4 a node), and each merged row's rank sort of the
    ``S * kk_l`` candidates (2 a pair). ``replay_step`` counts one replayed
    gang's step alone (``g`` = ``wave`` = 1: its summary and apply)."""
    steps = -(-g // wave)
    megas = min(megas, steps)
    replayed = min(conflicts * wave, g)
    kk_l = max(1, min(k, nl))
    spec_rows = (steps - megas) * wave
    if replay_step:
        steps, megas, spec_rows, replayed = 1, 0, 0, 1
    payload = (spec_rows * (2 * kk_l + 1) + megas * (3 * kk_l + wave)
               + replayed * (2 * kk_l + 1 + 128))
    nbytes = (2 * nl * r * 4 + g * r * 4 + g * 4 + mask_rows * nl + g * nl * 4 + g
              + 2 * s * payload * 4 + steps * 8)
    per_gang_node = 2 * lanes / max(g, 1) + 8
    spec_gangs = 0 if replay_step else max(g - megas * wave, 0)
    merged_rows = spec_rows + megas + replayed
    ops = (nl * ((spec_gangs + megas + replayed) * per_gang_node + spec_gangs * 4
                 + megas * 2 * wave + demotions * 4)
           + merged_rows * 2 * (s * kk_l) ** 2)
    return nbytes, ops


def head_work(n: int, r: int, g: int, mask_rows: int, lanes: int, h: int = 0,
              anti_gangs: int = 0) -> Tuple[int, int]:
    """(bytes, ops) of the batch head (``csrc/batch_head.cu``) over ``g``
    gangs and ``n`` nodes of ``r`` lanes: ``mask_rows`` mask rows (1
    broadcast, else ``g``), ``lanes`` the nonzero entries of the [G,R]
    request, and with the anti-affinity term the ``[N, h]`` node hashes
    and the ``anti_gangs`` gangs that name a label. Bytes: alloc and
    requested, the request, needs, valid flags, the mask rows and the
    policy columns read once; the leftover, capacity and scores and the
    feasible flags written once. Operations: a multiply-shift division
    (2) and a minimum per node and requested lane, and per gang and node
    the mask, the need clip and sum, and the score (5), plus a compare per
    hash lane of each anti-affinity gang."""
    nbytes = (2 * n * r * 4 + g * r * 4 + g * 4 + g + mask_rows * n
              + (g * 4 + n * h * 4 if h else 0)
              + n * r * 4 + 2 * g * n * 4 + g)
    return nbytes, n * 3 * lanes + 5 * g * n + anti_gangs * n * h


def tail_work(g: int, n: int, k: int, blob: bool = True, steps: int = 0,
              demotions: bool = False) -> Tuple[int, int]:
    """(bytes, ops) of the batch tail (``csrc/batch_tail.cu``) on a ``[g,
    n]`` assignment with ``k`` slots a row, whatever the rows' widths: a
    top-k of a row needs one read of it. With the ``blob`` also the
    findMaxPG inputs, the feasible flags and ``steps`` waves' flags (and
    int32 ``demotions``). Bytes: the assignment, placed and valid flags
    read once; the placed flags, nodes and counts, the packed form when n
    <= 2^15 and the blob's head and stats written once. Operations: a
    compare per entry, the least a selection over the row needs."""
    reads = g * n * 4 + 2 * g
    writes = g + 2 * g * k * 4 + (g * k * 4 if n <= 2**15 else 0)
    if blob:
        n_stats = (4 if demotions else 3) if steps else 0
        reads += g + 4 * g * 4 + g + steps * (2 + (4 if demotions else 0))
        writes += (3 * g + 2 + n_stats) * 4
    return reads + writes, g * n


def _in_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def scan_bound(left, group_req, remaining, fit_mask, order, wave=0):
    """(bound_ms, bound_by, bytes, ops) of one scan on these inputs
    (``scan_work``; the wavefront scan computes the same function plus
    two flag bytes per wave, ``wave`` > 0)."""
    n, r = left.shape
    g = group_req.shape[0]
    lanes = int((group_req > 0).sum().item())
    nbytes, ops = scan_work(n, r, g, _in_bytes(left, group_req, remaining, fit_mask, order),
                            lanes, wave)
    return (*bound(nbytes, ops), nbytes, ops)


def policy_bound(args):
    """scan_bound of the policy scan (``policy_work``) on the scan's five
    inputs ``args``."""
    n, g = args[0].shape[0], args[1].shape[0]
    _, _, nbytes, ops = scan_bound(*args)
    nbytes, ops = policy_work(n, g, nbytes, ops)
    return (*bound(nbytes, ops), nbytes, ops)


def topk_bound(left, group_req, remaining, fit_mask, order, wave, stats):
    """(bound_ms, bound_by, bytes, ops) of one top-K scan on these inputs
    with this run's per-wave ``stats`` (conflicts, megas, demotions):
    ``topk_work`` with the conflicts and demotions summed."""
    n = left.shape[0]
    g = group_req.shape[0]
    _, _, nbytes, ops = scan_bound(left, group_req, remaining, fit_mask, order)
    conflicts, _, demotions = (int(x.sum().item()) for x in stats)
    nbytes, ops = topk_work(n, g, nbytes, ops, wave, conflicts, demotions)
    return (*bound(nbytes, ops), nbytes, ops)


def head_bound(alloc, requested, group_req, remaining, fit_mask, group_valid, anti=None,
               node_hash=None):
    """(bound_ms, bound_by, bytes, ops) of one batch head on these inputs
    (``head_work``; ``anti`` / ``node_hash`` when the anti-affinity term
    is on)."""
    n, r = alloc.shape
    g = group_req.shape[0]
    lanes = int((group_req > 0).sum().item())
    h = 0 if node_hash is None else int(node_hash.shape[1])
    anti_gangs = 0 if anti is None else int((anti > 0).sum().item())
    nbytes, ops = head_work(n, r, g, int(fit_mask.shape[0]), lanes, h, anti_gangs)
    return (*bound(nbytes, ops), nbytes, ops)


def tail_bound(assignment, k, blob=True, steps=0, demotions=False):
    """(bound_ms, bound_by, bytes, ops) of one batch tail on this
    assignment (``tail_work``)."""
    g, n = assignment.shape
    nbytes, ops = tail_work(g, n, k, blob, steps, demotions)
    return (*bound(nbytes, ops), nbytes, ops)
