"""The least time an H100 could take for one assignment scan: the larger of
the bytes the scan must move (each input read once, each output written
once) over the card's memory rate, and the integer operations these inputs
need over its int32 rate.

One copy of the arithmetic for ``chip_smoke.py``'s ``kernels`` line and
the ``/debug/buckets`` route (``ops.oracle.bucket_cost_report``). The
``*_work`` functions count from shapes and plain numbers (what a collected
batch knows); ``scan_bound``, ``policy_bound`` and ``topk_bound`` count from
the scan's input tensors, as the smoke hands them.
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
    "scan_bound",
    "policy_bound",
    "topk_bound",
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
