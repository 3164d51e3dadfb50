"""Shape bucketing: pad dynamic node/group counts to a small set of shapes.

Buckets are powers of two (smallest 8), so a cluster whose node count
drifts between 4,997 and 5,003 packs to one shape. The padding rules are
the reference's (``batch_scheduler_tpu/ops/bucketing.py``), so both
packages produce the same padded batch from the same cluster.
"""

from __future__ import annotations

import numpy as np

from .lanes import LANE_MAX

__all__ = ["bucket_size", "wave_width_bucket", "topk_bucket", "pad_to", "pad_rows",
           "pad_oracle_batch"]

_MIN_BUCKET = 8

# Widths the wavefront assignment scan runs at: powers of two between 2
# and 32. Below 2 the wave is the serial scan; 32 is one gang per warp of
# the CUDA kernel's per-wave selection and the reference's upper bound.
_WAVE_MIN, _WAVE_MAX = 2, 32

# Candidate widths the hierarchical top-K scan runs at (``BST_SCAN_TOPK``):
# powers of two between 4 and 128. 128 is ASSIGNMENT_TOP_K, the widest span
# a gang's compact readback reports, and the CUDA kernel's largest slice.
_TOPK_MIN, _TOPK_MAX = 4, 128


def bucket_size(n: int) -> int:
    """Smallest power-of-two bucket >= n (>= 8)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def wave_width_bucket(w: int) -> int:
    """Wave width of the wavefront assignment scan for a requested ``w``
    (the ``BST_SCAN_WAVE`` knob): 0 or 1 means the serial scan and maps
    to 0; anything else rounds up to a power of two in [2, 32]."""
    if w <= 1:
        return 0
    b = _WAVE_MIN
    while b < w and b < _WAVE_MAX:
        b <<= 1
    return b


def topk_bucket(k: int) -> int:
    """Candidate width of the hierarchical top-K scan for a requested ``k``
    (the ``BST_SCAN_TOPK`` knob): 0 or less means the rung is off and maps
    to 0; anything else rounds up to a power of two in [4, 128]."""
    if k <= 0:
        return 0
    b = _TOPK_MIN
    while b < k and b < _TOPK_MAX:
        b <<= 1
    return b


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` to ``size`` with ``fill``."""
    pad = size - arr.shape[axis]
    if pad < 0:
        raise ValueError(f"array dim {arr.shape[axis]} exceeds bucket {size}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def pad_rows(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    return pad_to(arr, size, axis=0, fill=fill)


def pad_oracle_batch(
    alloc,
    requested,
    group_req,
    remaining,
    fit_mask,
    group_valid,
    order,
    min_member,
    scheduled,
    matched,
    ineligible,
    creation_rank,
    min_buckets=(0, 0),
):
    """Bucket-pad one oracle batch with the canonical sentinel fills.

    - padded groups: zero demand, invalid, ineligible for max-progress
      selection, last in creation rank, appended at the tail of the scan
      order (remaining == 0, so they place nothing);
    - padded nodes: zero lanes (capacity 0), masked out of every fit row.

    A broadcast ``[1,N]`` fit mask keeps its single row: padded groups are
    already neutralised by zero demand + group_valid=False, and padded
    nodes by the axis-1 False fill.

    ``min_buckets=(G, N)`` sets floor bucket sizes.

    Returns ``(batch_args, progress_args)`` ready for
    ``ops.oracle.execute_batch_host``.
    """
    from .oracle import GANG_MAX

    n = alloc.shape[0]
    g = group_req.shape[0]
    nb = max(bucket_size(max(n, 1)), min_buckets[1])
    gb = max(bucket_size(max(g, 1)), min_buckets[0])
    # Enforce the member-capacity division domain (ops.lanes.LANE_MAX) at
    # the batch boundary: out-of-domain lanes would be silently clamped by
    # the oracle, not rejected.
    for name, arr in (("alloc", alloc), ("requested", requested),
                      ("group_req", group_req)):
        a = np.asarray(arr)
        if a.size and (np.abs(a.astype(np.int64)) > int(LANE_MAX)).any():
            raise OverflowError(
                f"{name} lanes exceed LANE_MAX (2**30): max abs "
                f"{int(np.abs(a.astype(np.int64)).max())}"
            )
    # The assignment scan and gang_feasible accumulate need-clipped
    # capacities over the node bucket in int32; sum <= need * nb, so the
    # admissible gang size shrinks with the node bucket: need * nb must stay
    # strictly below 2**31.
    gang_bound = min(GANG_MAX, (2**31 - 1) // nb)
    for name, arr, bound in (
        ("remaining", remaining, gang_bound),
        ("min_member", min_member, GANG_MAX),
        ("scheduled", scheduled, GANG_MAX),
        ("matched", matched, GANG_MAX),
    ):
        a = np.asarray(arr)
        if a.size and (np.abs(a.astype(np.int64)) > bound).any():
            raise OverflowError(
                f"{name} exceeds the gang bound ({bound} members at node "
                f"bucket {nb}): max abs {int(np.abs(a.astype(np.int64)).max())}"
            )
    batch_args = (
        pad_rows(np.asarray(alloc, dtype=np.int32), nb),
        pad_rows(np.asarray(requested, dtype=np.int32), nb),
        pad_rows(np.asarray(group_req, dtype=np.int32), gb),
        pad_rows(np.asarray(remaining, dtype=np.int32), gb),
        pad_to(
            np.asarray(fit_mask, dtype=bool)
            if np.asarray(fit_mask).shape[0] == 1
            else pad_rows(np.asarray(fit_mask, dtype=bool), gb, fill=False),
            nb,
            axis=1,
            fill=False,
        ),
        pad_rows(np.asarray(group_valid, dtype=bool), gb, fill=False),
        np.concatenate(
            [np.asarray(order, dtype=np.int32), np.arange(g, gb, dtype=np.int32)]
        ),
    )
    progress_args = (
        pad_rows(np.asarray(min_member, dtype=np.int32), gb),
        pad_rows(np.asarray(scheduled, dtype=np.int32), gb),
        pad_rows(np.asarray(matched, dtype=np.int32), gb),
        pad_rows(np.asarray(ineligible, dtype=bool), gb, fill=True),
        pad_rows(np.asarray(creation_rank, dtype=np.int32), gb, fill=gb - 1),
    )
    return batch_args, progress_args
