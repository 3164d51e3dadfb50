"""Gang denial explanation: the device breakdown behind /debug/explain.

The port of ``batch_scheduler_tpu/ops/explain.py``. For ONE gang of one
batch (the canonical padded 7-tuple of ``ops.bucketing.pad_oracle_batch``)
it computes:

- **entry-leftover capture**: the leftover the serial assignment scan
  carried into the gang's step, so the explanation tells "infeasible even
  alone" (independent capacity, PreFilter's ``cluster cannot fit gang``)
  from "feasible alone but consumed by earlier gangs" (entry capacity, the
  ``reserved for earlier gangs`` denial);
- **per-lane blame**: per-node one-member deficits and, for each
  capacity-blocked node, its binding lane (the lane whose per-lane fit is
  smallest, ties to the lowest lane as ``jnp.argmin``);
- **exclusion split**: real (unpadded) nodes excluded by the fit mask, by
  a hard policy mask (anti-affinity) and by capacity;
- **near-miss nodes**: the ``NEAR_MISS_K`` nodes with the best entry
  capacity, then the smallest total deficit, ties by ascending node index
  (``lax.top_k``'s order; ``torch.topk`` promises none, so the stable sort
  of ``ops.oracle._top_k_ties_by_index`` ranks them).

Two routes to the scan, one answer:

- ``explain_gang_plain``: the reference's capture scan step by step (the
  same ``_member_capacity`` / ``_select_best_fit`` as the plain scans and,
  with policy, ``policy.terms.compose_terms`` with the composite key).
  ``explain_gang`` runs it for CPU tensors.
- the kernel route, for CUDA tensors: ``order`` is a permutation, and a
  step whose need is 0 takes nothing (``min(cap, 0)`` is 0 on every
  node), so the leftover at the gang's entry is the ``left_after`` of one
  launch of the serial cluster kernel with ``remaining`` zeroed at and
  after the gang's position (``prefix_leftover``), and the leftover after
  the batch is a second launch with the real ``remaining``. A policy batch
  launches the policy variant both times. No fallback: on a CUDA tensor
  the kernels run or the call raises.

What follows the scan is PyTorch on the tensors' device, as it is XLA in
the reference. One deliberate difference: the headroom sums are exact
int64 sums returned as float64, where the reference sums in float32 to
dodge int32 overflow (equal within float32 rounding).

Host-side assembly (names, flight-recorder cross-stamp, policy term blame,
preemption candidacy) lives in ``core.explain``.
"""

from __future__ import annotations

import torch

from .oracle import (
    _BIG,
    _BINS,
    _member_capacity,
    _select_best_fit,
    _top_k_ties_by_index,
    left_resources,
)

__all__ = ["explain_gang", "explain_gang_plain", "prefix_leftover", "NEAR_MISS_K"]

# How many near-miss nodes a query ranks and returns: small (the payload
# is human-facing) and below every node bucket's floor.
NEAR_MISS_K = 8


def _policy_fn(policy_cols, policy_terms, policy_weights):
    """``gi -> (pen[N], keep[N])`` of the composed policy terms, or None
    when the batch has no policy (every term off)."""
    if policy_cols is None or not policy_terms:
        return None
    from ..policy.terms import compose_terms

    _, aff, anti, gang_dom, node_hash, node_dom = policy_cols
    pen_fn = compose_terms(tuple(policy_terms), tuple(policy_weights))
    return lambda gi: pen_fn(aff[gi], anti[gi], gang_dom[gi], node_hash, node_dom)


def _capture_scan(left0, group_req, remaining, fit_mask, order, g: int, pen_keep=None):
    """The reference's capture scan: (leftover entering gang ``g``'s step,
    leftover after the whole batch), each step the exact body of the
    plain serial scan (``ops.oracle.assign_gangs``) or, with ``pen_keep``,
    of the plain policy scan (``ops.oracle.assign_gangs_policy``)."""
    left = left0.clone()
    left_entry = left0
    mask_rows = fit_mask.shape[0]
    for gi, need in zip(order.tolist(), remaining[order.long()].tolist()):
        if gi == g:
            left_entry = left.clone()
        req = group_req[gi]
        mask = fit_mask[min(gi, mask_rows - 1)].to(torch.int32)
        cap = _member_capacity(left, req[None, :]) * mask
        key = None
        if pen_keep is not None:
            pen, keep = pen_keep(gi)
            cap = cap * keep
            key = torch.where(cap > 0, (cap.clamp(max=_BINS - 1) + pen).clamp(1, _BINS - 1), 0)
        take, _ = _select_best_fit(cap, cap.clamp(max=need), need, key)
        left -= take[:, None] * req[None, :]
    return left_entry, left


def _scan(left0, group_req, remaining, fit_mask, order, policy):
    """``left_after`` of one serial scan on the tensors' device: the
    serial kernel, or with ``policy`` = (cols, terms, weights) its policy
    variant (both count their launches; looked up at each call, as
    ops.oracle looks them up at each batch)."""
    from . import assign_scan

    if policy is None:
        return assign_scan.assign_gangs_cuda(left0, group_req, remaining, fit_mask, order)[2]
    cols, terms, weights = policy
    return assign_scan.assign_gangs_policy_cuda(left0, group_req, remaining, fit_mask, order,
                                                *cols, terms, weights)[2]


def prefix_leftover(left0, group_req, remaining, fit_mask, order, g: int, policy=None):
    """The leftover the serial scan carries into gang ``g``'s step: one
    scan with ``remaining`` zeroed for every gang at or after ``g``'s
    position in ``order`` (a need-0 step takes nothing). ``order`` must be
    a permutation of [0, G), as the scan wrappers require; ``policy`` is
    ``(cols, terms, weights)`` with at least one term, or None."""
    pos = torch.empty_like(order)
    pos[order.long()] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    masked = torch.where(pos < pos[g], remaining, 0).to(torch.int32)
    return _scan(left0, group_req, masked, fit_mask, order, policy)


def explain_gang_plain(alloc, requested, group_req, remaining, fit_mask, group_valid,
                       order, g: int, n_real: int, policy_cols=None, policy_terms=(),
                       policy_weights=()):
    """``explain_gang`` through the reference's capture scan, step by step,
    on any device (the plain version the kernel route is held against)."""
    g = _gang_index(group_req, g, n_real, alloc)
    pen_keep = _policy_fn(policy_cols, policy_terms, policy_weights)
    left0 = left_resources(alloc, requested)
    left_entry, left_fin = _capture_scan(left0, group_req, remaining, fit_mask, order, g,
                                         pen_keep)
    return _breakdown(left0, left_entry, left_fin, group_req, remaining, fit_mask, g,
                      n_real, pen_keep)


def explain_gang(alloc, requested, group_req, remaining, fit_mask, group_valid, order,
                 g: int, n_real: int, policy_cols=None, policy_terms=(), policy_weights=()):
    """Structured denial breakdown for gang index ``g`` of one batch.

    Inputs are the canonical padded 7-tuple as tensors on one device
    (``ops.convert.BATCH_DTYPES``), the gang index, the REAL node count
    (padded rows are left out of every count), and optionally the six
    packed policy columns with the term config (the policy composite).
    For CUDA tensors the scan runs as two launches of the serial kernel
    (its policy variant for a policy batch: ``prefix_leftover``); for CPU
    tensors ``explain_gang_plain`` runs. Returns a dict of tensors on the
    inputs' device; see ``core.explain.explain_arrays`` for the host
    assembly."""
    if alloc.device.type == "cpu":
        return explain_gang_plain(alloc, requested, group_req, remaining, fit_mask,
                                  group_valid, order, g, n_real, policy_cols,
                                  policy_terms, policy_weights)
    g = _gang_index(group_req, g, n_real, alloc)
    pen_keep = _policy_fn(policy_cols, policy_terms, policy_weights)
    policy = None if pen_keep is None else (
        tuple(policy_cols), tuple(policy_terms), tuple(policy_weights))
    left0 = left_resources(alloc, requested)
    left_entry = prefix_leftover(left0, group_req, remaining, fit_mask, order, g, policy)
    left_fin = _scan(left0, group_req, remaining, fit_mask, order, policy)
    return _breakdown(left0, left_entry, left_fin, group_req, remaining, fit_mask, g,
                      n_real, pen_keep)


def _gang_index(group_req, g, n_real, alloc) -> int:
    """``g`` as an int, checked with ``n_real`` against the batch."""
    g = int(g)
    if not 0 <= g < group_req.shape[0]:
        raise ValueError(f"gang index {g} outside [0, {group_req.shape[0]})")
    if not 0 <= int(n_real) <= alloc.shape[0]:
        raise ValueError(f"n_real={n_real} outside [0, {alloc.shape[0]}]")
    return g


def _breakdown(left0, left_entry, left_fin, group_req, remaining, fit_mask, g: int,
               n_real: int, pen_keep):
    """The breakdown after the scan (the reference's ``:131-202``), on the
    leftovers' device."""
    n = left0.shape[0]
    dev = left0.device
    req = group_req[g]
    mask = fit_mask[min(g, fit_mask.shape[0] - 1)].to(torch.int32)
    need = remaining[g]
    real = torch.arange(n, device=dev) < int(n_real)
    if pen_keep is not None:
        pen, keep = pen_keep(g)
        keep = keep.to(torch.int32)
    else:
        pen = torch.zeros(n, dtype=torch.int32, device=dev)
        keep = torch.ones(n, dtype=torch.int32, device=dev)
    maskk = mask * keep
    cap_entry = _member_capacity(left_entry, req[None, :]) * maskk
    cap_indep = _member_capacity(left0, req[None, :]) * maskk

    # per-lane one-member deficits + the binding lane per blocked node
    demanded = req[None, :] > 0
    lpos = left_entry.clamp(0, _BIG)
    per_lane = torch.where(
        demanded, torch.div(lpos, req.clamp(1, _BIG)[None, :], rounding_mode="floor"), _BIG
    )  # [N, R] members each lane alone would allow
    deficit = torch.where(demanded, (req[None, :] - left_entry).clamp(0, _BIG), 0)
    block_lane = torch.argmin(per_lane, dim=1)  # first minimum, as jnp.argmin
    blocked = real & (maskk > 0) & (cap_entry == 0)
    lane_iota = torch.arange(req.shape[0], device=dev)
    binding_counts = (blocked[:, None] & (block_lane[:, None] == lane_iota[None, :])).sum(
        dim=0, dtype=torch.int64)  # [R] blocked nodes per binding lane

    def count(b):
        return b.sum(dtype=torch.int64)

    need64 = need.to(torch.int64)
    out = {
        "need": need,
        "feasible_entry": (torch.minimum(cap_entry, need) * real).sum(dtype=torch.int64) >= need64,
        "feasible_indep": (torch.minimum(cap_indep, need) * real).sum(dtype=torch.int64) >= need64,
        "nodes_entry": count(real & (cap_entry > 0)),
        "nodes_indep": count(real & (cap_indep > 0)),
        "masked_out": count(real & (mask == 0)),
        "policy_masked": count(real & (mask > 0) & (keep == 0)),
        "capacity_blocked": count(blocked),
        "binding_counts": binding_counts,
    }

    # near-miss ranking: best entry capacity first, then smallest total
    # deficit; the composite stays inside int32 (capacity term < 2**7 *
    # 2**23, deficit term < 2**22), computed in int64 with the same order
    total_deficit = deficit.to(torch.int64).clamp(max=2**18).sum(dim=1)
    score = torch.where(
        real & (maskk > 0),
        cap_entry.to(torch.int64).clamp(max=_BINS - 1) * 2**23
        - total_deficit.clamp(max=2**22 - 1),
        -(2**30),
    )
    k = min(NEAR_MISS_K, n)
    _, near = _top_k_ties_by_index(score[None, :], k)
    near_idx = near[0]
    near_long = near_idx.long()
    out.update(
        near_idx=near_idx,
        near_cap=cap_entry[near_long],
        near_cap_indep=cap_indep[near_long],
        near_deficit=deficit[near_long],
        near_left=lpos[near_long],
        near_pen=pen[near_long],
    )
    # per-lane cluster headroom at the gang's entry and after the batch:
    # exact int64 sums (the reference's float32 sums round), as float
    real64 = real.to(torch.int64)[:, None]
    out["headroom_entry"] = (lpos.to(torch.int64) * real64).sum(dim=0).to(torch.float64)
    out["headroom_after"] = (
        left_fin.clamp(0, _BIG).to(torch.int64) * real64
    ).sum(dim=0).to(torch.float64)
    return out
