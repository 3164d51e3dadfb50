"""The bin-packing oracle in PyTorch: one batch scores all PodGroups × all
nodes and places whole gangs greedily in queue order.

The port of ``batch_scheduler_tpu/ops/oracle.py`` (the single-device
batch). Plain functions on int32 tensors:

- ``left_resources``  per-node leftover = floor(alloc·percent) − requested
- ``group_capacity``  members-per-node capacity matrix cap[G,N]
- ``gang_feasible``   Σ_n min(cap, remaining) ≥ remaining
- ``score_nodes``     per-(group,node) best-fit ranks for Score
- ``find_max_group``  vectorized findMaxPG with the reference's tie-break
- ``assign_gangs``    the plain serial gang scan (a Python loop over the
                      scan order); on a CUDA tensor ``schedule_batch`` runs
                      the hand-written kernel instead
                      (``ops.assign_scan.assign_gangs_cuda``)
- ``assign_gangs_wavefront``  the plain wavefront scan, bit-identical to
                      the serial one, a wave of gangs at a time; selected
                      by ``BST_SCAN_WAVE``, and on a CUDA tensor run by
                      ``ops.assign_scan.assign_gangs_wave_cuda``
- ``assign_gangs_policy``  the plain serial scan with each gang's selection
                      key shifted by the policy terms (``policy.terms``);
                      a batch with a policy runs it and no other scan, on a
                      CUDA tensor as the composite-key kernel
                      (``ops.assign_scan.assign_gangs_policy_cuda``)
- ``dispatch_batch`` / ``collect_batch``  one batch enqueued with its
                      blob's copy to pinned host memory started, and the
                      wait and decode; ``execute_batch_host`` runs the two
- ``find_max_group_host`` / ``repack_assignment_span``  numpy twins the
                      sidecar coalescer's mega demux uses to give each
                      tenant the ``best`` and compact rows its own
                      dedicated batch would have

Every output keeps the JAX reference's dtype (int32 counts, bool flags).
Sums are taken in int64 where torch widens; the reference's batch boundary
(``ops.bucketing.pad_oracle_batch``: LANE_MAX, the gang bound) keeps every
one of them inside int32, so the values are the reference's.
"""

from __future__ import annotations

import functools
import os
import sys
import threading

import numpy as np
import torch

from ..utils.metrics import DEFAULT_REGISTRY
from ..utils.tenancy import current_batch_tenant
from .bucketing import wave_width_bucket
from .convert import batch_from_numpy, policy_from_numpy, resolve_device

__all__ = [
    "left_resources",
    "group_capacity",
    "gang_feasible",
    "find_max_group",
    "score_nodes",
    "assign_gangs",
    "assign_gangs_wavefront",
    "assign_gangs_policy",
    "schedule_batch",
    "batch_top_k",
    "find_max_group_host",
    "repack_assignment_span",
    "PendingBatch",
    "dispatch_batch",
    "collect_batch",
    "execute_batch_host",
    "inflight_batches",
    "forced_scan_rung",
    "ASSIGNMENT_TOP_K",
    "GANG_MAX",
]

_BIG = 2**30

# Largest admissible gang: keeps every need-clipped capacity sum in the
# assignment scan exact in int32. Enforced at the batch boundary
# (ops.bucketing.pad_oracle_batch).
GANG_MAX = 2**18

# Best-fit ranking buckets for the gang-placement scan. Nodes are ranked
# tightest-first by min(cap, _BINS-1); all nodes that could hold >= _BINS-1
# members of a gang are equally "loose" and tie-break by node index.
_BINS = 128

# Max distinct nodes one gang's compact assignment can report.
ASSIGNMENT_TOP_K = 128


def _member_capacity(left, req):
    """min over resource lanes of floor(left/req), for req-positive lanes —
    how many members of a demand row fit in a leftover row. ``left`` and
    ``req`` broadcast to a common [..., R]. Inputs are clamped into the
    reference's division domain (``_BIG`` saturates only values already
    rejected at the batch boundary)."""
    safe_req = req.clamp(1, _BIG)
    lpos = left.clamp(0, _BIG)
    per_lane = torch.where(
        req > 0, torch.div(lpos, safe_req, rounding_mode="floor"), _BIG
    )
    return per_lane.amin(dim=-1)


def left_resources(alloc, requested):
    """Per-node leftover lanes: alloc − requested (the batch admits at 100%
    of allocatable; the reference's percent argument has no caller here)."""
    return alloc - requested


def group_capacity(left, group_req, fit_mask):
    """cap[G,N]: how many members of group g fit on node n's leftover,
    masked by per-(group,node) placement feasibility. A running minimum
    over the R lanes keeps every temporary at [G,N] (the [G,N,R] broadcast
    the reference leaves to XLA's fusion would be 168 MB per temporary at
    the 1024 x 8192 x 5 north-star shape)."""
    g, n = group_req.shape[0], left.shape[0]
    cap = torch.full((g, n), _BIG, dtype=torch.int32, device=left.device)
    lpos = left.clamp(0, _BIG)
    for r in range(left.shape[1]):
        req = group_req[:, r:r + 1]  # [G, 1]
        lane = torch.div(
            lpos[None, :, r], req.clamp(1, _BIG), rounding_mode="floor"
        )
        torch.minimum(cap, torch.where(req > 0, lane, _BIG), out=cap)
    return cap * fit_mask.to(torch.int32)


def gang_feasible(cap, remaining, group_valid):
    """ok[G]: total member capacity across the cluster covers the gang's
    still-unbound members (per-node capacity clipped at the gang's need)."""
    total = torch.minimum(cap, remaining[:, None]).sum(dim=1)
    return (total >= remaining) & group_valid


def find_max_group(min_member, scheduled, matched, ineligible, creation_rank):
    """Vectorized findMaxPG (reference core.go:701-739).

    progress = (matched + scheduled)·1000 // min_member for groups that
    still need members, clipped to [0, 2047]. Tie-break: prefer groups with
    scheduled == 0, then earlier creation rank. Returns (best_index int32,
    best_exists bool, progress[G] int32)."""
    g = min_member.shape[0]
    needs = (min_member - scheduled) > 0
    denom = min_member.clamp(min=1)
    progress = torch.where(
        needs,
        torch.div((matched + scheduled) * 1000, denom, rounding_mode="floor"),
        0,
    ).clamp(0, 2047).to(torch.int32)
    key = (
        progress * (2 * g + 2)
        + torch.where(scheduled == 0, g + 1, 0)
        + (g - creation_rank)
    )
    key = torch.where(~ineligible, key, -1)
    best = torch.argmax(key)  # first occurrence of the maximum
    return best.to(torch.int32), key[best] >= 0, progress


def find_max_group_host(min_member, scheduled, matched, ineligible,
                        creation_rank):
    """Host-side numpy twin of ``find_max_group`` — same formula, same
    tie-break, same argmax-first-occurrence semantics — used by the
    coalescer demux (service.coalescer): a merged mega-batch's device
    ``best`` ranges over EVERY tenant's gangs, but each tenant's response
    must carry the best of ITS OWN padded span, computed from pure inputs
    (the progress args are untouched by the scan). Feed it the tenant's
    own padded progress args and the answer is bit-identical to what a
    dedicated sidecar's device pass would have stamped. int32 stays exact:
    progress <= 2047 and g <= GANG_MAX keep the key below 2**31."""
    min_member = np.asarray(min_member)
    scheduled = np.asarray(scheduled)
    g = int(min_member.shape[0])
    needs = (min_member - scheduled) > 0
    denom = np.maximum(min_member, 1)
    progress = np.where(
        needs, (np.asarray(matched) + scheduled) * 1000 // denom, 0
    )
    progress = np.clip(progress, 0, 2047)
    eligible = ~np.asarray(ineligible)
    key = (
        progress.astype(np.int32) * (2 * g + 2)
        + np.where(scheduled == 0, g + 1, 0)
        + (g - np.asarray(creation_rank).astype(np.int32))
    )
    key = np.where(eligible, key, -1)
    best = int(np.argmax(key))
    return best, bool(key[best] >= 0), progress.astype(np.int32)


def repack_assignment_span(nodes_row, counts_row, node_offset: int,
                           span_n_bucket: int, k: int):
    """Re-derive ONE gang's dedicated-sidecar compact assignment row from
    its mega-batch row (service.coalescer demux).

    The compact readback is the top-k of the gang's take vector
    (``_top_k_ties_by_index``): entries sorted by (count desc, node index
    asc), and the zero-count tail is therefore the ASCENDING node indices
    not holding a take. In the block-diagonal mega-batch the positive
    takes can only land in the gang's own node block (every other block is
    masked to zero capacity), and their relative order under the global
    index tie-break equals the dedicated run's local order — so the
    dedicated row is exactly: the in-block positive entries shifted by
    ``-node_offset`` (truncated to ``k``), then ascending free indices over
    the tenant's own ``[0, span_n_bucket)`` padded space. ``k`` is the
    dedicated batch's ``batch_top_k(span_n_bucket, span_remaining_max)`` —
    compute it from the tenant's OWN padded args, exactly as
    dispatch_batch would. Returns ``(nodes[k] int32, counts[k] int32)``."""
    nodes_row = np.asarray(nodes_row)
    counts_row = np.asarray(counts_row)
    pos = counts_row > 0
    real_nodes = (nodes_row[pos] - node_offset).astype(np.int32)[:k]
    real_counts = counts_row[pos].astype(np.int32)[:k]
    out_nodes = np.zeros(k, dtype=np.int32)
    out_counts = np.zeros(k, dtype=np.int32)
    m = real_nodes.shape[0]
    out_nodes[:m] = real_nodes
    out_counts[:m] = real_counts
    if m < k:
        # the ascending free-index tail, vectorized: this runs once per
        # gang on the coalescer's one worker thread
        free = np.ones(span_n_bucket, dtype=bool)
        free[real_nodes] = False
        fill = np.flatnonzero(free)[: k - m]
        out_nodes[m:m + fill.shape[0]] = fill
    return out_nodes, out_counts


def score_nodes(cap):
    """score[G,N] for the Score extension point: nodes that fit at least
    one member rank by tightness (higher is better); the rest score
    -2**30."""
    return torch.where(cap > 0, _BIG - cap, -_BIG)


def _select_best_fit(cap, capc, need: int, key=None):
    """Tightest-first take vector for one gang (1-D over nodes): the
    histogram threshold selection of the reference's ``_select_best_fit``.
    ``key`` overrides the selection bucket per node (the policy scan's
    composite); an override keeps key 0 exactly where capacity is 0, so
    the threshold and remainder formulas hold unchanged. Returns (take[N]
    int32, feasible bool tensor)."""
    capc64 = capc.to(torch.int64)
    feasible = capc64.sum() >= need
    if key is None:
        key = cap.clamp(max=_BINS - 1)  # tightness bucket (0 = no fit)
    key = key.to(torch.int64)
    bin_totals = torch.zeros(_BINS, dtype=torch.int64, device=cap.device)
    bin_totals.scatter_add_(0, key, capc64)
    cum_bins = bin_totals.cumsum(0)
    # threshold bucket: first where cumulative capacity covers the gang
    thresh = (cum_bins < need).sum().clamp(max=_BINS - 1)
    rem_t = need - (cum_bins[thresh] - bin_totals[thresh])
    in_t = key == thresh
    capc_t = torch.where(in_t, capc64, 0)
    prefix_t = capc_t.cumsum(0) - capc_t
    take = torch.where(
        key < thresh,
        capc64,
        torch.where(in_t, torch.minimum((rem_t - prefix_t).clamp(min=0), capc64), 0),
    )
    return (take * feasible).to(torch.int32), feasible


def assign_gangs(left0, group_req, remaining, fit_mask, order):
    """Greedy whole-batch gang placement, the plain serial form.

    Walks groups in ``order`` (the queue-sort order) carrying the live
    leftover lanes; each step places all of a gang's remaining members at
    once on the tightest-fitting nodes iff the whole gang fits. Returns
    alloc[G,N] int32 (rows in group index space), placed[G] bool and
    left[N,R] int32 after all placements. ``fit_mask`` is ``[G,N]`` or a
    broadcast ``[1,N]`` row. This is the reference the CUDA kernel
    (``ops.assign_scan``) is held against."""
    n = left0.shape[0]
    g = group_req.shape[0]
    idx = order.long()
    mask = fit_mask.to(torch.int32)
    mask = mask[idx] if fit_mask.shape[0] != 1 else mask.expand(g, n)
    # one host read of the needs, not one per step
    takes, feas, left = _serial_steps(left0, group_req[idx], remaining[idx].tolist(), mask)
    alloc = torch.zeros((g, n), dtype=torch.int32, device=left0.device)
    placed = torch.zeros(g, dtype=torch.bool, device=left0.device)
    alloc[idx] = takes
    placed[idx] = feas
    return alloc, placed, left


def _serial_steps(left, req_rows, needs, mask_rows):
    """The serial scan body over gangs already in scan order (demand rows,
    needs and mask rows): (takes[K,N], feasible[K], leftover after)."""
    left = left.clone()
    takes = torch.zeros((len(needs), left.shape[0]), dtype=torch.int32, device=left.device)
    feas = torch.zeros(len(needs), dtype=torch.bool, device=left.device)
    for j, need in enumerate(needs):
        cap = _member_capacity(left, req_rows[j][None, :]) * mask_rows[j]
        take, feas[j] = _select_best_fit(cap, cap.clamp(max=need), need)
        left -= take[:, None] * req_rows[j][None, :]
        takes[j] = take
    return takes, feas, left


def assign_gangs_policy(left0, group_req, remaining, fit_mask, order, prio, aff, anti,
                        gang_dom, node_hash, node_dom, policy_terms=(), policy_weights=()):
    """Policy-composite form of ``assign_gangs``: the same scan and outputs,
    with each gang's selection bucket shifted by the composed policy terms
    (``policy.terms.compose_terms``):

    - soft penalties (affinity miss, spread-domain occupancy) ADD to the
      tightness bucket, clipped into [1, 127]: penalized nodes are
      consumed later but never excluded, and ties inside a bucket still go
      in node order;
    - hard masks (anti-affinity) multiply into the capacity row like the
      fit mask.

    ``prio`` is part of the columns but not of the scan (queue order
    already holds it). With every term disabled, or all-zero columns, the
    result equals ``assign_gangs``. The port of the reference's
    ``assign_gangs_policy`` and the plain version of the composite-key
    kernel (``ops.assign_scan.assign_gangs_policy_cuda``)."""
    from ..policy.terms import compose_terms

    pen_fn = compose_terms(tuple(policy_terms), tuple(policy_weights))
    n = left0.shape[0]
    g = group_req.shape[0]
    idx = order.long()
    mask = fit_mask.to(torch.int32)
    mask = mask[idx] if fit_mask.shape[0] != 1 else mask.expand(g, n)
    req_rows, aff_o, anti_o, dom_o = group_req[idx], aff[idx], anti[idx], gang_dom[idx]
    left = left0.clone()
    takes = torch.zeros((g, n), dtype=torch.int32, device=left0.device)
    feas = torch.zeros(g, dtype=torch.bool, device=left0.device)
    for j, need in enumerate(remaining[idx].tolist()):
        pen, keep = pen_fn(aff_o[j], anti_o[j], dom_o[j], node_hash, node_dom)
        cap = _member_capacity(left, req_rows[j][None, :]) * mask[j] * keep
        key = torch.where(cap > 0, (cap.clamp(max=_BINS - 1) + pen).clamp(1, _BINS - 1), 0)
        take, feas[j] = _select_best_fit(cap, cap.clamp(max=need), need, key)
        left -= take[:, None] * req_rows[j][None, :]
        takes[j] = take
    alloc = torch.zeros((g, n), dtype=torch.int32, device=left0.device)
    placed = torch.zeros(g, dtype=torch.bool, device=left0.device)
    alloc[idx] = takes
    placed[idx] = feas
    return alloc, placed, left


def _uniform_wave(left, req0, need_c, mask0):
    """One aggregate tightest-first fill for a wave of gangs with identical
    demand and mask rows, split at the gang boundaries that hold when every
    gang is feasible. Returns (takes[W,N], left) when that assumption
    holds for every gang, else None (the caller replays the wave).

    Taking t members off a node drops its capacity by exactly t for an
    identical demand row, so the serial gang-by-gang fill is one member
    stream ordered by (tightness bucket, node index): gang j takes stream
    units [A_j, A_j + need_j) with A_j the sum of earlier needs. Node order
    within a bucket is resolved only for the <= W+1 buckets that hold a
    boundary A_j."""
    total_need = sum(need_c)
    cap0 = _member_capacity(left, req0[None, :]) * mask0
    key = cap0.clamp(max=_BINS - 1).long()
    capc = cap0.clamp(max=total_need).long()  # stream units per node
    bin_totals = torch.zeros(_BINS, dtype=torch.int64, device=left.device)
    bin_totals.scatter_add_(0, key, capc)
    cum_incl = bin_totals.cumsum(0)
    cum_excl = cum_incl - bin_totals
    bounds = torch.tensor(np.concatenate([[0], np.cumsum(need_c)]),
                          dtype=torch.int64, device=left.device)  # [W+1]
    # bucket holding each boundary (_BINS when past the last one)
    bbkt = (cum_incl[None, :] <= bounds[:, None]).sum(dim=1)
    bmask = key[None, :] == bbkt[:, None]  # [W+1, N]
    bvals = torch.where(bmask, capc[None, :], 0)
    bwithin = bvals.cumsum(dim=1) - bvals
    boffs = (bounds - cum_excl[bbkt.clamp(max=_BINS - 1)])[:, None]
    # taken[j, n]: units of node n inside the first A_j stream units
    taken = torch.where(
        key[None, :] < bbkt[:, None],
        capc[None, :],
        torch.where(bmask, torch.minimum((boffs - bwithin).clamp(min=0), capc[None, :]), 0),
    )
    need_t = bounds.diff()
    feas = torch.minimum(cap0.long()[None, :] - taken[:-1], need_t[:, None]).sum(dim=1) >= need_t
    if not bool(feas.all()):
        return None
    takes = (taken[1:] - taken[:-1]).to(torch.int32)
    return takes, left - taken[-1].to(torch.int32)[:, None] * req0[None, :]


def _speculative_wave(left, req_c, need_c, mask_c):
    """Every gang selects against the wave-start leftover; the wave
    commits only if each gang's capacity row is unchanged under the
    exclusive prefix of the earlier gangs' takes (then the takes are the
    serial ones). Returns (takes, feasible, left) or None on a conflict.

    The prefix leftover is accumulated with a clamp at -2**30: one wave's
    delta on a lane is at most the wave-start value (<= 2**30), so a
    clamped subtraction cannot wrap int32, and a clamped negative lane has
    capacity 0 as its true value would. Without a conflict no clamp
    fires, so the accumulated leftover is the serial one."""
    cap = _member_capacity(left[None, :, :], req_c[:, None, :]) * mask_c
    takes, feas = [], []
    for j, need in enumerate(need_c):
        take, f = _select_best_fit(cap[j], cap[j].clamp(max=need), need)
        takes.append(take)
        feas.append(f)
    takes = torch.stack(takes)
    acc = left
    prefixed = []
    for j in range(len(need_c)):
        prefixed.append(acc)
        acc = torch.clamp(acc - takes[j][:, None] * req_c[j][None, :], min=-_BIG)
    cap_pref = _member_capacity(torch.stack(prefixed), req_c[:, None, :]) * mask_c
    if bool((cap_pref != cap).any()):
        return None
    return takes, torch.stack(feas), acc


def assign_gangs_wavefront(left0, group_req, remaining, fit_mask, order,
                           wave: int = 8, with_stats: bool = False):
    """Wavefront form of ``assign_gangs``: the same outputs bit for bit,
    placed one wave of ``wave`` consecutive gangs (in scan order) at a
    time. The plain version of ``csrc/assign_wave.cu`` and the port of the
    reference's ``assign_gangs_wavefront``, with its three branches:

    1. uniform: a wave whose gangs share one demand row and one mask row
       (and whose needs keep the stream positions inside int32) takes one
       aggregate fill (``_uniform_wave``); if a gang would be infeasible
       at its assumed boundary the wave is replayed serially;
    2. speculative: otherwise every gang selects against the wave-start
       leftover, and a conflict check commits or replays the wave
       (``_speculative_wave``);
    3. replay: the serial scan body over the wave.

    The group axis is padded to a wave multiple with inert positions (no
    demand, need 0, masked out) that run after every real gang.
    ``with_stats`` also returns ``(conflicts[S], megas[S])`` over the
    S = ceil(G/W) waves: waves replayed serially, and waves that took the
    uniform branch (committed or replayed)."""
    n, r = left0.shape
    g = group_req.shape[0]
    w = max(int(wave), 1)
    per_group = fit_mask.shape[0] != 1
    steps = -(-g // w)
    pad = steps * w - g
    dev = left0.device
    idx = order.long()
    gr = torch.cat([group_req[idx], group_req.new_zeros((pad, r))])
    needs = remaining[idx].tolist() + [0] * pad
    mask = fit_mask.to(torch.int32)
    if per_group:
        mask = torch.cat([mask[idx], mask.new_zeros((pad, n))])
    # stream positions of the uniform branch stay exact in int32 only
    # while total_need * N does
    mega_need_max = (2**31 - 1) // max(n, 1)
    left = left0.clone()
    takes = torch.zeros((steps * w, n), dtype=torch.int32, device=dev)
    feas = torch.zeros(steps * w, dtype=torch.bool, device=dev)
    conflicts = torch.zeros(steps, dtype=torch.bool, device=dev)
    megas = torch.zeros(steps, dtype=torch.bool, device=dev)
    ones = torch.ones(w, dtype=torch.bool, device=dev)
    for s in range(steps):
        lo, hi = s * w, (s + 1) * w
        req_c, need_c = gr[lo:hi], needs[lo:hi]
        mask_c = mask[lo:hi] if per_group else mask.expand(w, n)
        uniform = bool((req_c == req_c[0:1]).all())
        if per_group and uniform:
            uniform = bool((mask_c == mask_c[0:1]).all())
        mega = uniform and sum(need_c) <= mega_need_max
        done = (_uniform_wave(left, req_c[0], need_c, mask_c[0]) if mega
                else _speculative_wave(left, req_c, need_c, mask_c))
        if done is None:
            wave_takes, wave_feas, left = _serial_steps(left, req_c, need_c, mask_c)
            conflicts[s] = True
        elif mega:
            (wave_takes, left), wave_feas = done, ones
        else:
            wave_takes, wave_feas, left = done
        takes[lo:hi] = wave_takes
        feas[lo:hi] = wave_feas
        megas[s] = mega
    alloc = torch.zeros((g, n), dtype=torch.int32, device=dev)
    placed = torch.zeros(g, dtype=torch.bool, device=dev)
    alloc[idx] = takes[:g]
    placed[idx] = feas[:g]
    if with_stats:
        return alloc, placed, left, (conflicts, megas)
    return alloc, placed, left


def _top_k_ties_by_index(assignment, k: int):
    """(counts, nodes) of the k largest entries per row, ties in ascending
    node order — what the reference's ``lax.top_k`` returns (the decode and
    the plan depend on that order; ``torch.topk`` promises none)."""
    counts, nodes = torch.sort(assignment, dim=1, descending=True, stable=True)
    return counts[:, :k], nodes[:, :k].to(torch.int32)


_WAVE_ENV = "BST_SCAN_WAVE"


@functools.lru_cache(maxsize=None)
def _warn_unparseable_wave(raw: str) -> None:
    print(f"ignoring unparseable {_WAVE_ENV}={raw!r}; using the serial "
          "assignment scan", file=sys.stderr)


def _scan_wave_from_env() -> int:
    """The wave width ``BST_SCAN_WAVE`` asks for: unset, 0 or 1 is the
    serial scan (0); anything else is bucketed by ``wave_width_bucket``.
    An unparseable value is the serial scan, with one warning on stderr
    per distinct value."""
    raw = os.environ.get(_WAVE_ENV, "")
    if not raw:
        return 0
    try:
        requested = int(raw)
    except ValueError:
        _warn_unparseable_wave(raw)
        return 0
    return wave_width_bucket(requested)


# Thread-local scan-rung pin for deterministic replay
# (core.oracle_scorer.replay_batch) and the identity audit
# (utils.health.IdentityAuditor): forces this thread's dispatch_batch onto
# one wave width without touching the environment, so a replay on one
# thread never changes the rung a serving thread runs.
_rung_override = threading.local()


class forced_scan_rung:
    """Context manager pinning this thread's batches to one scan rung:
    ``scan_wave`` 0 is the serial scan, a width > 1 the wavefront scan at
    that width (already bucketed). While the pin is set ``dispatch_batch``
    reads it in place of ``BST_SCAN_WAVE``. The reference's ``use_pallas``
    half of the pin has no counterpart: on a CUDA tensor the kernel always
    runs."""

    def __init__(self, scan_wave: int):
        self._wave = int(scan_wave)

    def __enter__(self):
        self._prev = getattr(_rung_override, "value", None)
        _rung_override.value = self._wave
        return self

    def __exit__(self, *exc):
        _rung_override.value = self._prev
        return False


def schedule_batch(alloc_lanes, requested, group_req, remaining, fit_mask,
                   group_valid, order, top_k: int = ASSIGNMENT_TOP_K,
                   scan_wave: int = 0, policy=None):
    """The full-batch oracle: leftover -> capacity -> feasibility -> scores
    -> greedy gang assignment -> compact top-K readback. ``scan_wave`` > 1
    runs the wavefront scan at that width and adds its per-wave
    ``wave_conflicts``/``wave_megas`` flags to the output; otherwise the
    serial scan runs. ``policy`` = ``(policy_cols, terms, weights)`` (the
    six column tensors) with at least one term runs the policy scan
    instead of either, and folds the hard-mask terms into the capacity
    matrix, so feasibility and scores agree with what the scan refuses
    (the caller, ``dispatch_batch``, has already set ``scan_wave`` to 0).
    Every scan runs its hand-written CUDA kernel for CUDA tensors and its
    plain version for CPU tensors (the wrappers in ``ops.assign_scan``
    decide by device)."""
    from .assign_scan import assign_gangs_cuda, assign_gangs_policy_cuda, assign_gangs_wave_cuda

    policy_on = policy is not None and bool(policy[1])
    left = left_resources(alloc_lanes, requested)
    cap = group_capacity(left, group_req, fit_mask)
    if policy_on:
        from ..policy.terms import compose_keep_dense

        cols, terms, weights = policy
        cap = cap * compose_keep_dense(terms, cols[2], cols[4])
    feasible = gang_feasible(cap, remaining, group_valid)
    scores = score_nodes(cap)
    wave_stats = None
    if policy_on:
        assignment, placed, left_after = assign_gangs_policy_cuda(
            left, group_req, remaining, fit_mask, order, *cols, terms, weights
        )
    elif scan_wave > 1:
        assignment, placed, left_after, wave_stats = assign_gangs_wave_cuda(
            left, group_req, remaining, fit_mask, order, scan_wave
        )
    else:
        assignment, placed, left_after = assign_gangs_cuda(
            left, group_req, remaining, fit_mask, order
        )
    placed = placed & group_valid
    k = min(top_k, assignment.shape[1])
    assign_counts, assign_nodes = _top_k_ties_by_index(assignment, k)
    out = {
        "left": left,
        "capacity": cap,
        "gang_feasible": feasible,
        "scores": scores,
        "assignment": assignment,
        "assignment_nodes": assign_nodes,
        "assignment_counts": assign_counts,
        "placed": placed,
        "left_after": left_after,
    }
    if wave_stats is not None:
        out["wave_conflicts"], out["wave_megas"] = wave_stats
    if assignment.shape[1] <= 2**15:
        # compact fetch: (node << 16 | count), counts saturating at 65535
        out["assignment_packed"] = (
            assign_nodes * (2**16) + assign_counts.clamp(max=2**16 - 1)
        )
    return out


def batch_top_k(n_bucket: int, remaining_max: int) -> int:
    """Top-K width of a batch's compact assignment readback: a gang's take
    touches at most ``remaining`` nodes, so the batch-wide max bounds the
    useful width; rounded up to a power of two and floored at 16 (the
    reference's widths, so the readbacks compare slot for slot)."""
    return min(
        ASSIGNMENT_TOP_K,
        n_bucket,
        max(16, 1 << (max(remaining_max, 1) - 1).bit_length()),
    )


def _batch_blob(alloc_lanes, requested, group_req, remaining, fit_mask,
                group_valid, order, min_member, scheduled, matched,
                ineligible, creation_rank, pack_assignment: bool = True,
                top_k: int = ASSIGNMENT_TOP_K, scan_wave: int = 0, policy=None):
    """The batch plus findMaxPG, with every O(G) host-needed output
    concatenated into one int32 blob (one device-to-host copy).

    Blob layout (G = group bucket, K = top-K), the reference's:
      [0:G)        placed (0/1)
      [G:2G)       gang_feasible (0/1)
      [2G:3G)      progress
      [3G]         best group index
      [3G+1]       best_exists (0/1)
      [3G+2:...]   assignment top-K: packed (node<<16|count), G*K — or,
                   when ``pack_assignment=False``, nodes then counts, 2*G*K
      [tail]       only when the wavefront scan ran (``scan_wave`` > 1):
                   3 ints — waves, waves replayed serially, waves that
                   took the uniform branch
    """
    out = schedule_batch(alloc_lanes, requested, group_req, remaining,
                         fit_mask, group_valid, order, top_k=top_k,
                         scan_wave=scan_wave, policy=policy)
    best, exists, progress = find_max_group(
        min_member, scheduled, matched, ineligible, creation_rank
    )
    if pack_assignment:
        tail = out["assignment_packed"].reshape(-1)
    else:
        tail = torch.cat([out["assignment_nodes"].reshape(-1),
                          out["assignment_counts"].reshape(-1)])
    parts = [
        out["placed"].to(torch.int32),
        out["gang_feasible"].to(torch.int32),
        progress,
        torch.stack([best, exists.to(torch.int32)]),
        tail.to(torch.int32),
    ]
    if "wave_conflicts" in out:
        conflicts, megas = out["wave_conflicts"], out["wave_megas"]
        parts.append(torch.stack([
            # a fill on the device: a host tensor here would be a pageable
            # copy, which waits for the stream (the whole scan)
            conflicts.new_full((), conflicts.shape[0], dtype=torch.int32),
            conflicts.sum(dtype=torch.int32),
            megas.sum(dtype=torch.int32),
        ]))
    return torch.cat(parts), out


# Batches dispatched and not yet collected, process-wide (the reference's
# _note_inflight, with its gauge).
_inflight_lock = threading.Lock()
_inflight_count = 0  # guarded-by: _inflight_lock


def _note_inflight(delta: int) -> None:
    global _inflight_count
    with _inflight_lock:
        _inflight_count += delta
        count = _inflight_count
    DEFAULT_REGISTRY.gauge(
        "bst_oracle_inflight_batches",
        "Fused oracle batches dispatched to the device and not yet "
        "collected (>1 means the pipeline is overlapping batches)",
    ).set(float(count))


def inflight_batches() -> int:
    """Batches dispatched by ``dispatch_batch`` and not yet collected."""
    with _inflight_lock:
        return _inflight_count


class PendingBatch:
    """An in-flight batch: enqueued on the device, the blob's copy to the
    host started, not waited for. ``dispatch_batch`` makes one;
    ``collect_batch`` is the sync point. Holding one while the host does
    other work (packing the next snapshot, admission bookkeeping, sleeping
    out a tick interval) overlaps that work with the batch.

    On CUDA ``blob`` is a pinned host tensor that a non-blocking copy is
    filling and ``done`` the event recorded after that copy; on the CPU
    ``blob`` is the finished blob and ``done`` is None."""

    __slots__ = ("blob", "done", "out", "pack", "top_k", "scan_wave", "mask_mode",
                 "n_bucket", "g_bucket", "device", "used_policy")

    def __init__(self, blob, done, out, pack, top_k, scan_wave, mask_mode,
                 n_bucket, g_bucket, device, used_policy=False):
        self.blob = blob
        self.done = done
        self.out = out
        self.pack = pack
        self.top_k = top_k
        self.scan_wave = scan_wave
        self.mask_mode = mask_mode
        self.n_bucket = n_bucket
        self.g_bucket = g_bucket
        self.device = device
        self.used_policy = used_policy


def dispatch_batch(batch_args, progress_args, device="cuda", policy=None) -> PendingBatch:
    """Enqueue one batch + max-progress selection on ``device`` and start
    the copy of its O(G) blob to the host WITHOUT waiting for either.
    Takes the packed numpy batch (``ClusterSnapshot.device_args()`` /
    ``progress_args()``); any of its arrays may instead be a tensor already
    on ``device`` (the resident state of ``ops.device_state``), which the
    batch reads in place.

    Everything goes on the calling thread's current stream of ``device``:
    the small arrays' uploads, the batch, both scan kernels' launches, the
    blob's copy into pinned host memory (``Tensor.to("cpu",
    non_blocking=True)`` takes it from PyTorch's caching host allocator;
    a pageable copy would wait for the stream) and the event ``collect_batch``
    waits on. A caller that owns a stream enters it around this call and
    around every other operation on the tensors it hands in (the scorers
    do: ``torch.cuda.stream(...)``), so no batch reads a buffer that a later
    scatter on another stream could overtake.

    ``BST_SCAN_WAVE`` is read once per batch, unless this thread's
    ``forced_scan_rung`` pin is set: a width > 1 runs the wavefront
    scan.

    ``policy`` = ``(policy_cols, terms, weights)``
    (``ClusterSnapshot.policy_payload()``; the columns host numpy or, for
    the node columns, the holder's resident tensors) runs the policy scan:
    the wave width is 0 for the batch whatever ``BST_SCAN_WAVE`` or a pin
    says (the wavefront's uniform and speculative branches assume a key
    that depends on capacity alone), and on CUDA the composite-key kernel
    runs or the batch raises; there is no fallback to another scan."""
    dev = resolve_device(device)
    scan_wave = getattr(_rung_override, "value", None)
    if scan_wave is None:
        scan_wave = _scan_wave_from_env()
    if policy is not None:
        cols, terms, weights = policy
        policy = (policy_from_numpy(cols, dev), tuple(terms), tuple(weights))
        scan_wave = 0
    # np.shape reads a tensor's own shape (a CUDA tensor is never copied)
    mask_mode = "per_group" if np.shape(batch_args[4])[0] != 1 else "broadcast"
    n_bucket = int(np.shape(batch_args[0])[0])
    g_bucket = int(np.shape(batch_args[2])[0])
    remaining_max = int(np.asarray(batch_args[3]).max(initial=0))
    # The packed form saturates per-node counts at 65535 and shifts node
    # indices by 16 bits: gate it on both bounds (the reference's gate), so
    # the decode matches.
    pack = n_bucket <= 2**15 and remaining_max <= 2**16 - 1
    top_k = batch_top_k(n_bucket, remaining_max)
    batch, progress = batch_from_numpy(batch_args, progress_args, dev)
    blob, out = _batch_blob(*batch, *progress, pack_assignment=pack,
                            top_k=top_k, scan_wave=scan_wave, policy=policy)
    done = None
    if dev.type == "cuda":
        blob = blob.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    _note_inflight(1)
    return PendingBatch(blob, done, out, pack, top_k, scan_wave, mask_mode,
                        n_bucket, g_bucket, dev, used_policy=policy is not None)


def collect_batch(pending: PendingBatch):
    """The sync point of a ``dispatch_batch``: wait for the blob's copy,
    decode the O(G) host vectors, and hand back the [G,N] device tensors.

    Returns ``(host, device_result)``: ``host`` is the reference's host
    dict (``placed``, ``gang_feasible``, ``progress``, ``best``,
    ``best_exists``, ``assignment_nodes``, ``assignment_counts``,
    ``telemetry``; with the wavefront scan the telemetry carries
    ``waves_per_batch``, ``wave_demotions`` and ``wave_uniform`` beside
    ``wave_width``, and ``scan_policy`` says whether the batch had a
    policy); ``device_result`` keeps the [G,N] ``capacity`` and
    ``scores`` tensors on the device for lazy row reads (complete once this
    returns: the event follows the whole batch on its stream)."""
    try:
        if pending.done is not None:
            pending.done.synchronize()
        blob_np = pending.blob.numpy()
    finally:
        _note_inflight(-1)

    g, k, pack = pending.g_bucket, pending.top_k, pending.pack
    tail_len = g * k if pack else 2 * g * k
    tail = blob_np[3 * g + 2: 3 * g + 2 + tail_len]
    if pack:
        packed_np = tail.reshape(g, k)
        nodes_np = packed_np >> 16
        counts_np = packed_np & (2**16 - 1)
    else:
        nodes_np = tail[: g * k].reshape(g, k)
        counts_np = tail[g * k:].reshape(g, k)
    dev = pending.device
    host = {
        "placed": blob_np[:g].astype(bool),
        "gang_feasible": blob_np[g:2 * g].astype(bool),
        "progress": blob_np[2 * g:3 * g],
        "best": blob_np[3 * g],
        "best_exists": bool(blob_np[3 * g + 1]),
        "assignment_nodes": nodes_np,
        "assignment_counts": counts_np,
        "telemetry": {
            "device": str(dev),
            "scan": "cuda_kernel" if dev.type == "cuda" else "plain",
            "mask_mode": pending.mask_mode,
            "n_bucket": pending.n_bucket,
            "g_bucket": g,
            "wave_width": pending.scan_wave,
            "scan_policy": pending.used_policy,
        },
    }
    if pending.scan_wave > 1:
        stats = blob_np[3 * g + 2 + tail_len:]
        host["telemetry"].update(
            waves_per_batch=int(stats[0]),
            wave_demotions=int(stats[1]),
            wave_uniform=int(stats[2]),
        )
    _fold_batch_metrics(host["telemetry"])
    out = pending.out
    device_result = {"capacity": out["capacity"], "scores": out["scores"]}
    return host, device_result


def _fold_batch_metrics(telemetry: dict) -> None:
    """The reference's per-batch series of a collected batch (its
    ``_fold_batch_metrics``), from the telemetry dict ``collect_batch``
    built on the host: ``bst_scan_batches_total`` by scan path and this
    thread's batch tenant (``utils.tenancy``: the scorer's dominant
    tenant, or the tenant a sidecar connection announced; "-" when none
    is armed), and the wavefront series. The port has no wave demotion
    ladder, so ``bst_scan_wave_enabled`` stays 1. The top-K, sharded and
    compile series belong to rungs not ported."""
    path = (
        "policy" if telemetry["scan_policy"]
        else "wavefront" if telemetry["wave_width"] > 1
        else "serial"
    )
    reg = DEFAULT_REGISTRY
    reg.counter(
        "bst_scan_batches_total",
        "Oracle batches by assignment-scan path and dominant tenant",
    ).inc(path=path, tenant=current_batch_tenant() or "-")
    reg.gauge(
        "bst_scan_wave_enabled",
        "1 while the wavefront scan path is enabled (0 after a failure "
        "permanently demoted the process to the serial scan)",
    ).set(1.0)
    if "waves_per_batch" in telemetry:
        reg.histogram(
            "bst_scan_waves_per_batch",
            "Sequential wavefront steps per oracle batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        ).observe(float(telemetry["waves_per_batch"]))
        reg.counter(
            "bst_scan_waves_total", "Wavefront steps executed"
        ).inc(telemetry["waves_per_batch"])
        reg.counter(
            "bst_scan_wave_demotions_total",
            "Waves demoted to the serial replay (conflict or infeasible "
            "boundary)",
        ).inc(telemetry["wave_demotions"])
        reg.counter(
            "bst_scan_wave_uniform_total",
            "Waves served by the uniform-demand aggregate fast path",
        ).inc(telemetry["wave_uniform"])


def execute_batch_host(batch_args, progress_args, device="cuda", policy=None):
    """Run one batch + max-progress selection on ``device`` and return its
    ``(host, device_result)``: the synchronous form of the split,
    ``collect_batch(dispatch_batch(...))``, whose docstrings give the
    arguments (``policy`` too), the streams and what comes back. The O(G)
    host vectors come back as one blob, through the pinned copy and the
    event of the split; the [G,N] tensors stay on the device."""
    return collect_batch(dispatch_batch(batch_args, progress_args, device, policy))
