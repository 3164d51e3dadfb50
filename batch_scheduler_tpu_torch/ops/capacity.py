"""Continuous cluster capacity analytics, computed where they are free.

The port of ``batch_scheduler_tpu/ops/capacity.py``. It answers the FLEET
question an operator asks first: how full is the cluster, how fragmented
is the remaining capacity, which tenant is consuming it, and can the
pending work actually land. One function (``_capacity_kernel``, plain
PyTorch on the device of its inputs: the reference's is an XLA ``jax.jit``,
not a Pallas kernel) runs against the committed batch inputs — the same
resident tensors ``ops.device_state`` keeps on the card — after a
published batch, and ``capacity_summary`` turns its outputs into an
**O(lanes) summary**:

- **per-lane utilization/headroom spectra** — lane totals plus a
  ``[R, _BINS]`` histogram of per-node headroom measured in units of the
  pending work's mean member demand, bucketed with the SAME
  ``min(cap, _BINS-1)`` clamp the assignment scan ranks nodes with;
- **fragmentation index** — the largest gang (a power-of-two size sweep
  over the carried leftover) that could still place as one
  all-or-nothing unit, per priority tier and globally, vs the need-
  clipped total;
- **stranded capacity** — per-lane headroom sitting on nodes where NO
  pending gang shape fits even one member;
- **seat-tightness distribution** — the stamped plan's seats histogrammed
  by the tightness bucket of their node at batch entry;
- **per-tenant dominant-resource shares** — namespace-derived
  (``utils.tenancy.batch_tenants``) attribution of consumed lanes and
  pending seats.

Cost discipline: :class:`CapacitySampler` budget-gates the function: after
a sample costing ``k`` seconds, the next is allowed no sooner than
``k / BST_CAPACITY_BUDGET_FRAC`` later, so the amortized hook cost is
``<= BST_CAPACITY_BUDGET_FRAC`` (default 2%) of wall-clock by
construction.

Determinism: the summary is derived from the batch inputs + result with
fixed arithmetic, keyed by lane/tier/tenant INDEX, and the per-batch
tenant mapping comes from the batch's own names, so a recorded batch
replays to the same summary. The reference sums integer-valued float32
terms, whose bits depend on the reduction order; on the card a float
scatter-add would not even repeat from run to run (atomics). So every sum
here is taken exactly in int64 and cast to float32 once: integer outputs
equal the reference's exactly, float outputs are the correctly rounded
value of the exact sum (the reference's within its own rounding), and the
same inputs give the same bits on every run and on both devices.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..utils.metrics import DEFAULT_REGISTRY
from ..utils.tenancy import OTHER_TENANT, batch_tenants, tenant_label
from ..utils.timeseries import DownsamplingRing
from .convert import _place_one, resolve_device
from .oracle import _BIG, _BINS, GANG_MAX, _member_capacity, group_capacity

__all__ = [
    "capacity_summary",
    "CapacitySampler",
    "capacity_enabled",
    "capacity_budget_frac",
    "set_active_sampler",
    "active_sampler",
    "annotate_summary",
    "format_capacity_verdict",
    "capacity_debug_view",
    "TIERS",
]

# Priority tiers the fragmentation sweep reports on: gang priorities clip
# into [0, TIERS) — deterministic from the recorded priority column, so
# live and replayed summaries agree (tier 0 = the no-policy default).
TIERS = 4

# Power-of-two gang-size ladder for the largest-placeable sweep: 2**0 to
# 2**18, GANG_MAX, the largest admissible gang (ops.oracle).
_LADDER_STEPS = 19


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------


def capacity_enabled() -> bool:
    """Parse-guarded BST_CAPACITY read: default ON; 0/off/false disables
    the sampler."""
    raw = os.environ.get("BST_CAPACITY", "").strip().lower()
    if raw in ("0", "off", "false", "no"):
        return False
    return True


def capacity_budget_frac() -> float:
    """Parse-guarded BST_CAPACITY_BUDGET_FRAC: the fraction of wall-clock
    the analytics hook may consume amortized (default 0.02). Clamped to
    [1e-4, 1.0]; 1.0 effectively samples every batch (gates/tests)."""
    raw = os.environ.get("BST_CAPACITY_BUDGET_FRAC", "").strip()
    if raw:
        try:
            return min(max(float(raw), 1e-4), 1.0)
        except ValueError:
            pass
    return 0.02


# ---------------------------------------------------------------------------
# the analytics function
# ---------------------------------------------------------------------------


def _exact_f32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The int64 sum of an integer tensor (over ``dim``, or all of it),
    cast to float32 once: the same bits on every run and device."""
    total = x.sum(dtype=torch.int64) if dim is None else x.sum(dim=dim, dtype=torch.int64)
    return total.to(torch.float32)


def _mean_demands(group_req, members, totals):
    """round(sum_g group_req[g] * members[k, g] / totals[k]) per row k and
    lane, 0 where ``totals[k]`` is 0: the reference's float32 division of
    the (exact) sum, rounded half to even as ``jnp.round`` does."""
    num = _exact_f32(members.long()[:, :, None] * group_req.long()[None], dim=1)
    den = totals.clamp(min=1).to(torch.float32)[:, None]
    return torch.where(totals[:, None] > 0, torch.round(num / den), 0.0).to(torch.int32)


def _capacity_kernel(
    alloc, requested, group_req, remaining, fit_mask, group_valid,
    placed, a_nodes, a_counts, scheduled, matched, tenant_id, tier,
    tenants: int,
):
    """The whole observatory over tensors on one device. Inputs are the
    padded batch args (ops.bucketing order), the batch result's plan
    fields, the progress counts, and the per-batch tenant/tier columns;
    every output is O(lanes)-small (the [R, _BINS] histogram is the
    largest). Outputs keep the reference's dtypes (float32 sums, int32
    counts). Pure: no env reads, no clocks."""
    i32, i64 = torch.int32, torch.int64
    n, r = alloc.shape
    dev = alloc.device
    placed_b = placed.bool()
    valid_b = group_valid.bool()
    left0 = alloc - requested
    # the stamped plan applied to the entry leftover: zero-count slots
    # carry arbitrary backfill node indexes, but their contribution is
    # zero, so the clip + scatter-add is correct without masking them
    counts = a_counts.clamp(0, GANG_MAX) * placed_b.to(i32)[:, None]
    nodes_idx = a_nodes.clamp(0, n - 1).long()
    seats = counts.sum(dim=1, dtype=i64)
    contrib = counts.long()[:, :, None] * group_req.long()[:, None, :]
    used_by_plan = torch.zeros((n, r), dtype=i64, device=dev).index_add_(
        0, nodes_idx.reshape(-1), contrib.reshape(-1, r)
    )
    left_after = left0 - used_by_plan.to(i32)

    node_real = (alloc > 0).any(dim=1)
    real_i = node_real.to(i32)
    free_real = left_after.clamp(0, _BIG) * real_i[:, None]
    lane_alloc = _exact_f32(alloc.clamp(0, _BIG) * real_i[:, None], dim=0)
    lane_free = _exact_f32(free_real, dim=0)
    lane_max_free = free_real.amax(dim=0)

    # pending work and its mean member demand (the headroom yardstick),
    # per priority tier and globally: rows 0..TIERS-1 are the tiers, row
    # TIERS all pending gangs (one batched pass, not one per row: this
    # function is a few hundred small launches, and their host cost is
    # its time on the card)
    pend = valid_b & ~placed_b & (remaining > 0)
    tiers_col = tier.clamp(0, TIERS - 1)
    tier_ids = torch.arange(TIERS, device=dev, dtype=tiers_col.dtype)
    rows = torch.cat([(tiers_col[None, :] == tier_ids[:, None]) & pend[None], pend[None]])
    members = remaining[None, :] * rows.to(i32)  # [TIERS+1, G]
    totals = members.sum(dim=1, dtype=i64)
    refs = _mean_demands(group_req, members, totals)  # [TIERS+1, R]
    pend_members, tot_pend, ref = members[TIERS], totals[TIERS], refs[TIERS]

    # per-lane headroom spectrum, bucketed exactly like the scan ranks
    # nodes: min(capacity-in-members, _BINS-1); ref==0 lanes (no pending
    # demand touches them) park every real node in the top bucket
    per_lane_cap = torch.where(
        ref[None, :] > 0,
        torch.div(left_after.clamp(0, _BIG), ref.clamp(1, _BIG)[None, :],
                  rounding_mode="floor"),
        _BIG,
    )
    key_lane = per_lane_cap.clamp(max=_BINS - 1).long()
    lane_base = torch.arange(r, device=dev, dtype=i64)[None, :] * _BINS
    headroom_hist = torch.zeros(r * _BINS, dtype=i64, device=dev).index_add_(
        0, (lane_base + key_lane).reshape(-1),
        real_i.long()[:, None].expand(n, r).reshape(-1),
    ).view(r, _BINS).to(i32)

    # what the pending work can still consume of the carried leftover
    cap_after = group_capacity(left_after, group_req, fit_mask)
    capc = torch.minimum(cap_after, remaining[:, None]) * pend.to(i32)[:, None]
    feasible_after = (capc.sum(dim=1, dtype=i64) >= remaining) & pend
    unplaceable = (pend & ~feasible_after).sum(dtype=i64).to(i32)

    consumable = ((cap_after > 0) & pend[:, None]).any(dim=0)
    has_head = (left_after > 0).any(dim=1) & node_real
    stranded = has_head & ~consumable & (tot_pend > 0)
    stranded_lane = _exact_f32(free_real * stranded.to(i32)[:, None], dim=0)
    stranded_nodes = stranded.sum(dtype=i64).to(i32)
    del cap_after, capc

    # seat tightness: the plan's seats by their node's entry bucket
    key0 = group_capacity(left0, group_req, fit_mask).clamp(max=_BINS - 1)
    seat_keys = torch.gather(key0, 1, nodes_idx)
    seat_hist = torch.zeros(_BINS, dtype=i64, device=dev).index_add_(
        0, seat_keys.reshape(-1).long(), counts.reshape(-1).long()
    ).to(i32)
    del key0

    # largest-placeable sweep (fragmentation), per tier + global: for a
    # reference member demand, the biggest ladder size s whose
    # need-clipped pooled capacity covers s — the all-or-nothing gang
    # admission rule applied to hypothetical sizes. The ladder is made on
    # the device (a host tensor's copy would wait for the stream).
    sizes = 2 ** torch.arange(_LADDER_STEPS, dtype=i64, device=dev)
    active = totals > 0
    cap_ref = (_member_capacity(left_after[None], refs[:, None, :]) * real_i).clamp(0, GANG_MAX)
    tot_s = torch.minimum(cap_ref.long()[:, None, :], sizes[None, :, None]).sum(dim=2)
    largest = (sizes[None] * (tot_s >= sizes[None])).amax(dim=1).to(i32) * active.to(i32)
    total_ref = _exact_f32(cap_ref, dim=1) * active.to(torch.float32)

    # per-tenant attribution: members already on nodes (scheduled +
    # matched) plus this plan's seats, times the member demand row
    members_active = (
        scheduled.clamp(0, GANG_MAX).long() + matched.clamp(0, GANG_MAX).long() + seats
    )
    demand = members_active[:, None] * group_req.long() * valid_b.long()[:, None]
    tid = tenant_id.clamp(0, tenants - 1).long()
    tenant_used = torch.zeros((tenants, r), dtype=i64, device=dev).index_add_(
        0, tid, demand
    ).to(torch.float32)
    tenant_pending = torch.zeros(tenants, dtype=i64, device=dev).index_add_(
        0, tid, pend_members.long()
    ).to(i32)

    return {
        "lane_alloc": lane_alloc,
        "lane_free": lane_free,
        "lane_max_free": lane_max_free,
        "ref_demand": ref,
        "headroom_hist": headroom_hist,
        "stranded_lane": stranded_lane,
        "stranded_nodes": stranded_nodes,
        "seat_hist": seat_hist,
        "tier_largest": largest[:TIERS],
        "tier_pending": totals[:TIERS].to(i32),
        "frag_largest": largest[TIERS],
        "frag_total": total_ref[TIERS],
        "tenant_used": tenant_used,
        "tenant_pending": tenant_pending,
        "pending_gangs": pend.sum(dtype=i64).to(i32),
        "pending_seats": tot_pend.to(i32),
        "unplaceable_gangs": unplaceable,
        "placed_gangs": placed_b.sum(dtype=i64).to(i32),
        "placed_seats": seats.sum().to(i32),
        "nodes_real": real_i.sum(dtype=i64).to(i32),
    }


def _f(x) -> float:
    return round(float(x), 6)


def capacity_summary(
    batch_args: tuple,
    result: dict,
    *,
    group_names: Optional[List[str]] = None,
    scheduled=None,
    matched=None,
    policy_prio=None,
    device="cuda",
) -> dict:
    """One canonical capacity summary for a published batch, computed on
    ``device`` (``cuda`` unless the caller passes ``cpu``).

    ``batch_args`` is the padded 7-tuple (host numpy, or tensors already
    on ``device``: the resident state, read in place — ops.bucketing
    order); ``result`` the batch's host plan dict (or an AuditReader
    record's ``result_arrays``). The summary is keyed by lane/tier/tenant
    INDEX and derived deterministically, so a recorded batch replayed
    through this function reproduces the live sample. ``policy_prio``
    (the packed priority column) feeds the tier sweep; absent = every gang
    tier 0. The tenant dimension is the batch's own label count (the
    reference pads it to a static jit width; the summary is the same)."""
    dev = resolve_device(device)
    alloc, requested, group_req, remaining, fit_mask, group_valid, _order = batch_args
    g_bucket = int(np.shape(remaining)[0])
    names = list(group_names or [])
    tenant_id, labels = batch_tenants(names, g_bucket)
    zeros_g = np.zeros(g_bucket, dtype=np.int32)

    def i32(a):
        return _place_one(zeros_g if a is None else a, np.int32, dev)

    def flag(a):
        return _place_one(a, np.bool_, dev)

    out = _capacity_kernel(
        i32(alloc), i32(requested), i32(group_req), i32(remaining),
        flag(fit_mask), flag(group_valid),
        i32(np.asarray(result["placed"]).astype(np.int32)),
        i32(np.asarray(result["assignment_nodes"])),
        i32(np.asarray(result["assignment_counts"])),
        i32(scheduled), i32(matched), i32(tenant_id), i32(policy_prio),
        tenants=len(labels),
    )
    out = {k: v.cpu().numpy() for k, v in out.items()}

    lanes = []
    r = out["lane_alloc"].shape[0]
    for i in range(r):
        alloc_i = _f(out["lane_alloc"][i])
        free_i = _f(out["lane_free"][i])
        used_i = _f(max(alloc_i - free_i, 0.0))
        lanes.append({
            "lane": i,
            "alloc": alloc_i,
            "free": free_i,
            "utilization": _f(used_i / max(alloc_i, 1.0)),
            "max_node_free": int(out["lane_max_free"][i]),
            "ref_member_demand": int(out["ref_demand"][i]),
            "stranded_free": _f(out["stranded_lane"][i]),
            "headroom_hist": [int(c) for c in out["headroom_hist"][i]],
        })

    frag_total = _f(out["frag_total"])
    frag_largest = int(out["frag_largest"])
    frag_index = _f(
        1.0 - frag_largest / frag_total if frag_total > 0 else 0.0
    )
    stranded_lane = out["stranded_lane"]
    top_stranded = int(np.argmax(stranded_lane)) if r else 0

    tenants_out = []
    for t, label in enumerate(labels):
        shares = {}
        dominant, dom_lane = 0.0, 0
        for i in range(r):
            s = _f(
                float(out["tenant_used"][t, i])
                / max(float(out["lane_alloc"][i]), 1.0)
            )
            shares[str(i)] = s
            if s > dominant:
                dominant, dom_lane = s, i
        pending_t = int(out["tenant_pending"][t])
        if dominant <= 0.0 and pending_t == 0 and label == OTHER_TENANT:
            continue  # an empty overflow bucket is noise
        tenants_out.append({
            "tenant": label,
            "dominant_share": _f(dominant),
            "dominant_lane": dom_lane,
            "shares": shares,
            "pending_seats": pending_t,
        })
    top = max(
        tenants_out, key=lambda d: d["dominant_share"], default=None
    )

    return {
        "schema": "bst-capacity/v1",
        "nodes": int(out["nodes_real"]),
        "gangs": len(names) if names else g_bucket,
        "lanes": lanes,
        "fragmentation_index": frag_index,
        "largest_placeable_gang": frag_largest,
        "largest_placeable_by_tier": [
            int(x) for x in out["tier_largest"]
        ],
        "pending_seats_by_tier": [int(x) for x in out["tier_pending"]],
        "stranded": {
            "nodes": int(out["stranded_nodes"]),
            "top_lane": top_stranded,
            "top_lane_free": _f(stranded_lane[top_stranded]) if r else 0.0,
        },
        "seat_tightness_hist": [int(c) for c in out["seat_hist"]],
        "pending": {
            "gangs": int(out["pending_gangs"]),
            "seats": int(out["pending_seats"]),
            "unplaceable_gangs": int(out["unplaceable_gangs"]),
        },
        "placed": {
            "gangs": int(out["placed_gangs"]),
            "seats": int(out["placed_seats"]),
        },
        "tenants": tenants_out,
        "top_tenant": top["tenant"] if top else "",
        "top_tenant_share": top["dominant_share"] if top else 0.0,
    }


def annotate_summary(
    summary: dict, lane_names: Optional[List[str]] = None
) -> dict:
    """A display copy of a canonical summary with lane indices resolved
    to schema names (``lane<i>`` when unknown). The CANONICAL summary
    stays index-keyed — names never enter the bit-compared series."""
    names = list(lane_names or [])

    def lname(i: int) -> str:
        return names[i] if 0 <= i < len(names) else f"lane{i}"

    out = dict(summary)
    out["lanes"] = [
        {**lane, "name": lname(lane["lane"])} for lane in summary["lanes"]
    ]
    stranded = dict(summary["stranded"])
    stranded["top_lane_name"] = lname(stranded["top_lane"])
    out["stranded"] = stranded
    return out


def format_capacity_verdict(
    summary: dict, lane_names: Optional[List[str]] = None
) -> str:
    """The one-line verdict form of a capacity summary (``capacity: frag
    ..., largest placeable ..., busiest lane ...``), as the reference's
    sim prints it beside its ``slo health:`` line."""
    view = annotate_summary(summary, lane_names)
    util = {
        lane["name"]: lane["utilization"] for lane in view["lanes"]
        if lane["alloc"] > 0
    }
    busiest = max(util.items(), key=lambda kv: kv[1], default=("-", 0.0))
    pend = summary["pending"]
    parts = [
        f"frag {summary['fragmentation_index']:.2f}",
        f"largest placeable {summary['largest_placeable_gang']}",
        f"busiest lane {busiest[0]} {busiest[1] * 100:.0f}%",
    ]
    if summary["stranded"]["nodes"]:
        parts.append(
            f"stranded {summary['stranded']['nodes']} nodes "
            f"(top {view['stranded']['top_lane_name']})"
        )
    if summary["top_tenant"]:
        parts.append(
            f"top tenant {summary['top_tenant']} "
            f"{summary['top_tenant_share'] * 100:.0f}%"
        )
    if pend["unplaceable_gangs"]:
        parts.append(f"UNPLACEABLE {pend['unplaceable_gangs']} gangs")
    return "capacity: " + ", ".join(parts)



# ---------------------------------------------------------------------------
# the budget-gated sampler
# ---------------------------------------------------------------------------


class CapacitySampler:
    """Per-scorer (or per-sidecar) capacity sampling with the amortized
    cost bound built in: a sample costing ``k`` seconds schedules the
    next no sooner than ``k / budget_frac`` later. Samples land in a
    bounded downsampling ring (utils.timeseries), the Prometheus gauges,
    and — when an audit log is attached — a ``capacity_sample`` event in
    the audit ring keyed by the batch's audit ID."""

    def __init__(self, label: str = "scorer", registry=None):
        self.label = label
        self._reg = registry or DEFAULT_REGISTRY
        self._lock = threading.Lock()
        self._ring = DownsamplingRing()  # internally locked
        self._next_allowed = 0.0  # guarded-by: _lock
        self.samples = 0  # guarded-by: _lock
        self.skipped = 0  # guarded-by: _lock
        self.last_kernel_s = 0.0  # guarded-by: _lock
        self._last: Optional[dict] = None  # guarded-by: _lock
        self._lane_names: Optional[List[str]] = None  # guarded-by: _lock
        self._counter = self._reg.counter(
            "bst_capacity_samples_total",
            "Capacity-observatory kernel runs by outcome (sampled / "
            "budget-skipped / error)",
        )
        self._kernel_hist = self._reg.histogram(
            "bst_capacity_kernel_seconds",
            "Wall-clock of one capacity-analytics kernel run (the "
            "budget-gated hook cost)",
        )

    def note_batch(
        self,
        batch_args: tuple,
        result: dict,
        *,
        group_names: Optional[List[str]] = None,
        lane_names: Optional[List[str]] = None,
        scheduled=None,
        matched=None,
        policy_prio=None,
        audit_log=None,
        audit_id: Optional[str] = None,
        device="cuda",
    ) -> Optional[dict]:
        """Hot-path entry: run the analytics on ``device`` iff the budget
        allows, record the sample everywhere, return the summary (None
        when skipped). Never raises — analytics must not fail the decision
        path; a failure is counted under the ``error`` outcome."""
        now = time.monotonic()
        with self._lock:
            if now < self._next_allowed:
                self.skipped += 1
                skipped = True
            else:
                skipped = False
                # reserve the slot INSIDE the gate check: the sidecar's
                # connection threads share one sampler, and a
                # check-then-act gate would let N concurrent publishers
                # all pass an open gate and pay the kernel in parallel.
                # The infinite sentinel is always overwritten before
                # anything else can fail — by the error path (+5s) or by
                # the real spacing.
                self._next_allowed = float("inf")
        if skipped:
            self._counter.inc(outcome="skipped")
            return None
        try:
            t0 = time.perf_counter()
            summary = capacity_summary(
                batch_args, result, group_names=group_names,
                scheduled=scheduled, matched=matched,
                policy_prio=policy_prio, device=device,
            )
            kernel_s = time.perf_counter() - t0
        except Exception:  # noqa: BLE001 — analytics never break serving
            self._counter.inc(outcome="error")
            with self._lock:
                # an erroring kernel must not retry at line rate
                self._next_allowed = time.monotonic() + 5.0
            return None
        frac = capacity_budget_frac()
        with self._lock:
            self.samples += 1
            self.last_kernel_s = kernel_s
            # frac >= 1.0 means "every batch" (gates/tests); below it,
            # the spacing IS the amortized-cost bound
            self._next_allowed = (
                0.0 if frac >= 1.0
                else time.monotonic() + kernel_s / frac
            )
            self._last = summary
            if lane_names:
                self._lane_names = list(lane_names)
            ring = self._ring
        # the ring copy carries a 0/1 violation indicator: downsampling
        # AVERAGES it, so a merged entry's value is the fraction of
        # violating raw samples it folded. A shallow copy — the canonical
        # summary recorded to the audit ring stays untouched.
        ring.append(
            time.time(),
            dict(
                summary,
                capacity_violation=(
                    1.0
                    if summary["pending"]["unplaceable_gangs"] > 0
                    else 0.0
                ),
            ),
        )
        self._counter.inc(outcome="sampled")
        self._kernel_hist.observe(kernel_s)
        self._export_gauges(summary)
        if audit_log is not None:
            try:
                audit_log.record_event(
                    "capacity_sample", audit_id=audit_id, summary=summary
                )
            except Exception:  # noqa: BLE001 — evidence best-effort
                pass
        return summary

    def _export_gauges(self, summary: dict) -> None:
        reg = self._reg
        reg.gauge(
            "bst_capacity_fragmentation_index",
            "1 - largest-placeable-gang / need-clipped total capacity "
            "(0 = one gang could take everything, ~1 = crumbs)",
        ).set(summary["fragmentation_index"])
        reg.gauge(
            "bst_capacity_largest_placeable_gang",
            "Largest power-of-two gang of the pending mean member demand "
            "still placeable as one unit, by priority tier",
        ).set(float(summary["largest_placeable_gang"]), tier="all")
        for t, v in enumerate(summary["largest_placeable_by_tier"]):
            if summary["pending_seats_by_tier"][t]:
                reg.gauge(
                    "bst_capacity_largest_placeable_gang", ""
                ).set(float(v), tier=str(t))
        util = reg.gauge(
            "bst_capacity_lane_utilization",
            "Per-lane cluster utilization (used / allocatable), lane-"
            "indexed per the snapshot schema",
        )
        stranded = reg.gauge(
            "bst_capacity_stranded_free",
            "Per-lane headroom on nodes no pending gang shape can "
            "consume (device units)",
        )
        with self._lock:
            names = list(self._lane_names or [])
        for lane in summary["lanes"]:
            i = lane["lane"]
            label = names[i] if i < len(names) else f"lane{i}"
            util.set(lane["utilization"], lane=label)
            stranded.set(lane["stranded_free"], lane=label)
        reg.gauge(
            "bst_capacity_stranded_nodes",
            "Nodes holding headroom that no pending gang shape can "
            "consume",
        ).set(float(summary["stranded"]["nodes"]))
        reg.gauge(
            "bst_capacity_pending_unplaceable_gangs",
            "Pending gangs the carried leftover cannot place even with "
            "every reserved seat released (capacity-infeasible now)",
        ).set(float(summary["pending"]["unplaceable_gangs"]))
        share = reg.gauge(
            "bst_capacity_tenant_share",
            "Per-tenant dominant-resource share of allocatable capacity "
            "(namespace-derived, cardinality-capped)",
        )
        for t in summary["tenants"]:
            # the summary's labels are capped PER BATCH; the gauge's
            # label set must be capped PER PROCESS (the first-seen
            # registry) or namespace churn grows /metrics series without
            # bound over the process lifetime
            label = (
                t["tenant"]
                if t["tenant"] == OTHER_TENANT
                else tenant_label(t["tenant"])
            )
            share.set(t["dominant_share"], tenant=label)

    # -- reporting -----------------------------------------------------------

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._last

    def lane_names(self) -> Optional[List[str]]:
        with self._lock:
            return list(self._lane_names) if self._lane_names else None

    def series(self, max_points: Optional[int] = None) -> List[dict]:
        """The sampled history, oldest first (``utils.timeseries``)."""
        return self._ring.series(max_points)

    def report(self, series_points: int = 512) -> dict:
        """The ``/debug/capacity`` report: the last sample (lane names
        resolved), the counters and the downsampled series. Reads what
        the last sample left; runs no sample itself."""
        with self._lock:
            last = self._last
            names = list(self._lane_names or [])
            samples, skipped = self.samples, self.skipped
            kernel_s = self.last_kernel_s
        return {
            "label": self.label,
            "samples": samples,
            "skipped": skipped,
            "last_kernel_s": round(kernel_s, 6),
            "budget_frac": capacity_budget_frac(),
            "lane_names": names,
            "last": annotate_summary(last, names) if last else None,
            "ring": self._ring.stats(),
            "series": self.series(max_points=series_points),
        }


# ---------------------------------------------------------------------------
# the active-sampler registry
# ---------------------------------------------------------------------------

_active: list = [None]


def set_active_sampler(sampler: Optional[CapacitySampler]) -> None:
    """Each OracleScorer registers its sampler (None when capacity is off)
    at construction, so a process-wide reader answers for the LIVE scorer
    — a torn-down scorer's ring must not answer a later one's query."""
    _active[0] = sampler


def active_sampler() -> Optional[CapacitySampler]:
    return _active[0]


def capacity_debug_view(params: Optional[dict] = None) -> tuple:
    """The /debug/capacity payload: (payload, http status). Bare GETs are
    self-describing 200s (the /debug/ index probe's contract)."""
    sampler = _active[0]
    if sampler is None:
        return (
            {
                "enabled": capacity_enabled(),
                "sampler": None,
                "hint": "no capacity sampler registered (oracle mode "
                        "with BST_CAPACITY on required)",
            },
            200,
        )
    params = params or {}
    points = 512
    raw = params.get("points")
    if raw is not None:
        # parse BEFORE building the report: the series copy is the
        # expensive part and must be taken exactly once, at the
        # requested trim
        try:
            points = max(1, int(raw))
        except ValueError:
            return {"error": f"malformed points={raw!r}"}, 400
    report = sampler.report(series_points=points)
    report["enabled"] = capacity_enabled()
    return report, 200
