"""The gang observatory: explain ("why is my gang pending") and what-if
("what change would place it") over the live oracle, on the port's device.

The port of ``batch_scheduler_tpu/core/explain.py``, in its order:

- **Explain** (``Observatory.explain``, ``/debug/explain?gang=NS/NAME``):
  runs ``ops.explain.explain_gang`` on the CURRENT batch's packed inputs
  (on CUDA its scan is two launches of the serial cluster kernel) and
  assembles the human answer: the denial verdict with the EXACT PreFilter
  blame string (core.operation's deny-reason builders, so explanation and
  recorded denial cannot drift), per-lane deficits and the binding lane,
  fit-mask / policy-mask / capacity exclusion counts, near-miss nodes with
  per-term policy penalties (``PolicyEngine.explain``), preemption
  candidacy (a ``PreemptionPlanner`` dry run), cross-stamped against the
  flight recorder's ``pre_filter`` record (``recorded_agrees``).
- **What-if** (``Observatory.whatif``, ``/debug/whatif``): forks the
  device-resident state copy-on-write (``DeviceStateHolder.fork``, never
  the live holder, which the scorer keeps scoring), applies one
  counterfactual (drain / cordon a node, add N nodes of a shape, bump a
  gang's priority tier, remove a gang) to a fresh read of the live cluster
  inputs, re-runs the scoring path on the fork on a named rung (a
  non-steady rung under the thread-local ``ops.oracle.forced_scan_rung``
  pin, as replay runs), and returns a placement diff: newly placeable
  gangs, displaced seats, the per-lane headroom delta. Applying C through
  the engine gives the plan digest of a cluster that applied C and ran the
  batch directly.

The batches run on the calling thread's current stream: a query's fork is
keyframed from its own pack before anything reads it, so it shares no
tensor with a scorer and enters no scorer stream.

Left out: the ``explain`` / ``whatif`` CLI subcommands and the harness
views, which come with the control plane (ROADMAP Queue 1).
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import DEFAULT_REGISTRY
from .oracle_scorer import REPLAY_RUNGS

__all__ = [
    "Observatory",
    "WhatIfEngine",
    "COUNTERFACTUAL_KINDS",
    "WHATIF_RUNGS",
    "parse_counterfactual",
    "apply_counterfactual",
    "explain_arrays",
    "baseline_inputs_key",
    "set_active_observatory",
    "active_observatory",
    "explain_debug_view",
    "whatif_debug_view",
]

COUNTERFACTUAL_KINDS = (
    "drain", "cordon", "add-nodes", "bump-gang", "remove-gang",
)

# The rungs a what-if may score on: the replay rungs. "steady" executes
# exactly what this process would dispatch now; the others are
# thread-locally pinned (forced_scan_rung), so a what-if never changes
# the rung a serving thread runs.
WHATIF_RUNGS = REPLAY_RUNGS

# the wave width the wavefront and topk rungs pin, and the topk rung's
# candidate width (the reference's)
_WHATIF_WAVE = 8
_WHATIF_TOPK = 16

_GRAMMAR = (
    "?drain=NODE | ?cordon=NODE | ?add_nodes=N[&node_cpu=..][&node_memory=..]"
    "[&node_pods=..] | ?bump_gang=NS/NAME&tier=T | ?remove_gang=NS/NAME"
)
_CF_PARAMS = ("drain", "cordon", "add_nodes", "bump_gang", "remove_gang")


# ---------------------------------------------------------------------------
# counterfactuals
# ---------------------------------------------------------------------------


def parse_counterfactual(params: Dict[str, str]) -> dict:
    """Normalize the /debug/whatif query grammar (one counterfactual per
    query) into the canonical dict form; raises ValueError with the full
    grammar on anything malformed. Grammar:

      ?drain=NODE
      ?cordon=NODE
      ?add_nodes=N[&node_cpu=32][&node_memory=128Gi][&node_pods=110]
      ?bump_gang=NS/NAME&tier=T
      ?remove_gang=NS/NAME
    """
    present = [k for k in _CF_PARAMS if params.get(k)]
    if len(present) != 1:
        raise ValueError("exactly one counterfactual per query: " + _GRAMMAR)
    key = present[0]
    if key in ("drain", "cordon"):
        return {"kind": key, "node": params[key]}
    if key == "add_nodes":
        try:
            count = int(params["add_nodes"])
        except ValueError:
            raise ValueError(
                f"add_nodes={params['add_nodes']!r} is not an integer"
            ) from None
        if not 0 < count <= 4096:
            raise ValueError("add_nodes must be in [1, 4096]")
        return {
            "kind": "add-nodes",
            "count": count,
            "shape": {
                "cpu": params.get("node_cpu", "32"),
                "memory": params.get("node_memory", "128Gi"),
                "pods": params.get("node_pods", "110"),
            },
        }
    if key == "bump_gang":
        try:
            tier = int(params.get("tier", ""))
        except ValueError:
            raise ValueError(
                "bump_gang requires &tier=T (an integer priority class)"
            ) from None
        return {"kind": "bump-gang", "gang": params["bump_gang"], "tier": tier}
    return {"kind": "remove-gang", "gang": params["remove_gang"]}


def apply_counterfactual(nodes: list, node_req: dict, demands: list,
                         cf: dict) -> Tuple[list, dict, list]:
    """Apply one counterfactual to host-side cluster inputs, returning NEW
    (nodes, node_requested, demands): the live objects are never mutated
    (cordon deep-copies its node). These are the inputs
    ``core.oracle_scorer.read_cluster_inputs`` reads, which is what makes
    the what-if plan the plan of a cluster that applied the change: both
    feed the same pack and scoring path."""
    kind = cf.get("kind")
    if kind == "drain":
        name = cf["node"]
        out = [n for n in nodes if n.metadata.name != name]
        if len(out) == len(nodes):
            raise ValueError(f"unknown node {name!r}")
        return out, {k: v for k, v in node_req.items() if k != name}, demands
    if kind == "cordon":
        name = cf["node"]
        out = []
        found = False
        for n in nodes:
            if n.metadata.name == name:
                n = n.deepcopy()
                n.spec.unschedulable = True
                found = True
            out.append(n)
        if not found:
            raise ValueError(f"unknown node {name!r}")
        return out, node_req, demands
    if kind == "add-nodes":
        from ..sim.scenarios import make_sim_node

        added = [
            make_sim_node(f"whatif-node-{i:04d}", dict(cf["shape"]))
            for i in range(int(cf["count"]))
        ]
        return list(nodes) + added, node_req, demands
    if kind == "bump-gang":
        gang = cf["gang"]
        out = [
            replace(d, priority=int(cf["tier"])) if d.full_name == gang else d
            for d in demands
        ]
        if all(d is demands[i] for i, d in enumerate(out)):
            raise ValueError(f"unknown gang {gang!r}")
        return nodes, node_req, out
    if kind == "remove-gang":
        gang = cf["gang"]
        out = [d for d in demands if d.full_name != gang]
        if len(out) == len(demands):
            raise ValueError(f"unknown gang {gang!r}")
        return nodes, node_req, out
    raise ValueError(
        f"unknown counterfactual kind {kind!r} (use one of {COUNTERFACTUAL_KINDS})"
    )


# ---------------------------------------------------------------------------
# rung-pinned execution (the replay discipline applied to the future)
# ---------------------------------------------------------------------------


def _execute_rung(batch_args, progress_args, rung: str, device, policy=None) -> dict:
    """Run one batch on ``rung`` and return the host result.

    ``steady`` dispatches exactly what this process would serve now on
    ``device`` (the fork's resident tensors ride through untouched);
    ``wavefront`` runs on ``device`` under the thread-local
    ``forced_scan_rung`` pin at W=8, ``topk`` under the pin at W=8 and
    K=16 (the top-K kernel on cuda); ``cpu-ladder`` copies every tensor to
    host numpy and runs the plain serial scan on the CPU under the pin at
    0. A policy batch runs the policy scan on every rung."""
    from ..ops.bucketing import topk_bucket, wave_width_bucket
    from ..ops.oracle import execute_batch_host, forced_scan_rung

    if rung == "steady":
        return execute_batch_host(batch_args, progress_args, device=device, policy=policy)[0]
    if rung in ("wavefront", "topk"):
        pin = (wave_width_bucket(_WHATIF_WAVE),
               topk_bucket(_WHATIF_TOPK) if rung == "topk" else 0)
        with forced_scan_rung(*pin):
            return execute_batch_host(batch_args, progress_args, device=device,
                                      policy=policy)[0]
    if rung == "cpu-ladder":
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        batch_args = tuple(host(a) for a in batch_args)
        progress_args = tuple(host(a) for a in progress_args)
        with forced_scan_rung(0):
            return execute_batch_host(batch_args, progress_args, device="cpu",
                                      policy=policy)[0]
    raise ValueError(f"unknown what-if rung {rung!r} (use one of {WHATIF_RUNGS})")


# ---------------------------------------------------------------------------
# what-if engine
# ---------------------------------------------------------------------------


def _placement_map(snap, host) -> Dict[str, Dict[str, int]]:
    """gang -> {node: seats} for the batch's placed gangs (compact top-K
    assignment; exact for gangs spanning <= K nodes: the readback
    OracleScorer.assignment serves)."""
    out: Dict[str, Dict[str, int]] = {}
    names = snap.node_names
    placed = np.asarray(host["placed"])
    nodes_rows = np.asarray(host["assignment_nodes"])
    counts_rows = np.asarray(host["assignment_counts"])
    for gi, gang in enumerate(snap.group_names):
        if not bool(placed[gi]):
            continue
        out[gang] = {
            names[int(idx)]: int(cnt)
            for idx, cnt in zip(nodes_rows[gi], counts_rows[gi])
            if cnt > 0 and int(idx) < len(names)
        }
    return out


def _feasible_set(snap, host) -> set:
    feas = np.asarray(host["gang_feasible"])
    return {gang for gi, gang in enumerate(snap.group_names) if bool(feas[gi])}


def baseline_inputs_key(version, nodes, demands) -> tuple:
    """The what-if baseline-cache key: a fingerprint of the INPUTS the
    baseline was packed from. ``cluster.version()`` alone is not enough:
    it moves on node/pod capacity events but NOT on pod-group/demand churn
    (a created gang flows through ``mark_dirty``/ensure_fresh), and a
    baseline diffed against fresher demands would attribute cluster churn
    to the counterfactual. O(G·R) host hashing."""
    return (
        version,
        len(nodes),
        hash(tuple(
            (
                d.full_name, d.priority, d.min_member, d.scheduled,
                d.matched, d.released,
                tuple(sorted(d.member_request.items())),
            )
            for d in demands
        )),
    )


def _headroom_by_lane(snap) -> Dict[str, int]:
    """Per-lane schedulable headroom (device units): sum over valid nodes
    of clip(alloc - requested, 0)."""
    valid = np.asarray(snap.node_valid)
    left = np.clip(
        snap.alloc.astype(np.int64) - snap.requested.astype(np.int64), 0, None
    )
    return {name: int(left[valid, i].sum()) for i, name in enumerate(snap.schema.names)}


def _side(snap, digest: str, place: dict, feas: set) -> dict:
    """One side's summary in a what-if answer."""
    return {
        "plan_digest": digest,
        "groups": len(snap.group_names),
        "nodes": len(snap.node_names),
        "placed": len(place),
        "feasible": len(feas),
    }


class WhatIfEngine:
    """Counterfactual scorer over copy-on-write device-state forks on
    ``device`` (``cuda`` by default, which raises without CUDA).

    One query packs the baseline and counterfactual snapshots from the
    SAME inputs, installs the baseline as a keyframe on a fork of the live
    holder (``holder_source()``; the live holder's tensors are never read
    or written), applies the counterfactual to a fork of that fork as row
    scatters (copy-on-write: the baseline fork's tensors stay as they
    are), executes both on the requested rung and diffs. The baseline
    (snapshot, result, resident fork) is cached per ``baseline_key``, so a
    what-if storm against an unchanged cluster pays one extra batch a
    query."""

    def __init__(self, holder_source=None, policy_engine=None, device="cuda"):
        from ..ops.convert import resolve_device

        self.device = resolve_device(device)
        # serializes queries end to end: the fork chain and the baseline
        # cache have one writer, and the endpoint is a debug surface
        self._lock = threading.Lock()
        # callable -> the live DeviceStateHolder (or None), resolved per
        # query so a scorer constructed later is still picked up
        self._holder_source = holder_source
        self.policy_engine = policy_engine
        # (key, snap, host, digest, fork, device_args) of the cached baseline
        self._baseline: Optional[tuple] = None  # guarded-by: _lock
        self.queries = 0  # guarded-by: _lock

    def _fork(self):
        from ..ops.device_state import DeviceStateHolder

        live = self._holder_source() if self._holder_source else None
        if live is not None and live.device == self.device:
            return live.fork()
        # no live holder on this device (a remote scorer keeps its state
        # behind the sidecar): a detached fork, keyframed all the same
        return DeviceStateHolder(self.device, label="whatif").fork()

    def _pack(self, nodes, node_req, demands):
        from ..ops.snapshot import ClusterSnapshot

        engine = self.policy_engine
        if engine is not None and not engine.enabled:
            engine = None
        return ClusterSnapshot(nodes, node_req, demands, policy_engine=engine)

    @staticmethod
    def _digest(host) -> str:
        from ..utils import audit as audit_mod

        return audit_mod.plan_digest(host)

    def query_on(self, nodes, node_req, demands, cf: dict, rung: str = "steady",
                 baseline_key=None) -> dict:
        """Score one counterfactual against explicit cluster inputs (the
        Observatory passes a live read; tests and the smoke pass synthetic
        ones). Raises ValueError on a malformed counterfactual, an unknown
        node/gang or an unknown rung."""
        if rung not in WHATIF_RUNGS:
            raise ValueError(
                f"unknown what-if rung {rung!r} (use one of {WHATIF_RUNGS})"
            )
        t0 = time.perf_counter()
        cf_nodes, cf_req, cf_demands = apply_counterfactual(nodes, node_req, demands, cf)
        with self._lock:
            self.queries += 1
            cached = self._baseline
            use_cache = (
                cached is not None
                and baseline_key is not None
                and cached[0] == (baseline_key, rung)
            )
            if use_cache:
                _, base_snap, base_host, base_digest, fork, base_args = cached
            else:
                base_snap = self._pack(nodes, node_req, demands)
                fork = self._fork()
                base_args = fork.keyframe(base_snap.device_args(), 0, "whatif-base")
                base_host = _execute_rung(
                    base_args, base_snap.progress_args(), rung, self.device,
                    policy=base_snap.policy_payload(),
                )
                base_digest = self._digest(base_host)
                if baseline_key is not None:
                    self._baseline = (
                        (baseline_key, rung), base_snap, base_host, base_digest,
                        fork, base_args,
                    )
            cf_snap = self._pack(cf_nodes, cf_req, cf_demands)
            cf_args = fork.fork().apply_batch(cf_snap.device_args(), base_snap.device_args())
            cf_host = _execute_rung(
                cf_args, cf_snap.progress_args(), rung, self.device,
                policy=cf_snap.policy_payload(),
            )
            cf_digest = self._digest(cf_host)
        elapsed = time.perf_counter() - t0

        base_place = _placement_map(base_snap, base_host)
        cf_place = _placement_map(cf_snap, cf_host)
        base_feas = _feasible_set(base_snap, base_host)
        cf_feas = _feasible_set(cf_snap, cf_host)
        moved: Dict[str, Dict[str, int]] = {}
        displaced_seats = 0
        for gang in sorted(set(base_place) & set(cf_place)):
            b, c = base_place[gang], cf_place[gang]
            if b == c:
                continue
            delta = {
                node: c.get(node, 0) - b.get(node, 0)
                for node in sorted(set(b) | set(c))
                if c.get(node, 0) != b.get(node, 0)
            }
            moved[gang] = delta
            displaced_seats += sum(-v for v in delta.values() if v < 0)
        base_head = _headroom_by_lane(base_snap)
        cf_head = _headroom_by_lane(cf_snap)

        DEFAULT_REGISTRY.counter(
            "bst_whatif_queries_total",
            "What-if counterfactual queries by kind (/debug/whatif)",
        ).inc(kind=cf["kind"])
        DEFAULT_REGISTRY.histogram(
            "bst_whatif_query_seconds",
            "End-to-end what-if query time (pack + forked batch + diff)",
        ).observe(elapsed)
        return {
            "kind": cf["kind"],
            "counterfactual": dict(cf),
            "rung": rung,
            "elapsed_s": round(elapsed, 6),
            "baseline_cached": bool(use_cache),
            "base": _side(base_snap, base_digest, base_place, base_feas),
            "whatif": _side(cf_snap, cf_digest, cf_place, cf_feas),
            "newly_placeable": sorted(set(cf_place) - set(base_place)),
            "no_longer_placeable": sorted(set(base_place) - set(cf_place)),
            "feasibility_gained": sorted(cf_feas - base_feas),
            "feasibility_lost": sorted(base_feas - cf_feas),
            "displaced_seats": displaced_seats,
            "moved": moved,
            "headroom_delta": {
                lane: cf_head.get(lane, 0) - base_head.get(lane, 0)
                for lane in sorted(set(base_head) | set(cf_head))
                if cf_head.get(lane, 0) != base_head.get(lane, 0)
            },
        }


# ---------------------------------------------------------------------------
# explain assembly
# ---------------------------------------------------------------------------


def explain_arrays(batch_args, g: int, node_names: Optional[List[str]] = None,
                   lane_names: Optional[List[str]] = None, policy=None,
                   device="cuda") -> dict:
    """Run ``ops.explain.explain_gang`` on one batch's packed inputs on
    ``device`` and fold the result into the structured host payload (names
    attached when known; without a lane schema lanes are ``lane<i>``).
    ``policy`` is ``ClusterSnapshot.policy_payload()``'s ``(cols, terms,
    weights)`` or None."""
    from ..ops.convert import args_from_numpy, policy_from_numpy
    from ..ops.explain import explain_gang

    args = args_from_numpy(batch_args, device)
    dev = args[0].device
    n_bucket, lanes_n = args[0].shape
    n_real = len(node_names) if node_names else n_bucket
    kwargs = {}
    if policy is not None:
        cols, terms, weights = policy
        kwargs = {
            "policy_cols": policy_from_numpy(cols, dev),
            "policy_terms": tuple(terms),
            "policy_weights": tuple(weights),
        }
    res = explain_gang(*args, int(g), int(n_real), **kwargs)
    res = {k: v.cpu().numpy() for k, v in res.items()}
    lanes = list(lane_names) if lane_names else [f"lane{r}" for r in range(lanes_n)]

    def node_name(i: int) -> str:
        if node_names and 0 <= i < len(node_names):
            return node_names[i]
        return f"node{i}"

    binding = {
        lanes[r]: int(c) for r, c in enumerate(res["binding_counts"]) if int(c) > 0
    }
    binding_lane = max(binding, key=binding.get) if binding else None
    near = []
    for j, idx in enumerate(res["near_idx"]):
        idx = int(idx)
        if idx >= n_real:
            continue
        entry = {
            "node": node_name(idx),
            "capacity_entry": int(res["near_cap"][j]),
            "capacity_alone": int(res["near_cap_indep"][j]),
            "deficit": {
                lanes[r]: int(v) for r, v in enumerate(res["near_deficit"][j]) if int(v) > 0
            },
            "headroom": {lanes[r]: int(v) for r, v in enumerate(res["near_left"][j])},
        }
        if policy is not None:
            entry["policy_penalty"] = int(res["near_pen"][j])
        near.append(entry)
    return {
        "gang_index": int(g),
        "need": int(res["need"]),
        "feasible_alone": bool(res["feasible_indep"]),
        "feasible_at_entry": bool(res["feasible_entry"]),
        "nodes_indep": int(res["nodes_indep"]),
        "nodes_entry": int(res["nodes_entry"]),
        "excluded": {
            "fit_mask": int(res["masked_out"]),
            "policy_mask": int(res["policy_masked"]),
            "capacity": int(res["capacity_blocked"]),
        },
        "binding_lane": binding_lane,
        "blocked_by_lane": binding,
        "near_miss": near,
        "headroom_entry": {
            lanes[r]: round(float(v), 1) for r, v in enumerate(res["headroom_entry"])
        },
        "headroom_after_batch": {
            lanes[r]: round(float(v), 1) for r, v in enumerate(res["headroom_after"])
        },
    }


# ---------------------------------------------------------------------------
# the live observatory
# ---------------------------------------------------------------------------


class Observatory:
    """The per-process explain/what-if surface, constructed by an
    oracle-mode ScheduleOperation and registered process-wide for the
    /debug endpoints (utils.metrics).

    ``device`` is where explain and what-if run: the explicit argument,
    else the scorer's device (``operation.oracle.device``), else ``cuda``.
    It is resolved at the first query, so building an operation never
    raises for it."""

    def __init__(self, operation, device=None):
        self.operation = operation
        self._device = device
        self._lock = threading.Lock()
        self._engine: Optional[WhatIfEngine] = None  # guarded-by: _lock

    @property
    def device(self) -> torch.device:
        from ..ops.convert import resolve_device

        dev = self._device
        if dev is None:
            dev = getattr(self.operation.oracle, "device", None) or "cuda"
        return resolve_device(dev)

    @property
    def whatif_engine(self) -> WhatIfEngine:
        with self._lock:
            if self._engine is None:
                op = self.operation
                self._engine = WhatIfEngine(
                    holder_source=lambda: getattr(op.oracle, "_device_state", None),
                    policy_engine=op.policy,
                    device=self.device,
                )
            return self._engine

    # -- explain ------------------------------------------------------------

    def explain(self, gang: str) -> dict:
        from ..utils.trace import DEFAULT_FLIGHT_RECORDER
        from .operation import (
            deny_degraded_reason,
            deny_infeasible_reason,
            deny_reserved_reason,
        )

        DEFAULT_REGISTRY.counter(
            "bst_explain_queries_total",
            "Gang explain queries (/debug/explain + the explain subcommand)",
        ).inc()
        op = self.operation
        oracle = op.oracle
        if oracle is None:
            return {"error": "no oracle scorer in this process"}
        state = oracle._state
        if state is None:
            return {"error": "no oracle batch published yet"}
        snap = state.snapshot
        g = snap.group_index(gang)
        if g is None:
            return {"error": f"unknown gang {gang!r}", "known_gangs": len(snap.group_names)}
        out = explain_arrays(
            snap.device_args(), g, node_names=snap.node_names,
            lane_names=snap.schema.names, policy=snap.policy_payload(),
            device=self.device,
        )
        out["gang"] = gang
        out["batch"] = oracle.batches_run
        out["degraded"] = bool(getattr(oracle, "degraded", False))
        # refresh provenance: which path built the serving batch's inputs
        # (a keyframe, a scan or an event fold) at what pack generation.
        # The breakdown reads the snapshot's HOST arrays, which the
        # device-derived fit/order columns equal by construction
        delta = getattr(snap, "delta", None)
        if delta is not None:
            out["refresh"] = {
                "generation": int(delta.generation),
                "kind": delta.kind,
                "reason": delta.reason,
                "source": getattr(delta, "source", "scan"),
            }
        # PreFilter's denial records carry the capacity row's feasible-node
        # count, which is the INDEPENDENT count by construction
        out["feasible_nodes"] = out["nodes_indep"]

        placed = bool(state.result["placed"][g])
        feasible = bool(state.result["gang_feasible"][g])
        pgs = op.status_cache.get(gang)
        min_member = (
            pgs.pod_group.spec.min_member if pgs is not None
            else int(snap.groups[g].min_member)
        )
        if placed:
            verdict, reason = "placed", ""
            out["assignment"] = oracle.assignment(gang)
        elif out["degraded"]:
            # the conservative fallback batch denies ONLY provably
            # infeasible gangs; a feasible gang passes to the per-pod fit
            # checks, so explain must not invent a "reserved" denial
            if not feasible:
                verdict = "denied"
                reason = deny_degraded_reason(gang, min_member)
            else:
                verdict, reason = "pass", ""
                out["note"] = (
                    "degraded oracle: feasible gangs bypass PreFilter "
                    "and place through the per-pod scan"
                )
        elif feasible:
            verdict, reason = "denied", deny_reserved_reason(gang)
        else:
            verdict = "denied"
            reason = deny_infeasible_reason(gang, min_member)
        out["verdict"] = verdict
        out["deny_reason"] = reason

        # flight-recorder cross-stamp: the explanation must AGREE with the
        # recorded decision (same blame string, same feasible count)
        recs = DEFAULT_FLIGHT_RECORDER.snapshot(gang).get(gang, [])
        recorded = next(
            (r for r in reversed(recs) if r.get("phase") == "pre_filter"), None
        )
        if recorded is not None:
            out["recorded"] = {
                "reason": recorded.get("reason"),
                "feasible_nodes": recorded.get("feasible_nodes"),
                "batch": recorded.get("batch"),
                "ts": recorded.get("ts"),
            }
            if verdict == "denied":
                out["recorded_agrees"] = (
                    recorded.get("reason") == reason
                    and (
                        recorded.get("feasible_nodes") is None
                        or recorded.get("feasible_nodes") == out["feasible_nodes"]
                    )
                )
        if op.policy is not None and snap.policy_cols is not None:
            try:
                idx = [
                    snap.node_index(n["node"])
                    for n in out["near_miss"]
                    if snap.node_index(n["node"]) is not None
                ]
                terms = op.policy.explain(snap.policy_cols, g, idx)
                if terms:
                    out["policy_terms"] = terms
            except Exception:  # noqa: BLE001 — blame is evidence only
                pass
        if verdict == "denied":
            out["preemption"] = self._preempt_candidacy(gang, pgs, min_member)
        return out

    def _preempt_candidacy(self, gang: str, pgs, min_member: int) -> dict:
        """Would the preemption pass place this gang, and at whose expense:
        a DRY RUN of policy.preempt.PreemptionPlanner (no eviction, no
        counters beyond the planner's own)."""
        op = self.operation
        planner = op.preempt_planner
        if planner is None:
            return {
                "available": False,
                "reason": "policy preemption off (BST_POLICY without 'preempt')",
            }
        pod = pgs.pod if pgs is not None else None
        if pod is None:
            return {"available": False, "reason": "no representative pod observed yet"}
        if pod.spec.priority <= 0:
            return {
                "available": False,
                "reason": "tier-0 gangs never preempt (nothing is lower)",
            }
        try:
            need = max(
                min_member
                - pgs.pod_group.status.scheduled
                - len(pgs.matched_pod_nodes.items()),
                0,
            )
            plan = planner.plan(pod, op.cluster, op.status_cache, gang, need)
        except Exception as e:  # noqa: BLE001 — candidacy is evidence only
            return {"available": True, "error": f"{type(e).__name__}: {e}"}
        if plan is None:
            return {
                "available": True,
                "feasible": False,
                "reason": "no strictly-lower-tier victim set covers the need",
            }
        return {
            "available": True,
            "feasible": True,
            "victim_gangs": list(plan.gangs),
            "evicted_pods": plan.evicted_pods,
            "pooled_after": plan.pooled_after,
        }

    # -- what-if ------------------------------------------------------------

    def whatif(self, cf: dict, rung: str = "steady") -> dict:
        from .oracle_scorer import read_cluster_inputs

        op = self.operation
        # the version BEFORE the read: a change landing mid-read leaves the
        # cache keyed with the OLDER version, so the next query rebuilds
        # the baseline; the key also fingerprints the demands (gang churn
        # does not move the version counter)
        version_fn = getattr(op.cluster, "version", None)
        version = version_fn() if callable(version_fn) else None
        nodes, node_req, demands = read_cluster_inputs(op.cluster, op.status_cache)
        return self.whatif_engine.query_on(
            nodes, node_req, demands, cf, rung=rung,
            baseline_key=baseline_inputs_key(version, nodes, demands),
        )


# ---------------------------------------------------------------------------
# process-wide registry (the /debug endpoints)
# ---------------------------------------------------------------------------

_active: list = [None]


def set_active_observatory(obs: Optional[Observatory]) -> None:
    _active[0] = obs


def active_observatory() -> Optional[Observatory]:
    return _active[0]


def explain_debug_view(gang: Optional[str]) -> Tuple[dict, int]:
    """(payload, http status) for /debug/explain. A bare GET describes
    itself (the /debug/ index probe walks every endpoint parameterless)."""
    if not gang:
        return {
            "usage": "/debug/explain?gang=<namespace/name>",
            "serves": "structured denial breakdown for one gang "
                      "(docs/observability.md 'Explain')",
        }, 200
    obs = _active[0]
    if obs is None:
        return {
            "error": "no observatory in this process (explain serves the "
                     "oracle-mode scheduler; the sidecar has no gang state)"
        }, 200
    try:
        return obs.explain(gang), 200
    except Exception as e:  # noqa: BLE001 — a debug surface never crashes
        return {"error": f"{type(e).__name__}: {e}"}, 500


def whatif_debug_view(params: Dict[str, str]) -> Tuple[dict, int]:
    """(payload, http status) for /debug/whatif. A bare GET answers the
    query grammar (200); a malformed counterfactual or an unknown rung
    answers 400."""
    if not any(params.get(k) for k in _CF_PARAMS):
        return {
            "usage": _GRAMMAR + " [&rung=" + "|".join(WHATIF_RUNGS) + "]",
            "kinds": list(COUNTERFACTUAL_KINDS),
            "serves": "placement diff of one counterfactual scored on a "
                      "forked device-state copy (docs/observability.md "
                      "'What-if')",
        }, 200
    obs = _active[0]
    if obs is None:
        return {
            "error": "no observatory in this process (what-if serves the "
                     "oracle-mode scheduler; the sidecar has no cluster "
                     "state)"
        }, 200
    rung = params.get("rung") or "steady"
    try:
        cf = parse_counterfactual(params)
        return obs.whatif(cf, rung=rung), 200
    except ValueError as e:
        return {"error": str(e), "kinds": list(COUNTERFACTUAL_KINDS)}, 400
    except Exception as e:  # noqa: BLE001 — a debug surface never crashes
        return {"error": f"{type(e).__name__}: {e}"}, 500
