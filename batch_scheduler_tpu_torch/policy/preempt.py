"""Preemption: the masked second scan that answers "which victim set frees
enough capacity for this denied gang, minimizing preempted pods".

The port of ``batch_scheduler_tpu/policy/preempt.py``. The victim search
is two passes over packed victim rows:

1. **Greedy pass**: victims in host order (priority ascending, pods
   ascending) are taken whole-gang (evicting ANY member breaks the
   victim's quorum, so the eviction unit is the gang) until the
   preemptor's pooled need-clipped capacity covers its need.
2. **Reprieve pass**: in reverse order, any taken victim whose removal
   still leaves the preemptor covered is given back.

The surviving set is inclusion-minimal by construction. The plan is a DRY
RUN: the control plane re-verifies it on the host against live cluster
state (``PreemptionPlanner.verify``) before any eviction.

Tier rule, checked in the pass: a victim is eligible only when its
priority class is STRICTLY below the preemptor's.

``plan_victims`` is plain PyTorch on the planner's device (the reference
runs two ``lax.scan`` passes; it has no Pallas kernel): a Python loop of
small tensor operations over the victims, off the batch path, with no
host read inside the loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.convert import resolve_device

__all__ = ["plan_victims", "PreemptionPlanner", "VictimPlan"]

_BIG = 2**30

# Victim-gang bucket sizes (powers of two, min 8) and a hard cap: a pass
# considering more than 512 victim gangs is a sign the cluster is
# misconfigured, not a planning problem.
_V_MIN, _V_MAX = 8, 512


def _v_bucket(v: int) -> int:
    b = _V_MIN
    while b < v and b < _V_MAX:
        b <<= 1
    return b


def _capacity(left, req):
    """Members of demand row ``req`` fitting each leftover row of ``left``
    [..., R]: plain int32 division (the planner's answer is re-verified
    on the host, as in the reference)."""
    safe = req.clamp(min=1)
    lpos = left.clamp(0, _BIG)
    per_lane = torch.where(req > 0, torch.div(lpos, safe, rounding_mode="floor"), _BIG)
    return per_lane.amin(dim=-1).to(torch.int32)


def _wrap32(x):
    """An int64 sum brought back to int32 with two's-complement wrap: the
    reference's int32 sums."""
    return x.to(torch.int32)


def plan_victims(left, fit_row, req, need, prio, valloc, vreq, vprio, vvalid, vorder):
    """One preemption plan on packed tensors (all on one device):

    - ``left[N, R]``    live leftover lanes (int32)
    - ``fit_row[N]``    0/1 nodes the preemptor may use at all
    - ``req[R]``        preemptor per-member demand row
    - ``need``          members still requiring seats (int)
    - ``prio``          preemptor priority class (int)
    - ``valloc[V, N]``  victim members per node
    - ``vreq[V, R]``    victim per-member demand rows
    - ``vprio[V]``      victim priority classes
    - ``vvalid[V]``     0/1 real victim rows (padding = 0)
    - ``vorder[V]``     host-computed greedy order (priority asc, pods asc)

    Returns ``(taken[V] bool, feasible bool tensor, pooled_after int32
    tensor)``: ``taken`` marks the inclusion-minimal victim set and
    ``feasible`` says the set covers the need (False: even evicting every
    eligible victim cannot seat the gang, and nothing is taken)."""
    dev = left.device
    need_t = torch.tensor(int(need), dtype=torch.int32, device=dev)
    eligible = (vvalid > 0) & (vprio < int(prio))  # never an equal-or-higher tier
    fit = fit_row.to(torch.int32)

    def pooled(left_c):
        cap = _capacity(left_c, req[None, :]) * fit
        return _wrap32(torch.minimum(cap, need_t).sum())

    order = [int(v) for v in vorder.tolist()]
    left_c = left
    have = pooled(left)
    taken_ord = []
    for v in order:
        freed = valloc[v][:, None] * vreq[v][None, :]  # [N, R]
        cand = left_c + freed
        take = eligible[v] & (have < need_t)
        left_c = torch.where(take, cand, left_c)
        have = torch.where(take, pooled(cand), have)
        taken_ord.append(take)
    feasible = have >= need_t
    taken = torch.zeros(valloc.shape[0], dtype=torch.bool, device=dev)
    if order:
        taken[torch.tensor(order, dtype=torch.long, device=dev)] = torch.stack(taken_ord)
    taken = taken & feasible  # an infeasible pass evicts nothing
    # reverse greedy order: give back the most expensive victims first
    for v in reversed(order):
        freed = valloc[v][:, None] * vreq[v][None, :]
        without = left_c - freed
        drop = taken[v] & (pooled(without) >= need_t) & feasible
        left_c = torch.where(drop, without, left_c)
        taken[v] = taken[v] & ~drop
    return taken, feasible, pooled(left_c)


@dataclass
class VictimPlan:
    """One dry-run preemption plan, ready for the control plane's
    verify-then-commit transaction."""

    preemptor: str  # gang full_name (or pod name for non-gang preemptors)
    need: int
    gangs: List[str] = field(default_factory=list)
    # victim gang full_name -> its member pods (the eviction unit)
    pods_by_gang: Dict[str, list] = field(default_factory=dict)
    feasible: bool = False
    pooled_after: int = 0
    plan_seconds: float = 0.0

    @property
    def evicted_pods(self) -> int:
        return sum(len(p) for p in self.pods_by_gang.values())

    def victims(self) -> list:
        out = []
        for pods in self.pods_by_gang.values():
            out.extend(pods)
        return out


class PreemptionPlanner:
    """Host packer and verifier around ``plan_victims``, which runs on
    ``device`` (``cuda`` unless the caller passes ``cpu``).

    Victim rows are built from live cluster state (pods grouped by gang
    per node); the device answers the minimal set; ``verify`` re-checks
    the freed capacity against the same live state with the control
    plane's own resource math (core.resources): the dry-run half of the
    dry-run/commit transaction."""

    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = resolve_device(device)

    # -- victim harvest -----------------------------------------------------

    def _harvest(self, cluster, status_cache, preemptor_gang: str, preemptor_prio: int):
        """Group every gang pod bound or assumed on the cluster into victim
        candidates (full_name -> {node -> [pods]}), with each gang's tier
        (its highest member priority), honoring the phase rule under
        ``protect_running`` (the pass re-checks the tier rule)."""
        from ..utils.labels import pod_group_name

        victims: Dict[str, Dict[str, list]] = {}
        prio: Dict[str, int] = {}
        for node in cluster.list_nodes():
            for pod in cluster.pods_on(node.metadata.name):
                gname, is_gang = pod_group_name(pod)
                if not is_gang:
                    continue  # online pods are never policy-tier victims
                full = f"{pod.metadata.namespace}/{gname}"
                if full == preemptor_gang:
                    continue  # no self-preemption
                victims.setdefault(full, {}).setdefault(node.metadata.name, []).append(pod)
                # gang tier = its highest member priority: one
                # equal-or-higher member protects the whole gang
                prio[full] = max(prio.get(full, -1), pod.spec.priority)
        if self.config.protect_running and status_cache is not None:
            from ..api.types import PodGroupPhase

            for full in list(victims):
                pgs = status_cache.get(full)
                if pgs is not None and pgs.pod_group.status.phase in (
                    PodGroupPhase.SCHEDULED,
                    PodGroupPhase.RUNNING,
                ):
                    del victims[full]
        return victims, prio

    def plan(self, pod, cluster, status_cache, full_name: str,
             need: int) -> Optional[VictimPlan]:
        """Dry-run one preemption plan for ``pod``'s denied gang. Returns
        None when nothing is evictable or even full eviction cannot seat
        the gang."""
        from ..core import resources as rmath

        t0 = time.perf_counter()
        preemptor_prio = int(pod.spec.priority)
        victims, vprio_map = self._harvest(cluster, status_cache, full_name, preemptor_prio)
        victims = {
            f: nodes for f, nodes in victims.items()
            if vprio_map.get(f, 0) < preemptor_prio
        }
        if not victims or need <= 0:
            return None

        nodes = cluster.list_nodes()
        node_idx = {n.metadata.name: i for i, n in enumerate(nodes)}
        names = sorted(
            {k for n in nodes for k in n.status.allocatable}
            | set(pod.resource_require())
            | {
                k
                for per_node in victims.values()
                for pods in per_node.values()
                for k in pods[0].resource_require()
            }
            | {"pods"}
        )
        lane = {k: i for i, k in enumerate(names)}
        n_count, r_count = len(nodes), len(names)

        def row(d: Dict[str, int]) -> np.ndarray:
            out = np.zeros(r_count, np.int32)
            for k, v in d.items():
                out[lane[k]] = min(int(v), _BIG)
            return out

        left = np.zeros((n_count, r_count), np.int64)
        fit_row = np.zeros(n_count, np.int32)
        for i, node in enumerate(nodes):
            left_d = rmath.single_node_left(
                node, cluster.node_requested(node.metadata.name), None
            )
            left[i] = row(left_d)
            fit_row[i] = int(not node.spec.unschedulable and rmath.check_fit(pod, node))
        left = np.clip(left, -_BIG, _BIG).astype(np.int32)

        req_d = dict(pod.resource_require())
        req_d["pods"] = req_d.get("pods", 0) + 1
        req = row(req_d)

        vnames = sorted(victims)
        v = len(vnames)
        vb = _v_bucket(v)
        valloc = np.zeros((vb, n_count), np.int32)
        vreq = np.zeros((vb, r_count), np.int32)
        vprio = np.zeros(vb, np.int32)
        vvalid = np.zeros(vb, np.int32)
        vpods = np.zeros(vb, np.int32)
        for i, full in enumerate(vnames):
            per_node = victims[full]
            any_pod = next(iter(per_node.values()))[0]
            vr = dict(any_pod.resource_require())
            vr["pods"] = vr.get("pods", 0) + 1
            vreq[i] = row(vr)
            vprio[i] = vprio_map.get(full, 0)
            vvalid[i] = 1
            for node_name, pods in per_node.items():
                ni = node_idx.get(node_name)
                if ni is not None:
                    valloc[i, ni] = len(pods)
                    vpods[i] += len(pods)
        # greedy order: lowest tier first, then fewest pods (minimize
        # preempted pods), then name order (deterministic); padding last
        order = sorted(
            range(vb),
            key=lambda i: (
                -vvalid[i],
                int(vprio[i]),
                int(vpods[i]),
                vnames[i] if i < v else "~",
            ),
        )
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        taken, feasible, pooled_after = plan_victims(
            up(left), up(fit_row), up(req), min(need, _BIG), preemptor_prio,
            up(valloc), up(vreq), up(vprio), up(vvalid), up(np.array(order, np.int32)),
        )
        taken = taken.cpu().numpy()
        if not bool(feasible):
            return None
        plan = VictimPlan(
            preemptor=full_name,
            need=int(need),
            feasible=True,
            pooled_after=int(pooled_after),
            plan_seconds=time.perf_counter() - t0,
        )
        for i in range(v):
            if taken[i]:
                full = vnames[i]
                plan.gangs.append(full)
                plan.pods_by_gang[full] = [p for pods in victims[full].values() for p in pods]
        return plan if plan.gangs else None

    # -- dry-run verification ----------------------------------------------

    def verify(self, plan: VictimPlan, pod, cluster) -> bool:
        """Re-verify the plan on the host against LIVE cluster state with
        the control plane's own resource math: after removing every victim
        pod's charge, the preemptor's pooled member capacity must cover
        its need. The commit half runs only on a True verdict."""
        from ..core import resources as rmath

        victim_by_node: Dict[str, list] = {}
        for pods in plan.pods_by_gang.values():
            for vp in pods:
                node = vp.spec.node_name
                if node is None:
                    # assumed-but-unbound victims release via their Permit
                    # reject; their charge is found through cluster state
                    continue
                victim_by_node.setdefault(node, []).append(vp)
        require = dict(pod.resource_require())
        require["pods"] = require.get("pods", 0) + 1
        seats = 0
        for node in cluster.list_nodes():
            if node.spec.unschedulable or not rmath.check_fit(pod, node):
                continue
            left = dict(
                rmath.single_node_left(
                    node, cluster.node_requested(node.metadata.name), None
                )
            )
            for vp in victim_by_node.get(node.metadata.name, ()):
                vreq = dict(vp.resource_require())
                vreq["pods"] = vreq.get("pods", 0) + 1
                left = rmath.add_resources(left, vreq)
            # count members fitting this node under the freed leftover
            while seats < plan.need and rmath.resource_satisfied(left, require):
                left = rmath.add_resources(left, {k: -v for k, v in require.items()})
                seats += 1
            if seats >= plan.need:
                return True
        return seats >= plan.need
