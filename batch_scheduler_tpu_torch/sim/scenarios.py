"""Scenarios: the reference README's resource-race demo, the mixed-tier
preemption scenario, the node / group / member-pod constructors they and
the smoke drive use, and the XL tier's packed scan operands
(``XLClusterSpec``, ``xl_scan_operands``, ``xl_churn_burst``).

Copies of the reference's ``batch_scheduler_tpu/sim/scenarios.py``
builders. The race scenario reproduces the README demo (two minMember=5
groups racing for ~7.1 free CPUs on one node: exactly one group
schedules).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.quantity import parse_resource_list
from ..api.types import (
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupSpec,
    PodSpec,
    new_uid,
)
from ..utils.labels import POD_GROUP_LABEL

__all__ = [
    "make_sim_node",
    "make_sim_group",
    "make_member_pods",
    "race_scenario",
    "readback_tail_scenarios",
    "spot_vs_guaranteed_scenario",
    "synthetic_cluster",
    "SyntheticSpec",
    "tenant_oracle_stream",
    "XLClusterSpec",
    "xl_scan_operands",
    "xl_churn_burst",
]


def make_sim_node(
    name: str,
    allocatable: Optional[Dict] = None,
    labels: Optional[Dict] = None,
    taints: Optional[List] = None,
) -> Node:
    alloc = parse_resource_list(
        allocatable or {"cpu": "32", "memory": "128Gi", "pods": 110}, floor=True
    )
    return Node(
        metadata=ObjectMeta(name=name, uid=new_uid("node"), labels=labels or {}),
        spec=NodeSpec(taints=list(taints or [])),
        status=NodeStatus(allocatable=alloc, capacity=dict(alloc)),
    )


def make_sim_group(
    name: str,
    min_member: int,
    namespace: str = "default",
    max_schedule_time: Optional[float] = None,
    creation_ts: float = 0.0,
) -> PodGroup:
    return PodGroup(
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            uid=new_uid("pg"),
            creation_timestamp=creation_ts,
        ),
        spec=PodGroupSpec(
            min_member=min_member, max_schedule_time=max_schedule_time
        ),
    )


def make_member_pods(
    group: str,
    count: int,
    requests: Optional[Dict] = None,
    namespace: str = "default",
    priority: int = 0,
    node_selector: Optional[Dict] = None,
    tolerations: Optional[List] = None,
) -> List[Pod]:
    return [
        Pod(
            metadata=ObjectMeta(
                name=f"{group}-{i}",
                namespace=namespace,
                uid=new_uid("pod"),
                labels={POD_GROUP_LABEL: group},
            ),
            spec=PodSpec(
                containers=[
                    Container.from_raw(requests=requests or {"cpu": "1"})
                ],
                priority=priority,
                node_selector=dict(node_selector or {}),
                tolerations=list(tolerations or []),
            ),
        )
        for i in range(count)
    ]


def race_scenario() -> Tuple[List[Node], List[PodGroup], Dict[str, List[Pod]]]:
    """BASELINE config 1: one 8-cpu node with 0.9 cpu of system pods, two
    minMember=5 gangs of 1-cpu pods (the reference README "Example")."""
    node = make_sim_node("node-1", {"cpu": "8", "memory": "32Gi", "pods": "110"})
    # wall-clock creation stamps (offset for deterministic ordering): the
    # controller's 48h GC guard compares them against schedule_start_time
    now = time.time()
    groups = [
        make_sim_group("web-group-race1", 5, creation_ts=now - 0.002),
        make_sim_group("web-group-race2", 5, creation_ts=now - 0.001),
    ]
    pods = {
        g.metadata.name: make_member_pods(g.metadata.name, 5, {"cpu": "1"})
        for g in groups
    }
    return [node], groups, pods


def readback_tail_scenarios():
    """Inputs of the compact-readback tail checks: a gang spanning more
    distinct nodes than the assignment's top-K with remaining near the
    packed halfword, and a single node whose per-member count exceeds it.

    Returns ((wide_nodes, wide_groups), (big_nodes, big_groups))."""
    from ..ops.snapshot import GroupDemand

    wide_nodes = [
        make_sim_node(
            f"w{i:03d}", {"cpu": "64", "memory": "256Gi", "pods": "200"}
        )
        for i in range(512)
    ]
    wide_groups = [
        GroupDemand(
            full_name="default/wide",
            min_member=60000,
            member_request={"cpu": 100},
            creation_ts=0.0,
        )
    ]
    big_nodes = [
        make_sim_node(
            "big", {"cpu": "100000", "memory": "1024Gi", "pods": "70000"}
        )
    ]
    big_groups = [
        GroupDemand(
            full_name="default/huge",
            min_member=66000,
            member_request={"cpu": 1},
            creation_ts=0.0,
        )
    ]
    return (wide_nodes, wide_groups), (big_nodes, big_groups)


def spot_vs_guaranteed_scenario(
    nodes: int = 2,
    node_cpu: str = "8",
    spot_gangs: int = 2,
    guaranteed_gangs: int = 1,
    min_member: int = 4,
    member_cpu: str = "2",
    guaranteed_priority: int = 10,
):
    """Mixed-tier preemption scenario: tier-0 "spot" gangs sized to fill the
    cluster, then tier-``guaranteed_priority`` "guaranteed" gangs that can
    only place by evicting spot capacity through the policy engine's
    preemption pass. Defaults: 2 nodes x 8 cpu, 2 spot gangs x 4 members x
    2 cpu = 16 cpu (exactly full), 1 guaranteed gang needing 8 cpu.

    Returns ``(nodes, groups, pods)`` with the guaranteed pods created
    LAST (the caller controls arrival order: create the spot gangs first,
    bind them, then create the guaranteed ones, so that preemption and not
    queue priority places them)."""
    now = time.time()
    node_objs = [
        make_sim_node(
            f"node-{i:03d}",
            {"cpu": node_cpu, "memory": "32Gi", "pods": "110"},
            labels={"zone": f"z{i % 2}"},
        )
        for i in range(nodes)
    ]
    groups, pods = [], {}
    for s in range(spot_gangs):
        name = f"spot-{s:03d}"
        groups.append(make_sim_group(name, min_member, creation_ts=now - 1.0 + s * 1e-3))
        pods[name] = make_member_pods(name, min_member, {"cpu": member_cpu}, priority=0)
    for g in range(guaranteed_gangs):
        name = f"guaranteed-{g:03d}"
        groups.append(make_sim_group(name, min_member, creation_ts=now + g * 1e-3))
        pods[name] = make_member_pods(
            name, min_member, {"cpu": member_cpu}, priority=guaranteed_priority,
        )
    return node_objs, groups, pods


@dataclass
class XLClusterSpec:
    """The 100k-node XL scale tier (the hierarchical top-K scan's
    deployment): packed scan operands, not API objects. The reference's
    spec, field for field:

    - zipf-sized gangs (``zipf_a``, clipped to [``gang_min``,
      ``gang_cap``]): most gangs place on a handful of nodes, a few span
      hundreds;
    - hot-pool skew (``hot_fraction`` of the nodes at ``hot_load``, the rest
      at ``cold_load``), so the tightest nodes concentrate in the hot pool;
    - churn bursts (``churn_fraction``, ``xl_churn_burst``) between scans;
    - ``request_profiles`` > 1 mixes member-request rows, so waves stop
      being uniform and the speculative branch carries load."""

    num_nodes: int = 100_000
    num_groups: int = 4096
    lanes: int = 6
    zipf_a: float = 1.4
    gang_min: int = 2
    gang_cap: int = 512
    hot_fraction: float = 0.125
    hot_load: float = 0.85
    cold_load: float = 0.25
    churn_fraction: float = 0.02
    request_profiles: int = 1
    seed: int = 0


def xl_scan_operands(spec: XLClusterSpec):
    """Packed assignment-scan operands of one XL batch, ``(left[N, R],
    group_req[G, R], remaining[G], fit_mask[1, N], order[G])``, int32 numpy,
    drawn from ``spec.seed`` in the reference's order (so both packages
    give the same arrays). Lane 0 is cpu-like (millicores), lane 1
    memory-like (MiB), lane 2 pod slots, the rest sparse extended lanes."""
    import numpy as np

    rng = np.random.default_rng(spec.seed)
    n, g, r = spec.num_nodes, spec.num_groups, spec.lanes
    cpu = rng.choice([32_000, 64_000, 96_000], size=n, p=[0.2, 0.6, 0.2])
    lanes = [cpu, cpu * 4, np.full(n, 110)]
    for _ in range(r - 3):
        # a small slice of the nodes expose an extended lane
        lanes.append(np.where(rng.random(n) < 0.05, 8, 0))
    capacity = np.stack(lanes[:r], axis=1).astype(np.int64)
    hot = rng.random(n) < spec.hot_fraction
    load = np.where(hot, spec.hot_load, spec.cold_load)
    load = load * rng.uniform(0.85, 1.15, size=n)
    used = (capacity.astype(np.float64) * load[:, None]).astype(np.int64)
    left = np.clip(capacity - used, 0, None).astype(np.int32)

    sizes = rng.zipf(spec.zipf_a, size=g)
    remaining = np.clip(sizes + spec.gang_min - 1, spec.gang_min, spec.gang_cap).astype(np.int32)
    profiles = []
    for p in range(max(1, spec.request_profiles)):
        row = np.zeros(r, np.int32)
        row[0] = 4_000 + 1_000 * p
        row[1] = 8_192 + 2_048 * p
        row[2] = 1
        profiles.append(row)
    which = rng.integers(0, len(profiles), size=g)
    if len(profiles) == 1:
        which[:] = 0
    group_req = np.stack([profiles[i] for i in which]).astype(np.int32)
    fit_mask = np.ones((1, n), np.int32)
    order = rng.permutation(g).astype(np.int32)
    return left, group_req, remaining, fit_mask, order


def xl_churn_burst(spec: XLClusterSpec, left, step: int):
    """One churn burst on the packed leftover: a ``churn_fraction`` cohort
    of nodes has its lanes scaled by a factor in [0.5, 1.5) (gangs finishing
    or landing between scans). Deterministic in ``(spec.seed, step)``."""
    import numpy as np

    rng = np.random.default_rng((spec.seed << 16) ^ (step + 1))
    cohort = rng.random(left.shape[0]) < spec.churn_fraction
    scale = rng.uniform(0.5, 1.5, size=(int(cohort.sum()), 1))
    out = np.array(left, copy=True)
    out[cohort] = np.clip(out[cohort].astype(np.float64) * scale, 0, 2**30 - 1).astype(np.int32)
    return out


@dataclass
class SyntheticSpec:
    num_nodes: int
    num_groups: int
    members_per_group: int
    node_shape: Dict = field(
        default_factory=lambda: {"cpu": "64", "memory": "256Gi", "pods": "110"}
    )
    member_request: Dict = field(default_factory=lambda: {"cpu": "4", "memory": "8Gi"})
    extended: Optional[Dict] = None  # e.g. {"nvidia.com/gpu": 8} per node
    member_extended: Optional[Dict] = None  # e.g. {"nvidia.com/gpu": 1}
    priority_classes: int = 1
    seed: int = 0


def synthetic_cluster(
    spec: SyntheticSpec,
) -> Tuple[List[Node], List[PodGroup], Dict[str, List[Pod]]]:
    """Generator for BASELINE configs 2-5: N nodes, G gangs, mixed
    priorities, optional extended resources."""
    rng = random.Random(spec.seed)
    node_shape = dict(spec.node_shape)
    if spec.extended:
        node_shape.update(spec.extended)
    nodes = [
        make_sim_node(f"node-{i:05d}", node_shape) for i in range(spec.num_nodes)
    ]
    member_request = dict(spec.member_request)
    if spec.member_extended:
        member_request.update(spec.member_extended)
    groups, pods = [], {}
    base_ts = time.time() - spec.num_groups * 1e-3
    for g in range(spec.num_groups):
        name = f"gang-{g:05d}"
        prio = rng.randrange(spec.priority_classes) if spec.priority_classes > 1 else 0
        pg = make_sim_group(
            name, spec.members_per_group, creation_ts=base_ts + g * 1e-3
        )
        groups.append(pg)
        pods[name] = make_member_pods(
            name, spec.members_per_group, member_request, priority=prio
        )
    return nodes, groups, pods


def tenant_oracle_stream(tenant: int, batches: int, nodes: int = 256,
                         gangs: int = 32, lanes: int = 4, seed: int = 0):
    """Deterministic per-tenant oracle request stream for the multi-client
    coalescer sim (``sim.harness.drive_multi_client``): ``batches`` ScheduleRequests
    over one synthetic [nodes, lanes] cluster with light per-batch churn
    (a few requested rows and gang remainders move each step). Pure
    numpy — the coalescer acceptance compares plan digests between a
    coalescing sidecar and dedicated sidecars, so the SAME stream must be
    replayable against both; everything derives from (tenant, seed, batch
    index), nothing from wall-clock."""
    import numpy as np

    from ..service.protocol import ScheduleRequest

    rng = random.Random(seed * 1000003 + tenant)
    np_rng = np.random.RandomState(seed * 9176 + tenant)
    alloc = np_rng.randint(8, 96, size=(nodes, lanes)).astype("int32")
    requested = np_rng.randint(0, 6, size=(nodes, lanes)).astype("int32")
    group_req = np_rng.randint(1, 5, size=(gangs, lanes)).astype("int32")
    remaining = np_rng.randint(1, 6, size=gangs).astype("int32")
    out = []
    for b in range(batches):
        # churn: a handful of node rows and one gang's demand move
        for _ in range(4):
            row = rng.randrange(nodes)
            requested[row] = np_rng.randint(0, 6, size=lanes)
        g = rng.randrange(gangs)
        remaining[g] = rng.randrange(1, 6)
        out.append(
            ScheduleRequest(
                alloc=alloc.copy(),
                requested=requested.copy(),
                group_req=group_req.copy(),
                remaining=remaining.copy(),
                fit_mask=np.ones((1, nodes), dtype=bool),
                group_valid=np.ones(gangs, dtype=bool),
                order=np.arange(gangs, dtype="int32"),
                min_member=remaining.copy(),
                scheduled=np.zeros(gangs, dtype="int32"),
                matched=np.zeros(gangs, dtype="int32"),
                ineligible=np.zeros(gangs, dtype=bool),
                creation_rank=np.arange(gangs, dtype="int32"),
            )
        )
    return out
