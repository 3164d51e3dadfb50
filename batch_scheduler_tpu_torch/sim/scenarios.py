"""Scenarios: the reference README's resource-race demo, the mixed-tier
preemption scenario, and the node / group / member-pod constructors they
and the smoke drive use.

Copies of the reference's ``batch_scheduler_tpu/sim/scenarios.py``
builders. The race scenario reproduces the README demo (two minMember=5
groups racing for ~7.1 free CPUs on one node: exactly one group
schedules).
"""

from __future__ import annotations

import time
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

__all__ = ["make_sim_node", "make_sim_group", "make_member_pods", "race_scenario",
           "spot_vs_guaranteed_scenario"]


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
