"""Group-membership labels and helpers (reference pkg/util/types.go:21-26,
pkg/util/k8s.go:50-91)."""

from __future__ import annotations

from typing import Optional, Tuple

from ..api.types import Pod, PodGroup

# The pod label (and annotation) that names the PodGroup a pod belongs to.
POD_GROUP_LABEL = "group.batch.scheduler.tpu"

# Policy-engine labels (batch_scheduler_tpu_torch.policy), carried on the
# gang's representative pod and projected into the packed policy columns
# at pack time:
# - affinity: "key:value", a soft preference for nodes carrying that label
#   (non-matching nodes pay the affinity penalty in the selection key; the
#   gang still places elsewhere when the matching nodes are full);
# - anti-affinity: "key:value", a HARD exclusion of nodes carrying that
#   label (masked out of the gang's capacity like a failed selector);
# - spread: any non-empty value opts the gang into the spread penalty:
#   nodes whose spread domain (PolicyConfig.spread_node_key) already holds
#   members of this gang rank behind emptier domains.
POLICY_AFFINITY_LABEL = "policy.batch.scheduler.tpu/affinity"
POLICY_ANTI_AFFINITY_LABEL = "policy.batch.scheduler.tpu/anti-affinity"
POLICY_SPREAD_LABEL = "policy.batch.scheduler.tpu/spread"

# Default gang wait time when neither the scheduler flag nor the group spec
# sets one (reference pkg/util/k8s.go:31).
DEFAULT_WAIT_SECONDS = 60.0


def pod_group_name(pod: Pod) -> Tuple[str, bool]:
    """Return (group name, participates) from the pod's group label
    (reference pkg/util/k8s.go:62-70)."""
    name = pod.metadata.labels.get(POD_GROUP_LABEL, "")
    return name, bool(name)


def get_wait_seconds(pg: Optional[PodGroup], default_max_schedule_seconds: Optional[float]) -> float:
    """Resolve the gang wait time: per-group spec.max_schedule_time wins, then
    the scheduler-wide flag, then DEFAULT_WAIT_SECONDS.

    Same resolution order as the reference (pkg/util/k8s.go:82-91), with its
    `||`-where-`&&`-was-meant null-deref hazard fixed rather than copied
    (reference k8s.go:84 dereferences a possibly-nil pointer).
    """
    wait = DEFAULT_WAIT_SECONDS
    if default_max_schedule_seconds is not None and default_max_schedule_seconds != 0:
        wait = float(default_max_schedule_seconds)
    if pg is not None and pg.spec.max_schedule_time is not None:
        return float(pg.spec.max_schedule_time)
    return wait
