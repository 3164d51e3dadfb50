"""The policy engine: priority-tiered preemption, affinity and spread as
composable scoring terms over the batch's packed columns.

- policy.terms   — the term registry and packed-column conventions
- policy.engine  — PolicyConfig / PolicyEngine (environment knobs,
                   fingerprint, counters)
- policy.preempt — the victim planner and its dry-run verifier

The port of ``batch_scheduler_tpu/policy``. Still to come (the
observability half, ROADMAP Queue 1 item 7b): ``PolicyEngine.explain``
and ``policy_debug_view``.
"""

from .engine import PolicyConfig, PolicyEngine, active_engine, active_fingerprint
from .preempt import PreemptionPlanner, VictimPlan, plan_victims
from .terms import (
    DOMAIN_BUCKETS,
    HASH_LANES,
    SCORING_TERMS,
    TERM_REGISTRY,
    compose_terms,
    label_hash,
    node_policy_row,
    parse_label_ref,
    register_term,
)

__all__ = [
    "PolicyConfig",
    "PolicyEngine",
    "PreemptionPlanner",
    "VictimPlan",
    "plan_victims",
    "active_engine",
    "active_fingerprint",
    "DOMAIN_BUCKETS",
    "HASH_LANES",
    "SCORING_TERMS",
    "TERM_REGISTRY",
    "compose_terms",
    "label_hash",
    "node_policy_row",
    "parse_label_ref",
    "register_term",
]
