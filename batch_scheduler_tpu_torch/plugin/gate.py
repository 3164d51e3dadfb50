"""Extension-point gate: enable/disable plugin callbacks per config.

The reference ships a ``KubeSchedulerConfiguration`` enabling the plugin at
exactly four extension points — ``preFilter``, ``permit``, ``postBind``,
``queueSort`` — while its implemented ``Filter`` is deliberately NOT enabled
(reference deploy/scheduler/config/batch_scheduler_config.json:7-36 vs
pkg/scheduler/batch/batchscheduler.go:151-157). This wrapper reproduces that
configuration surface: it delegates only the enabled points and no-ops the
rest, so the shipped-config behavior (and any other combination) is testable.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Tuple

from ..framework.types import StatusCode

__all__ = ["ExtensionPointGate", "ALL_EXTENSION_POINTS", "DEFAULT_ENABLED"]

ALL_EXTENSION_POINTS = frozenset(
    {"queueSort", "preFilter", "filter", "score", "permit", "postBind"}
)
# The reference's shipped config (batch_scheduler_config.json:7-36).
DEFAULT_ENABLED = frozenset({"queueSort", "preFilter", "permit", "postBind"})


class ExtensionPointGate:
    """Delegates enabled extension points to a BatchSchedulingPlugin, no-ops
    the rest. Lifecycle and cache-maintenance calls always pass through."""

    def __init__(self, plugin, enabled: Iterable[str] = DEFAULT_ENABLED):
        enabled = frozenset(enabled)
        unknown = enabled - ALL_EXTENSION_POINTS
        if unknown:
            raise ValueError(f"unknown extension points: {sorted(unknown)}")
        self.plugin = plugin
        self.enabled: FrozenSet[str] = enabled

    # -- gated extension points -------------------------------------------

    def less(self, info1, info2) -> bool:
        if "queueSort" in self.enabled:
            return self.plugin.less(info1, info2)
        return info1.timestamp < info2.timestamp

    def pre_filter(self, pod) -> None:
        if "preFilter" in self.enabled:
            self.plugin.pre_filter(pod)

    def filter(self, pod, node_name: str) -> None:
        if "filter" in self.enabled:
            self.plugin.filter(pod, node_name)

    def score(self, pod, node_name: str) -> int:
        if "score" in self.enabled:
            return self.plugin.score(pod, node_name)
        return 0

    def permit(self, pod, node_name: str) -> Tuple[StatusCode, float]:
        if "permit" in self.enabled:
            return self.plugin.permit(pod, node_name)
        return (StatusCode.SUCCESS, 0.0)

    def post_bind(self, pod, node_name: str) -> None:
        if "postBind" in self.enabled:
            self.plugin.post_bind(pod, node_name)

    # -- always pass through ----------------------------------------------

    def __getattr__(self, name):
        return getattr(self.plugin, name)
