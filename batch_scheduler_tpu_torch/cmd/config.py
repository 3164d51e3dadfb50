"""Scheduler configuration file: the analog of ``KubeSchedulerConfiguration``.
The port's copy of ``batch_scheduler_tpu/cmd/config.py``.

The reference is configured by a three-layer stack — kube-scheduler flags,
a scheduler-config JSON choosing extension points, and ``pluginConfig.args``
unmarshalled into the plugin's ``Configuration`` struct (reference
deploy/scheduler/config/batch_scheduler_config.json:7-44,
pkg/scheduler/batch/batchscheduler.go:71-75,377-383). This module parses the
same JSON shape (and our superset) into the internal
:class:`~batch_scheduler_tpu_torch.plugin.factory.PluginConfig` plus the enabled
extension-point set consumed by
:class:`~batch_scheduler_tpu_torch.plugin.gate.ExtensionPointGate`.

``max_schedule_time`` keeps the reference's **minutes** interpretation
(batchscheduler.go:406). The ``scorer`` arg is the north-star ``--scorer=tpu``
gate: "oracle" (the batch on the card) or "serial" (reference-parity
in-process path). ``oracle_compile_warmer: true`` turns on the in-process
scorer's bucket warmer (``ops.bucketing.CompileWarmer``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import FrozenSet, Optional

from ..plugin.factory import PluginConfig
from ..plugin.gate import ALL_EXTENSION_POINTS, DEFAULT_ENABLED

__all__ = ["SchedulerConfiguration", "load_scheduler_config", "PLUGIN_NAME"]

PLUGIN_NAME = "batch-scheduler"

_ACCEPTED_KINDS = {"SchedulerConfiguration", "KubeSchedulerConfiguration"}


def _require_bool(args: dict, key: str, default: bool = False) -> bool:
    """Strict JSON-boolean read: ``bool("false")`` is True, so a string here
    would silently mean the opposite of what the operator wrote."""
    value = args.get(key, default)
    if not isinstance(value, bool):
        raise ValueError(
            f"pluginConfig args.{key} must be a JSON boolean, got {value!r}"
        )
    return value


@dataclass
class SchedulerConfiguration:
    plugin_config: PluginConfig = field(default_factory=PluginConfig)
    enabled_points: FrozenSet[str] = DEFAULT_ENABLED
    # Accepted for reference parity; unused (no external API server here).
    kubeconfig: str = ""

    @classmethod
    def from_dict(cls, doc: dict) -> "SchedulerConfiguration":
        kind = doc.get("kind", "SchedulerConfiguration")
        if kind not in _ACCEPTED_KINDS:
            raise ValueError(f"unsupported config kind: {kind!r}")

        enabled = set()
        plugins = doc.get("plugins")
        if plugins is None:
            enabled = set(DEFAULT_ENABLED)
        else:
            for point, spec in plugins.items():
                if point not in ALL_EXTENSION_POINTS:
                    raise ValueError(f"unknown extension point: {point!r}")
                names = [e.get("name") for e in (spec or {}).get("enabled", [])]
                if PLUGIN_NAME in names:
                    enabled.add(point)

        args = {}
        for entry in doc.get("pluginConfig", []):
            if entry.get("name") == PLUGIN_NAME:
                args = entry.get("args") or {}

        max_minutes: Optional[float] = None
        if args.get("max_schedule_time") is not None:
            max_minutes = float(args["max_schedule_time"])

        plugin_config = PluginConfig(
            max_schedule_minutes=max_minutes,
            scorer=args.get("scorer", "oracle"),
            controller_workers=int(args.get("controller_workers", 10)),
            leader_poll_seconds=float(args.get("leader_poll_seconds", 1.0)),
            min_batch_interval_seconds=float(
                args.get("min_batch_interval_seconds", 0.0)
            ),
            oracle_background_refresh=_require_bool(
                args, "oracle_background_refresh"
            ),
            oracle_dispatch_ahead=_require_bool(args, "oracle_dispatch_ahead"),
            oracle_compile_warmer=_require_bool(args, "oracle_compile_warmer"),
        )
        return cls(
            plugin_config=plugin_config,
            enabled_points=frozenset(enabled),
            kubeconfig=(doc.get("clientConnection") or {}).get("kubeconfig", "")
            or args.get("kube_config", ""),
        )


def load_scheduler_config(path: Optional[str]) -> SchedulerConfiguration:
    """Load a scheduler config JSON; None -> all defaults (the reference's
    shipped extension points + oracle scorer)."""
    if path is None:
        return SchedulerConfiguration()
    with open(path, "r", encoding="utf-8") as fh:
        return SchedulerConfiguration.from_dict(json.load(fh))
