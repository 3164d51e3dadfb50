"""PolicyEngine: configuration, fingerprinting and the host-side face of
the policy subsystem.

The port of ``batch_scheduler_tpu/policy/engine.py``. The engine owns
WHICH terms are enabled and with what weights; the scoring math lives in
policy.terms (composed into the assignment scan: the policy variant of
the serial scan kernel on the card) and the preemption pass in
policy.preempt. Everything here is host bookkeeping: the environment
parse (a mistyped knob degrades to "policies off", never a failed
batch), the config fingerprint that audit records carry, the
counters, ``PolicyEngine.explain`` (the flight recorder's per-term blame,
computed on the snapshot's host columns) and ``policy_debug_view`` (the
``/debug/policy`` view).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .terms import DOMAIN_BUCKETS, HASH_LANES, SCORING_TERMS, TERM_REGISTRY

__all__ = [
    "PolicyConfig",
    "PolicyEngine",
    "set_active_engine",
    "active_engine",
    "active_fingerprint",
    "policy_debug_view",
]

_POLICY_ENV = "BST_POLICY"
_env_warned = [False]


@dataclass(frozen=True)
class PolicyConfig:
    """One policy configuration: the enabled term set and weights.

    ``terms`` is the sorted tuple of enabled term names (from
    policy.terms.TERM_REGISTRY). Empty = the policy engine is OFF and
    every batch runs the exact pre-policy code path.
    """

    terms: Tuple[str, ...] = ()
    # Soft-affinity penalty added to the tightness bucket of non-matching
    # nodes.
    affinity_weight: int = 32
    # Spread penalty per already-occupied domain member, saturating at
    # spread_cap occupants.
    spread_weight: int = 8
    spread_cap: int = 3
    # Node label whose value defines the spread domain.
    spread_node_key: str = "zone"
    # Preemption eligibility: when False (spot semantics, the default) a
    # strictly-lower-tier gang may be evicted even after its gang released
    # (Scheduled/Running); True restores the reference's phase protection.
    protect_running: bool = False

    @property
    def enabled(self) -> bool:
        return bool(self.terms)

    @property
    def preemption(self) -> bool:
        return "preempt" in self.terms

    @property
    def scoring_terms(self) -> Tuple[str, ...]:
        return tuple(t for t in self.terms if t in SCORING_TERMS)

    @property
    def weights(self) -> Tuple[int, int, int]:
        return (
            int(self.affinity_weight),
            int(self.spread_weight),
            int(self.spread_cap),
        )

    def fingerprint(self) -> dict:
        """The policy slice of the execution config fingerprint
        (utils.audit.config_fingerprint): the dict itself plus a 16-hex
        sha over it, equal key for key to the reference's."""
        cfg = {
            "terms": list(self.terms),
            "affinity_weight": self.affinity_weight,
            "spread_weight": self.spread_weight,
            "spread_cap": self.spread_cap,
            "spread_node_key": self.spread_node_key,
            "protect_running": self.protect_running,
        }
        digest = hashlib.sha256(
            json.dumps(cfg, sort_keys=True).encode()
        ).hexdigest()
        cfg["fingerprint"] = digest[:16]
        return cfg

    @classmethod
    def from_env(cls) -> "PolicyConfig":
        """Parse BST_POLICY ("affinity,spread,preempt", "all", or
        0/off/empty) and the BST_POLICY_* weight knobs. Anything
        unparseable degrades (unknown terms are dropped with one stderr
        warning, a bad weight keeps its default), never fails a batch."""
        raw = os.environ.get(_POLICY_ENV, "").strip()
        if not raw or raw.lower() in ("0", "off", "false", "no"):
            return cls()
        if raw.lower() == "all":
            names = sorted(TERM_REGISTRY)
        else:
            names = sorted({t.strip() for t in raw.split(",") if t.strip()})
        unknown = [t for t in names if t not in TERM_REGISTRY]
        if unknown and not _env_warned[0]:
            _env_warned[0] = True
            print(
                f"ignoring unknown {_POLICY_ENV} terms {unknown!r} "
                f"(known: {sorted(TERM_REGISTRY)})",
                file=sys.stderr,
            )
        names = tuple(t for t in names if t in TERM_REGISTRY)

        def _int(name: str, default: int) -> int:
            v = os.environ.get(name, "").strip()
            if not v:
                return default
            try:
                return max(0, int(v))
            except ValueError:
                return default

        protect = os.environ.get(
            "BST_POLICY_PROTECT_RUNNING", ""
        ).strip().lower() in ("1", "true", "yes", "on")
        return cls(
            terms=names,
            affinity_weight=_int("BST_POLICY_AFFINITY_WEIGHT", 32),
            spread_weight=_int("BST_POLICY_SPREAD_WEIGHT", 8),
            spread_cap=_int("BST_POLICY_SPREAD_CAP", 3),
            spread_node_key=os.environ.get("BST_POLICY_SPREAD_KEY", "zone").strip()
            or "zone",
            protect_running=protect,
        )


class PolicyEngine:
    """Host-side policy runtime: config + counters + explain(). One per
    ScheduleOperation; the most recently constructed enabled engine is
    also the process's active engine (``active_fingerprint``, the
    ``/debug/policy`` view)."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config if config is not None else PolicyConfig.from_env()
        self._lock = threading.Lock()
        self.batches_scored = 0  # guarded-by: _lock
        self.preempt_plans = 0  # guarded-by: _lock
        # denied-gang preemption attempts that yielded NO plan (no
        # eligible victims, nothing to free, or infeasible even with full
        # eviction: the planner returns one None for all three)
        self.preempt_no_plan = 0  # guarded-by: _lock
        if self.config.enabled:
            set_active_engine(self)

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    @property
    def preemption(self) -> bool:
        return self.config.preemption

    def note_batch(self) -> None:
        with self._lock:
            self.batches_scored += 1

    def note_plan(self, planned: bool) -> None:
        with self._lock:
            if planned:
                self.preempt_plans += 1
            else:
                self.preempt_no_plan += 1

    # -- flight-recorder blame ---------------------------------------------

    def explain(self, policy_cols, g: int, node_indices) -> Dict[str, int]:
        """Per-term score contributions for one gang at its chosen nodes —
        the flight recorder's policy blame payload. Pure numpy on the
        snapshot's host columns (``ClusterSnapshot.policy_cols``, never
        the resident device copies); O(len(node_indices)) per placed
        gang."""
        if policy_cols is None or not node_indices:
            return {}
        prio, aff, anti, gang_dom, node_hash, node_dom = (
            np.asarray(a) for a in policy_cols
        )
        idx = [int(n) for n in node_indices if 0 <= int(n) < node_dom.shape[0]]
        if not idx or g >= aff.shape[0]:
            return {}
        out: Dict[str, int] = {"priority_class": int(prio[g])}
        w_aff, w_spread, cap = self.config.weights
        if "affinity" in self.config.terms and aff[g] > 0:
            miss = sum(
                1 for n in idx if aff[g] not in node_hash[n]
            )
            out["affinity_penalty"] = int(miss * w_aff)
        if "spread" in self.config.terms:
            pen = sum(
                min(int(gang_dom[g, int(node_dom[n])]), cap) * w_spread
                for n in idx
            )
            out["spread_penalty"] = int(pen)
        if "anti-affinity" in self.config.terms and anti[g] > 0:
            out["anti_affinity_active"] = 1
        return out

    def debug_view(self) -> dict:
        """The /debug/policy payload (utils.metrics)."""
        with self._lock:
            counters = {
                "batches_scored": self.batches_scored,
                "preempt_plans": self.preempt_plans,
                "preempt_no_plan": self.preempt_no_plan,
            }
        return {
            "config": self.config.fingerprint(),
            "registry": {
                name: kind for name, (kind, _) in sorted(TERM_REGISTRY.items())
            },
            "columns": {
                "domain_buckets": DOMAIN_BUCKETS,
                "hash_lanes": HASH_LANES,
            },
            "counters": counters,
        }


# ---------------------------------------------------------------------------
# process-wide view (the /debug/policy endpoint + config fingerprinting)
# ---------------------------------------------------------------------------

_active: list = [None]


def set_active_engine(engine: Optional[PolicyEngine]) -> None:
    _active[0] = engine


def active_engine() -> Optional[PolicyEngine]:
    return _active[0]


def active_fingerprint() -> Optional[dict]:
    """The active engine's config fingerprint, or None when no enabled
    engine exists: folded into utils.audit.config_fingerprint, so policy
    drift shows in a replay's divergence blame."""
    eng = _active[0]
    if eng is None or not eng.enabled:
        return None
    return eng.config.fingerprint()


def policy_debug_view() -> dict:
    eng = _active[0]
    if eng is None:
        return {"enabled": False}
    view = eng.debug_view()
    view["enabled"] = eng.enabled
    return view
