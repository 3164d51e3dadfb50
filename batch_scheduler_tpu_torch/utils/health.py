"""Live SLO health model: rolling-window quantile verdicts over the
phase histograms, the pending-gang tracker, and the sampled
in-production identity audit.

The port of ``batch_scheduler_tpu/utils/health.py``: the same signal
catalog, targets, windows and burn-rate rule, so the same observations
give the same verdicts in both packages. Served as JSON at
``/debug/health`` on the metrics endpoint (utils.metrics); every
transition INTO breach increments ``bst_slo_breach_total{signal}``.

Signal catalog:

====================  ================================  ==============
signal                source metric                     default p95
====================  ================================  ==============
pack                  bst_oracle_pack_seconds           1.0 s
batch                 bst_oracle_batch_seconds          45 s
device                bst_oracle_device_seconds         45 s
cycle                 bst_schedule_cycle_seconds        2.5 s
degraded  (state)     bst_oracle_degraded               breach while 1
breaker   (state)     bst_oracle_breaker_state          breach on open
identity  (state)     bst_identity_audit_total          breach sticky
====================  ================================  ==============

In the port, ``pack`` and ``batch`` are observed by every published
batch (``core.oracle_scorer``) and ``device`` by a traced remote batch's
TRACE_INFO (``service.client``); ``cycle`` by every scheduling cycle of
the scheduler loop (``framework.scheduler``). A signal with zero
observations in the window reports ``ok`` with ``observations: 0`` —
absence of traffic is not a breach, and no verdict is invented.

Targets override via ``BST_SLO_<SIGNAL>_P95_S`` (read at evaluate time);
warn fires at 80% of the target; ``BST_SLO_WINDOW_S`` sizes the rolling
window (default 300 s).

**Multi-window burn rate** (``burn:<signal>``): a p95 target grants a 5%
violation budget; the burn rate is (observed violation fraction) / 5%,
over the FAST window (``BST_SLO_WINDOW_S``) and a SLOW window
(``BST_SLO_BURN_WINDOW_S``, default 3600 s). Breach requires BOTH
elevated (``BST_SLO_BURN_FAST`` >= 14.4 fast AND ``BST_SLO_BURN_SLOW`` >=
6 slow); a high slow burn with a recovered fast window is only a warn.
The capacity observatory (``ops.capacity.active_sampler``) feeds
``burn:capacity`` the same way: a sample with capacity-unplaceable
pending gangs is a violation. ``burn:ttp`` judges the lifecycle ledger's
``bst_gang_ttp_seconds{tenant,tier}`` against per-tier p99 targets
(``BST_SLO_TTP_P99_S``, ``BST_SLO_TTP_P99_T<tier>_S``).

The **identity audit** is the kernel-against-plain check running while
the scheduler runs: every Kth published batch served by the CUDA scan
kernel is re-executed by the plain serial scan on the CPU (the
``cpu-ladder`` replay rung) and the plan digests are compared bit for
bit. A mismatch breaches health (``HealthModel.note_identity``),
increments ``bst_identity_audit_total{outcome="mismatch"}``, and flags
the audit ring with an ``identity_mismatch`` event carrying both
digests.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional

from .lifecycle import _quantile_from_counts
from .metrics import DEFAULT_REGISTRY, LONG_OP_BUCKETS, Registry

__all__ = [
    "HealthModel",
    "IdentityAuditor",
    "PendingGangTracker",
    "DEFAULT_HEALTH",
    "DEFAULT_PENDING",
    "QUANTILE_SIGNALS",
    "set_active_pending",
    "active_pending",
    "worst",
]

# (signal, metric, default p95 target seconds, bucket preset or None for
# the registry default). The bucket preset MUST match what the metric's
# observation site registers with (Registry.histogram ignores ``buckets``
# for an existing metric): if health evaluated first and created
# batch/device with the default 10s-ceiling buckets, every cold-compile
# observation would clamp at 10s and the 45s breach target could never
# fire. Defaults are sized so a healthy run — including a cold XLA
# compile riding into batch/device — stays ok; operators and CI gates
# tighten per deployment via env.
QUANTILE_SIGNALS = (
    ("pack", "bst_oracle_pack_seconds", 1.0, None),
    ("batch", "bst_oracle_batch_seconds", 45.0, LONG_OP_BUCKETS),
    ("device", "bst_oracle_device_seconds", 45.0, LONG_OP_BUCKETS),
    ("cycle", "bst_schedule_cycle_seconds", 2.5, None),
)

WARN_FRACTION = 0.8
_VERDICT_RANK = {"ok": 0, "warn": 1, "breach": 2}

# Burn-rate alerting constants: a p95 target budgets 5% violations; the
# default thresholds are the classic SRE multi-window pair (14.4x on the
# fast window to page only on real fires, 6x on the slow window so a
# budget mostly spent stays visible as a warn after recovery).
BURN_ALLOWED_FRACTION = 0.05
DEFAULT_BURN_WINDOW_S = 3600.0
DEFAULT_BURN_FAST_THRESHOLD = 14.4
DEFAULT_BURN_SLOW_THRESHOLD = 6.0


def _burn_window_s() -> float:
    raw = os.environ.get("BST_SLO_BURN_WINDOW_S", "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_BURN_WINDOW_S


def _burn_fast_threshold() -> float:
    raw = os.environ.get("BST_SLO_BURN_FAST", "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_BURN_FAST_THRESHOLD


def _burn_slow_threshold() -> float:
    raw = os.environ.get("BST_SLO_BURN_SLOW", "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_BURN_SLOW_THRESHOLD


def _burn_verdict(burns: Dict[str, float], subject: str) -> tuple:
    """(verdict, reason, fast_threshold, slow_threshold) for one signal's
    fast/slow burn pair — THE multi-window decision rule, shared by the
    histogram-backed signals and burn:capacity so the two can never
    drift: breach only while burning NOW (both windows elevated),
    slow-only = budget burned EARLIER (recovery clears the page)."""
    fast_thr = _burn_fast_threshold()
    slow_thr = _burn_slow_threshold()
    burning_now = burns["fast"] >= fast_thr
    burned_slow = burns["slow"] >= slow_thr
    if burning_now and burned_slow:
        verdict, reason = (
            "breach",
            f"{subject} NOW: burning {burns['fast']}x over the fast "
            f"window, {burns['slow']}x over the slow window",
        )
    elif burned_slow:
        verdict, reason = (
            "warn",
            f"{subject}: budget burned EARLIER — slow-window burn "
            f"{burns['slow']}x but the fast window has recovered",
        )
    elif burning_now:
        verdict, reason = (
            "warn",
            f"{subject}: fast-window burn {burns['fast']}x; slow window "
            "not yet confirming",
        )
    else:
        verdict, reason = "ok", ""
    return verdict, reason, fast_thr, slow_thr


def _violations(snap, buckets, target: float) -> tuple:
    """(violations, total) of one histogram snapshot against a latency
    target: observations strictly above the first bucket bound >= target
    (the same conservative rounding Prometheus alerting math uses —
    in-bucket positions are unknowable from cumulative counts)."""
    counts, _, total = snap
    idx = None
    for i, b in enumerate(buckets):
        if b >= target:
            idx = i
            break
    good = counts[idx] if idx is not None else (counts[-1] if counts else 0)
    return max(total - good, 0), total


def worst(verdicts) -> str:
    out = "ok"
    for v in verdicts:
        if _VERDICT_RANK.get(v, 0) > _VERDICT_RANK[out]:
            out = v
    return out


def _target(signal: str, default: float) -> float:
    raw = os.environ.get(f"BST_SLO_{signal.upper()}_P95_S", "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return default


DEFAULT_TTP_TARGET_S = 120.0


def _ttp_target_default() -> float:
    """``BST_SLO_TTP_P99_S`` — the placement-SLO p99 target every tier
    inherits unless overridden (parse-guarded)."""
    raw = os.environ.get("BST_SLO_TTP_P99_S", "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_TTP_TARGET_S


def _ttp_target_for_tier(tier: str) -> float:
    """Per-tier override: ``BST_SLO_TTP_P99_T<tier>_S`` (e.g.
    BST_SLO_TTP_P99_T2_S for priority tier 2) beats the base target — a
    guaranteed tier can be held to seconds while best-effort tolerates
    minutes. Parse-guarded like every knob."""
    raw = os.environ.get(f"BST_SLO_TTP_P99_T{tier}_S", "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return _ttp_target_default()


class PendingGangTracker:
    """Pending-gang aging: how long denied gangs have been waiting, and
    how many consecutive denials each has eaten.

    Fed by the control plane's single denial choke point
    (core.operation.ScheduleOperation.add_to_deny_cache) and resolved at
    permit-quorum time; a deleted gang is forgotten without resolving (its
    age is censored, not a placement). Surfaces:

    - ``bst_gang_pending_seconds`` (histogram) — deny-to-placement age,
      observed once per gang at resolution;
    - ``bst_gang_pending_oldest_seconds`` (gauge) — the oldest
      still-pending gang's age, set on every ``report()``;
    - ``bst_gang_deny_streak_max`` (gauge) — the largest consecutive-deny
      streak among still-pending gangs.

    ``report()`` also feeds the ``pending`` health signal: a gang pending
    past ``BST_SLO_PENDING_P95_S`` (default 120 s) is a WARN — starvation
    is an operator signal, not a process failure (never a breach)."""

    DEFAULT_TARGET_S = 120.0
    # placed-gang first-seen memory bound: enough to cover every gang a
    # 5120-node sim can hold placed at once, small enough to never matter
    PLACED_MEMORY = 4096

    def __init__(self, registry: Optional[Registry] = None):
        self._lock = threading.Lock()
        # gang -> (first_deny_monotonic, consecutive denials)
        self._pending: Dict[str, tuple] = {}  # guarded-by: _lock
        # gang -> first_deny_monotonic retained past placement, so a
        # preemption EVICTION re-arms the pending clock at the ORIGINAL
        # anchor — a spot gang that waited 90s, placed, and was evicted
        # has not stopped waiting; without the carry its pending age (and
        # the TTP fed from it) would restart from the eviction, hiding
        # exactly the churn the placement SLO exists to count
        self._placed_first: "OrderedDict[str, float]" = (
            OrderedDict()
        )  # guarded-by: _lock
        self.resolved = 0  # guarded-by: _lock
        reg = registry or DEFAULT_REGISTRY
        self._hist = reg.histogram(
            "bst_gang_pending_seconds",
            "Gang pending age from first denial to placement "
            "(deleted-unplaced gangs are censored, never observed)",
            buckets=LONG_OP_BUCKETS,
        )
        self._oldest = reg.gauge(
            "bst_gang_pending_oldest_seconds",
            "Age of the oldest still-pending (denied, unplaced) gang",
        )
        self._streak = reg.gauge(
            "bst_gang_deny_streak_max",
            "Largest consecutive-denial streak among pending gangs",
        )

    def note_deny(self, gang: str) -> None:
        now = time.monotonic()
        with self._lock:
            first, streak = self._pending.get(gang, (now, 0))
            self._pending[gang] = (first, streak + 1)

    def note_placed(self, gang: str) -> None:
        with self._lock:
            entry = self._pending.pop(gang, None)
            if entry is not None:
                self.resolved += 1
                self._placed_first.pop(gang, None)
                self._placed_first[gang] = entry[0]
                while len(self._placed_first) > self.PLACED_MEMORY:
                    self._placed_first.popitem(last=False)
        if entry is not None:
            self._hist.observe(time.monotonic() - entry[0])

    def note_evicted(self, gang: str) -> None:
        """Preemption evicted a placed gang: it is pending again, and its
        clock is the ORIGINAL first-seen (carried across note_placed), not
        now — pending age and time-to-placement include preemption churn.
        A gang already pending keeps its running clock untouched. The
        respawned gang's next placement observes the full span and
        re-arms the carry, so repeated evict/respawn cycles accumulate."""
        now = time.monotonic()
        with self._lock:
            if gang in self._pending:
                return  # clock never stopped
            first = self._placed_first.pop(gang, now)
            self._pending[gang] = (first, 0)

    def forget(self, gang: str) -> None:
        with self._lock:
            self._pending.pop(gang, None)
            self._placed_first.pop(gang, None)

    def reset(self) -> None:
        with self._lock:
            self._pending.clear()
            self._placed_first.clear()
            self.resolved = 0
        self._oldest.set(0.0)
        self._streak.set(0.0)

    def report(self) -> dict:
        now = time.monotonic()
        with self._lock:
            pending = dict(self._pending)
            resolved = self.resolved
        oldest_gang, oldest_age, max_streak = None, 0.0, 0
        for gang, (first, streak) in pending.items():
            age = now - first
            if age > oldest_age:
                oldest_gang, oldest_age = gang, age
            max_streak = max(max_streak, streak)
        self._oldest.set(round(oldest_age, 3))
        self._streak.set(float(max_streak))
        return {
            "pending_gangs": len(pending),
            "resolved_gangs": resolved,
            "oldest_gang": oldest_gang,
            "oldest_age_s": round(oldest_age, 3),
            "max_deny_streak": max_streak,
        }


DEFAULT_PENDING = PendingGangTracker()

# The tracker the health model reports: each ScheduleOperation registers
# its own at construction (the set_active_engine pattern), so gangs from
# a torn-down harness never age into a later harness's verdict — one
# process can run many sims (the test suite does).
_active_pending: list = [DEFAULT_PENDING]


def set_active_pending(tracker: PendingGangTracker) -> None:
    _active_pending[0] = tracker


def active_pending() -> PendingGangTracker:
    return _active_pending[0]


class HealthModel:
    """Continuously-evaluable SLO verdict over the process registry.

    ``evaluate()`` is cheap (histogram snapshots + arithmetic) and safe to
    call per scrape; it is what ``/debug/health`` serves. State kept here
    is only the rolling-window snapshot baselines and the last verdict per
    signal (for breach-transition counting) — the measurements themselves
    live in the metrics registry, so one model can be reset (a CI gate
    scoping a phase) without losing Prometheus history."""

    def __init__(self, registry: Optional[Registry] = None):
        self._reg = registry or DEFAULT_REGISTRY
        self._lock = threading.Lock()
        self._snaps: Dict[str, deque] = {  # guarded-by: _lock
            name: deque() for name, _, _, _ in QUANTILE_SIGNALS
        }
        # burn-rate history: (ts, snapshot) per signal, retained for the
        # SLOW window (the fast window reads a suffix of the same deque)
        self._burn_snaps: Dict[str, deque] = {  # guarded-by: _lock
            name: deque() for name, _, _, _ in QUANTILE_SIGNALS
        }
        # placement-TTP burn history: (ts, {labelkey: snapshot}) over the
        # LABELLED bst_gang_ttp_seconds family — per-(tenant,tier) series
        # are judged against per-TIER targets, then folded into one burn
        self._ttp_snaps: deque = deque()  # guarded-by: _lock
        self._last_verdict: Dict[str, str] = {}  # guarded-by: _lock
        self._identity_mismatch: Optional[dict] = None  # guarded-by: _lock
        self._breaches = self._reg.counter(
            "bst_slo_breach_total",
            "SLO signal transitions into breach, by signal "
            "(docs/observability.md health catalog)",
        )
        self._burn_gauge = self._reg.gauge(
            "bst_slo_burn_rate",
            "Error-budget burn rate per SLO signal and window "
            "(violation fraction / 5% budget; breach needs fast AND "
            "slow elevated — docs/observability.md)",
        )

    @property
    def window_s(self) -> float:
        try:
            return float(os.environ.get("BST_SLO_WINDOW_S", "300"))
        except ValueError:
            return 300.0

    # -- inputs from elsewhere ----------------------------------------------

    def note_identity(self, ok: bool, **detail) -> None:
        """Identity-audit outcome (IdentityAuditor). A mismatch is sticky
        until reset(): a once-wrong plan is evidence, not a blip."""
        if not ok:
            with self._lock:
                self._identity_mismatch = {"ts": time.time(), **detail}

    def reset(self) -> None:
        """Re-baseline every rolling window at NOW and clear sticky state —
        scoping the next evaluations to observations from here on (CI
        gates separating a clean phase from a chaos phase)."""
        now = time.time()
        with self._lock:
            for name, metric, _, buckets in QUANTILE_SIGNALS:
                hist = self._hist(metric, buckets)
                snap = hist.snapshot()
                self._snaps[name].clear()
                self._snaps[name].append((now, snap))
                self._burn_snaps[name].clear()
                self._burn_snaps[name].append((now, snap))
            ttp = self._ttp_hist()
            self._ttp_snaps.clear()
            self._ttp_snaps.append((now, ttp.snapshots()))
            self._last_verdict.clear()
            self._identity_mismatch = None

    # -- evaluation ----------------------------------------------------------

    def _hist(self, metric: str, buckets):
        """The signal's histogram, created with the SAME bucket preset its
        observation site uses if health happens to touch it first."""
        if buckets is not None:
            return self._reg.histogram(
                metric, buckets=buckets
            )  # analysis: allow(metrics) names enumerated in QUANTILE_SIGNALS, each registered+documented at its observation site
        return self._reg.histogram(
            metric
        )  # analysis: allow(metrics) names enumerated in QUANTILE_SIGNALS, each registered+documented at its observation site

    def _note_transition(self, name: str, verdict: str) -> None:  # lock-held: _lock
        if verdict == "breach" and self._last_verdict.get(name) != "breach":
            self._breaches.inc(signal=name)
        self._last_verdict[name] = verdict

    def _burn_signal(  # lock-held: _lock
        self, name: str, hist, current, now: float, fast_s: float,
        slow_s: float, default: float,
    ) -> dict:
        """One signal's multi-window burn verdict from its snapshot
        history. Maintains the slow-window deque as a side effect."""
        dq = self._burn_snaps.setdefault(name, deque())
        # bounded by CONSTRUCTION, not by evaluation rate: retain at most
        # one snapshot per slow_s/1024 of wall-clock, so a high-rate
        # /debug/health poller (a 10Hz dashboard) cannot grow the history
        # past ~1k entries per signal — at a 3600s window a ~3.5s
        # snapshot granularity loses nothing the verdict could see
        if not dq or now - dq[-1][0] >= slow_s / 1024.0:
            dq.append((now, current))
        while len(dq) > 1 and now - dq[1][0] > slow_s:
            dq.popleft()

        def _at(window: float):
            base = dq[0][1]
            for ts, snap in dq:
                if ts <= now - window:
                    base = snap
                else:
                    break
            return base

        target = _target(name, default)
        burns = {}
        observations = 0
        for window_name, window in (("fast", fast_s), ("slow", slow_s)):
            bad, total = (
                _violations(current, hist.buckets, target)[0]
                - _violations(_at(window), hist.buckets, target)[0],
                current[2] - _at(window)[2],
            )
            frac = bad / total if total > 0 else 0.0
            burns[window_name] = round(frac / BURN_ALLOWED_FRACTION, 3)
            if window_name == "fast":
                observations = total
            self._burn_gauge.set(
                burns[window_name], signal=name, window=window_name
            )
        verdict, reason, fast_thr, slow_thr = _burn_verdict(
            burns, f"{name} latency budget"
        )
        self._note_transition(f"burn:{name}", verdict)
        return {
            "kind": "burn",
            "signal": name,
            "target_p95_s": target,
            "burn_fast": burns["fast"],
            "burn_slow": burns["slow"],
            "fast_window_s": fast_s,
            "slow_window_s": slow_s,
            "fast_threshold": fast_thr,
            "slow_threshold": slow_thr,
            "observations": observations,
            "verdict": verdict,
            "reason": reason,
        }

    def _ttp_hist(self):
        """The gang lifecycle ledger's TTP histogram, created with its
        observation-site bucket preset if health touches it first."""
        return self._reg.histogram(
            "bst_gang_ttp_seconds", buckets=LONG_OP_BUCKETS
        )

    def _ttp_burn_signal(  # lock-held: _lock
        self, now: float, fast_s: float, slow_s: float
    ) -> dict:
        """Placement-TTP multi-window burn over the LABELLED
        ``bst_gang_ttp_seconds{tenant,tier}`` family. Each (tenant, tier)
        series' windowed observations are judged against that TIER's p99
        target (``BST_SLO_TTP_P99_S`` / ``BST_SLO_TTP_P99_T<tier>_S``)
        and the violating/total counts are summed across series before
        the burn division — one budget, spent by whichever tenant or
        tier is missing ITS target. Per-tier windowed p99s ride along in
        the payload so /debug/health names the offender."""
        hist = self._ttp_hist()
        current = hist.snapshots()
        dq = self._ttp_snaps
        # same construction bound as _burn_signal: at most one retained
        # snapshot per slow_s/1024 of wall-clock
        if not dq or now - dq[-1][0] >= slow_s / 1024.0:
            dq.append((now, current))
        while len(dq) > 1 and now - dq[1][0] > slow_s:
            dq.popleft()

        def _at(window: float):
            base = dq[0][1]
            for ts, snap in dq:
                if ts <= now - window:
                    base = snap
                else:
                    break
            return base

        empty = ((0,) * len(hist.buckets), 0.0, 0)
        burns = {}
        observations = 0
        fast_base = None
        for window_name, window in (("fast", fast_s), ("slow", slow_s)):
            base = _at(window)
            if window_name == "fast":
                fast_base = base
            bad = total = 0
            for key, snap in current.items():
                target = _ttp_target_for_tier(dict(key).get("tier", ""))
                b = base.get(key, empty)
                # max(..., 0) guards a registry swapped under the model
                # (tests): a shrunk counter is a new epoch, not negative
                # traffic
                bad += max(
                    _violations(snap, hist.buckets, target)[0]
                    - _violations(b, hist.buckets, target)[0],
                    0,
                )
                total += max(snap[2] - b[2], 0)
            frac = bad / total if total > 0 else 0.0
            burns[window_name] = round(frac / BURN_ALLOWED_FRACTION, 3)
            if window_name == "fast":
                observations = total
            self._burn_gauge.set(
                burns[window_name], signal="ttp", window=window_name
            )
        verdict, reason, fast_thr, slow_thr = _burn_verdict(
            burns, "placement time-to-bind budget"
        )
        self._note_transition("burn:ttp", verdict)

        # per-tier fast-window p99 + target, merged across tenants
        tiers: Dict[str, list] = {}
        for key, snap in current.items():
            tier = dict(key).get("tier", "")
            b = (fast_base or {}).get(key, empty)
            agg = tiers.setdefault(tier, [[0] * len(hist.buckets), 0])
            agg[0] = [
                a + max(c - c0, 0)
                for a, c, c0 in zip(agg[0], snap[0], b[0])
            ]
            agg[1] += max(snap[2] - b[2], 0)
        tier_p99 = {
            tier or "-": {
                "p99_s": round(
                    _quantile_from_counts(hist.buckets, cnts, n, 0.99), 6
                )
                if n else 0.0,
                "target_p99_s": _ttp_target_for_tier(tier),
                "observations": n,
            }
            for tier, (cnts, n) in sorted(tiers.items())
        }
        return {
            "kind": "burn",
            "signal": "ttp",
            "target_p99_s": _ttp_target_default(),
            "burn_fast": burns["fast"],
            "burn_slow": burns["slow"],
            "fast_window_s": fast_s,
            "slow_window_s": slow_s,
            "fast_threshold": fast_thr,
            "slow_threshold": slow_thr,
            "observations": observations,
            "tiers": tier_p99,
            "verdict": verdict,
            "reason": reason,
        }

    def evaluate(self) -> dict:
        now = time.time()
        window = self.window_s
        slow_window = _burn_window_s()
        signals: Dict[str, dict] = {}
        with self._lock:
            for name, metric, default, buckets in QUANTILE_SIGNALS:
                hist = self._hist(metric, buckets)
                snaps = self._snaps[name]
                while len(snaps) > 1 and now - snaps[0][0] > window:
                    snaps.popleft()
                current = hist.snapshot()
                if not snaps:
                    # first touch of this signal: seed the window baseline
                    # at NOW. Evaluating against since=None would scope
                    # the "rolling window" to the whole process history —
                    # one cold-compile observation hours ago would breach
                    # a first scrape that the documented window excludes.
                    snaps.append((now, current))
                base = snaps[0][1]
                observations = current[2] - (base[2] if base else 0)
                target = _target(name, default)
                p95 = (
                    hist.quantile(0.95, since=base) if observations else 0.0
                )
                if observations <= 0:
                    verdict = "ok"
                elif p95 > target:
                    verdict = "breach"
                elif p95 > WARN_FRACTION * target:
                    verdict = "warn"
                else:
                    verdict = "ok"
                self._note_transition(name, verdict)
                signals[name] = {
                    "kind": "quantile",
                    "metric": metric,
                    "p95_s": round(p95, 6),
                    "target_p95_s": target,
                    "observations": observations,
                    "verdict": verdict,
                }
                snaps.append((now, current))
                # multi-window burn rate over the same histogram: is the
                # p95 budget being spent NOW (fast) vs already spent
                # (slow) — the page-vs-postmortem distinction
                signals[f"burn:{name}"] = self._burn_signal(
                    name, hist, current, now, window, slow_window, default
                )

            # -- placement TTP burn (utils.lifecycle ledger) ----------------
            # arrival->bind time-to-placement vs per-tier p99 targets,
            # through the same fast/slow burn rule
            signals["burn:ttp"] = self._ttp_burn_signal(
                now, window, slow_window
            )

            # -- structural states ------------------------------------------
            degraded = self._reg.gauge("bst_oracle_degraded").value()
            verdict = "breach" if degraded else "ok"
            self._note_transition("degraded", verdict)
            signals["degraded"] = {
                "kind": "state",
                "value": degraded,
                "verdict": verdict,
                "reason": "serving the conservative CPU fallback batch"
                if degraded else "",
            }

            breaker_states = self._reg.gauge(
                "bst_oracle_breaker_state"
            ).values()
            open_clients = sorted(
                dict(k).get("client", "?")
                for k, v in breaker_states.items() if v == 1
            )
            half_open = any(v == 2 for v in breaker_states.values())
            verdict = (
                "breach" if open_clients else "warn" if half_open else "ok"
            )
            self._note_transition("breaker", verdict)
            signals["breaker"] = {
                "kind": "state",
                "open_clients": open_clients,
                "verdict": verdict,
                "reason": (
                    f"circuit open: {', '.join(open_clients)}"
                    if open_clients
                    else "half-open probe pending" if half_open else ""
                ),
            }

            mismatch = self._identity_mismatch
            verdict = "breach" if mismatch else "ok"
            self._note_transition("identity", verdict)
            signals["identity"] = {
                "kind": "state",
                "verdict": verdict,
                "mismatch": mismatch,
                "reason": "served plan diverged from its CPU-rung replay"
                if mismatch else "",
            }

        # -- pending-gang aging (PendingGangTracker) ------------------------
        # starvation is an operator signal, never a process failure: a
        # gang pending past the target WARNS, it does not breach
        pending = active_pending().report()
        target = _target("pending", PendingGangTracker.DEFAULT_TARGET_S)
        verdict = (
            "warn"
            if pending["pending_gangs"] and pending["oldest_age_s"] > target
            else "ok"
        )
        with self._lock:
            self._note_transition("pending", verdict)
        signals["pending"] = {
            "kind": "state",
            "verdict": verdict,
            "target_age_s": target,
            **pending,
            "reason": (
                f"gang {pending['oldest_gang']} pending "
                f"{pending['oldest_age_s']:.0f}s (target {target:.0f}s, "
                f"deny streak {pending['max_deny_streak']})"
                if verdict != "ok" else ""
            ),
        }

        # -- capacity burn (ops.capacity observatory) ------------------------
        # a capacity sample with pending gangs the carried leftover cannot
        # place is a violation: burning placement budget. Lazy import —
        # health must evaluate before the ops layer ever loads.
        try:
            from ..ops.capacity import active_sampler

            sampler = active_sampler()
        except Exception:  # noqa: BLE001 — health must always answer
            sampler = None
        if sampler is not None:
            series = sampler.series()  # ONE ring copy for both windows
            burns = {}
            observations = 0
            for window_name, w in (
                ("fast", window), ("slow", slow_window),
            ):
                bad = total = 0.0
                for entry in series:
                    # a downsampled entry covers [ts, ts+span_s] and
                    # folded `merged` raw samples: weight by the count
                    # and admit by span OVERLAP, or the slow window is
                    # systematically mis-weighted exactly when history
                    # has downsampled (utils.timeseries)
                    if entry["ts"] + entry.get("span_s", 0.0) < now - w:
                        continue
                    weight = entry.get("merged", 1) or 1
                    total += weight
                    data = entry.get("data") or {}
                    # capacity_violation is a 0/1 indicator at append
                    # time, so the ring's averaging makes a merged
                    # entry's value the exact violating FRACTION of its
                    # raw samples (ops.capacity); pre-indicator entries
                    # fall back to the unplaceable count
                    viol = data.get("capacity_violation")
                    if viol is None:
                        pend = data.get("pending") or {}
                        viol = (
                            1.0
                            if (pend.get("unplaceable_gangs") or 0) > 0
                            else 0.0
                        )
                    bad += weight * min(max(float(viol), 0.0), 1.0)
                frac = bad / total if total else 0.0
                burns[window_name] = round(
                    frac / BURN_ALLOWED_FRACTION, 3
                )
                if window_name == "fast":
                    observations = int(total)
                self._burn_gauge.set(
                    burns[window_name], signal="capacity",
                    window=window_name,
                )
            verdict, reason, fast_thr, slow_thr = _burn_verdict(
                burns, "capacity-unplaceable pending demand"
            )
            with self._lock:
                self._note_transition("burn:capacity", verdict)
            signals["burn:capacity"] = {
                "kind": "burn",
                "signal": "capacity",
                "burn_fast": burns["fast"],
                "burn_slow": burns["slow"],
                "fast_window_s": window,
                "slow_window_s": slow_window,
                "fast_threshold": fast_thr,
                "slow_threshold": slow_thr,
                "observations": observations,
                "verdict": verdict,
                "reason": reason,
            }

        # -- oracle failover (pooled ResilientOracleClient) ------------------
        # which backend each pooled client is serving from, how fresh the
        # standby is, and the promotions inside the rolling window. A
        # recent promotion WARNS (the fleet is on its standby — restore
        # redundancy), it does not breach: traffic is still being served,
        # which is the whole point of the pool. Lazy import — health must
        # evaluate before the service layer ever loads.
        try:
            from ..service.client import active_failover_report

            failover = active_failover_report()
        except Exception:  # noqa: BLE001 — health must always answer
            failover = None
        if failover is not None and failover.get("clients"):
            recent = [
                {**p, "client": c["client"]}
                for c in failover["clients"]
                for p in c.get("promotions", [])
                if p.get("ago_s", window + 1) <= window
            ]
            verdict = "warn" if recent else "ok"
            with self._lock:
                self._note_transition("failover", verdict)
            signals["failover"] = {
                "kind": "state",
                "verdict": verdict,
                "promotions_in_window": len(recent),
                "clients": failover["clients"],
                "reason": (
                    "standby promotion(s) in window: "
                    + ", ".join(
                        f"{p['client']} -> backend {p['to']} "
                        f"({p['reason']}, {p['ago_s']:.0f}s ago)"
                        for p in recent[:4]
                    )
                    if recent else ""
                ),
            }

        return {
            "verdict": worst(s["verdict"] for s in signals.values()),
            "ts": now,
            "window_s": window,
            "signals": signals,
        }


DEFAULT_HEALTH = HealthModel()


# the rung every verification replays on
_AUDIT_RUNG = "cpu-ladder"


class IdentityAuditor:
    """Sampled plan verification: every ``every``-th batch it is shown
    (``OracleScorer._audit_publish``: published batches only) is
    re-executed on the ``cpu-ladder`` rung from its exact packed host
    inputs, on a daemon thread, and the plan digest is bit-compared with
    the served one. At most one verification is in flight — under a slow
    rung the audit degrades to sampling less often, never to queueing
    work."""

    def __init__(self, every: int):
        self.every = max(1, int(every))
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self.audits = 0
        self.mismatches = 0
        self.errors = 0
        self._counter = DEFAULT_REGISTRY.counter(
            "bst_identity_audit_total",
            "Sampled production identity audits by outcome (a served "
            "plan re-verified against its digest on the CPU fallback rung)",
        )

    def note_batch(self, batch_args, progress_args, plan_digest: str,
                   audit_id: Optional[str], audit_log=None, policy=None) -> None:
        """Hot-path entry: counts the batch and, on the Kth, hands the
        (immutable, published) host arrays to the verification thread.
        ``policy`` is a policy batch's ``(policy_cols, terms, weights)``
        payload: the verification runs the same composite (the plain
        policy scan)."""
        with self._lock:
            self._count += 1
            if self._count % self.every:
                return
            if self._thread is not None and self._thread.is_alive():
                return  # one in flight; skip this sample
            t = threading.Thread(
                target=self._verify,
                args=(batch_args, progress_args, plan_digest, audit_id,
                      audit_log, policy),
                name="identity-audit",
                daemon=True,
            )
            self._thread = t
        t.start()

    def _verify(self, batch_args, progress_args, plan_digest, audit_id,
                audit_log, policy=None) -> None:
        # deferred: core.oracle_scorer imports this module
        from ..core.oracle_scorer import replay_batch
        from . import audit as audit_mod

        try:
            host, _ = replay_batch(batch_args, progress_args, against=_AUDIT_RUNG,
                                   policy=policy)
            got = audit_mod.plan_digest(host)
        except Exception:  # noqa: BLE001 — an audit error is not a mismatch
            self.errors += 1
            self._counter.inc(outcome="error")
            return
        self.audits += 1
        if got == plan_digest:
            self._counter.inc(outcome="ok")
            return
        self.mismatches += 1
        self._counter.inc(outcome="mismatch")
        detail = {
            "audit_id": audit_id,
            "expected": plan_digest,
            "got": got,
            "rung": _AUDIT_RUNG,
        }
        DEFAULT_HEALTH.note_identity(False, **detail)
        if audit_log is not None:
            try:
                audit_log.record_event("identity_mismatch", **detail)
            except Exception:  # noqa: BLE001 — evidence best-effort
                pass

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait out an in-flight verification; True when none is left."""
        with self._lock:
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
            return not t.is_alive()
        return True

    def stats(self) -> dict:
        return {
            "identity_audits": self.audits,
            "identity_mismatches": self.mismatches,
            "identity_errors": self.errors,
        }
