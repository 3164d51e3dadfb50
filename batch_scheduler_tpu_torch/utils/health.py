"""The sampled in-production identity audit: the port of
``batch_scheduler_tpu/utils/health.py``'s ``IdentityAuditor``.

For the port this is the kernel-against-plain check running while the
scheduler runs: a batch served by the CUDA scan kernel is re-executed by
the plain serial scan on the CPU (the ``cpu-ladder`` replay rung) and the
plan digests are compared bit for bit.

Still to come (ROADMAP Queue 1 item 7b): the SLO ``HealthModel`` with its
``note_identity`` signal (``/debug/health``). Until then a mismatch is
counted, written to the audit ring as an ``identity_mismatch`` event, and
shown by ``IdentityAuditor.stats()``.
"""

from __future__ import annotations

import threading
from typing import Optional

from .metrics import DEFAULT_REGISTRY

__all__ = ["IdentityAuditor"]

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
        if audit_log is not None:
            try:
                audit_log.record_event(
                    "identity_mismatch", audit_id=audit_id,
                    expected=plan_digest, got=got, rung=_AUDIT_RUNG,
                )
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
