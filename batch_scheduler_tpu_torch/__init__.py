"""batch_scheduler_tpu_torch — the gang-admission batch on PyTorch and CUDA.

A port of ``batch_scheduler_tpu`` (the JAX reference, which stays beside
it unchanged) to PyTorch on an NVIDIA Hopper GPU. The port keeps the
reference's module paths where that helps a reader find the counterpart
(``ops/oracle.py`` <-> ``ops/oracle.py``), keeps its own copy of every
pure-Python module it needs, and imports nothing of the reference.

Layout:

- ``analysis``  the invariant gate (``python -m
             batch_scheduler_tpu_torch.analysis``: the ``guarded-by``,
             ``knobs``, ``wire`` and ``metrics`` checkers over this
             package) and the ``BST_LOCKCHECK=1`` runtime lock checker
- ``api``    PodGroup/Pod/Node data model, quantities, placement fit
- ``cache``  PodGroup status cache + TTL match caches
- ``core``   gang scheduling semantics (``ScheduleOperation``) and the
             batch scorer (``OracleScorer``)
- ``framework``  ``ClusterState``, the live node/pod view whose event
             hooks feed the scorer's O(churn) event fold, and whose
             ``pods_on`` gives the preemption planner its victims
- ``policy`` the policy engine: ``PolicyConfig`` (``BST_POLICY``) and
             ``PolicyEngine``, the affinity / anti-affinity / spread terms
             the policy scan composes into its selection key (the
             composite-key variant of the serial scan kernel), and the
             preemption planner (``plan_victims``, ``PreemptionPlanner``).
             To come: ``PolicyEngine.explain`` and the ``/debug/policy``
             view
- ``ops``    host packing (numpy: the full pack, the delta / snapshot-lite
             packer, the event log), the device-resident state and the
             device batch (torch), with the hand-written CUDA assignment
             scans in ``ops/assign_scan.py`` (sources ``csrc/``)
- ``sim``    scenario builders
- ``utils``  labels, TTL cache, errors, and the audit layer:
  - ``audit``    the audit ring (``AuditLog``: ``array`` and ``v2``
                 records; ``AuditReader`` with the v2 re-fold), the plan
                 and input digests, ``config_fingerprint``; the replay
                 rungs are ``core.oracle_scorer.replay_batch`` /
                 ``replay_audit_record``; a policy batch's record
                 carries its policy columns. To come: the
                 ``BST_AUDIT_FORMAT`` / ``BST_AUDIT_KEYFRAME_EVERY``
                 readers (with the CLI)
  - ``metrics``  the counter / gauge / histogram registry and its text
                 rendering; the batch path records the reference's batch
                 and refresh series there. To come: ``serve_metrics`` and
                 its HTTP surfaces
  - ``trace``    ``new_trace_id`` and ``current_context`` (always None).
                 To come: the span ring and the flight recorder
  - ``tenancy``  the capped tenant-label registry. To come: the
                 ``BST_TENANT_LABEL_MAX`` knob and ``batch_tenants``
  - ``health``   ``IdentityAuditor``, the sampled identity audit. To come:
                 the SLO ``HealthModel`` and its ``note_identity`` signal

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
a machine without CUDA the default device raises.
"""

__version__ = "0.1.0"

# BST_LOCKCHECK=1 arms the runtime lock-discipline checker
# (analysis/lockcheck.py): every class annotated `# guarded-by:` is
# instrumented so an unguarded cross-thread access raises with both
# stacks. A no-op (one env probe) when the knob is unset.
from .analysis.lockcheck import maybe_install as _lockcheck_maybe_install

_lockcheck_maybe_install()
del _lockcheck_maybe_install
