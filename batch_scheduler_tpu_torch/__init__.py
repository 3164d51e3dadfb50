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
- ``api``    PodGroup/Pod/Node data model, quantities, placement fit, the
             dict codec (``to_dict``, ``serde``) and the CRD constants
- ``cache``  PodGroup status cache + TTL match caches
- ``client`` the in-memory API server (watch events, the batched bind
             verb), the typed clientset and the shared informers
- ``controller``  the PodGroup controller (phase machine, GC horizon) on
             a rate-limited work queue
- ``core``   gang scheduling semantics (``ScheduleOperation``), the batch
             scorer (``OracleScorer``: blocking, coalesced, background and
             dispatch-ahead refreshes) and the explain / what-if
             observatory
- ``framework``  the scheduler loop (``Scheduler``: queue, the whole-gang
             fast lane, bind workers, the preemption commit),
             ``ClusterState`` (whose event hooks feed the scorer's O(churn)
             fold), the scheduling queue and the permit waits
- ``plugin`` the batch plugin, the extension-point gate, leases and the
             factory (``PluginConfig``, ``new_plugin_runtime``)
- ``policy`` the policy engine: ``PolicyConfig`` (``BST_POLICY``) and
             ``PolicyEngine``, the affinity / anti-affinity / spread terms
             the policy scan composes into its selection key, and the
             preemption planner (``plan_victims``, ``PreemptionPlanner``)
- ``ops``    host packing (numpy: the full pack, the delta / snapshot-lite
             packer, the event log), the device-resident state and the
             device batch (torch), with the hand-written CUDA assignment
             scans in ``ops/assign_scan.py`` (sources ``csrc/``)
- ``service`` the oracle sidecar (protocol, server with its executor and
             coalescer, clients, ``RemoteScorer``)
- ``sim``    ``SimCluster`` (the whole stack in process over a simulated
             kubelet) and scenario constructors
- ``utils``  labels, TTL cache, errors, JSON merge patches, work queues,
             and the audit ring, metrics registry, trace and flight
             recorder, lifecycle ledger, health model and tenancy

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
