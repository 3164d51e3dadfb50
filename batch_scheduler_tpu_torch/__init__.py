"""batch_scheduler_tpu_torch — the gang-admission batch on PyTorch and CUDA.

A port of ``batch_scheduler_tpu`` (the JAX reference, which stays beside
it unchanged) to PyTorch on an NVIDIA Hopper GPU. The port keeps the
reference's module paths where that helps a reader find the counterpart
(``ops/oracle.py`` <-> ``ops/oracle.py``), keeps its own copy of every
pure-Python module it needs, and imports nothing of the reference.

Layout:

- ``api``    PodGroup/Pod/Node data model, quantities, placement fit
- ``cache``  PodGroup status cache + TTL match caches
- ``core``   gang scheduling semantics (``ScheduleOperation``) and the
             batch scorer (``OracleScorer``)
- ``framework``  ``ClusterState``, the live node/pod view whose event
             hooks feed the scorer's O(churn) event fold
- ``ops``    host packing (numpy: the full pack, the delta / snapshot-lite
             packer, the event log), the device-resident state and the
             device batch (torch), with the hand-written CUDA assignment
             scans in ``ops/assign_scan.py`` (sources ``csrc/``)
- ``sim``    scenario builders
- ``utils``  labels, TTL cache, errors

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
a machine without CUDA the default device raises.
"""

__version__ = "0.1.0"
