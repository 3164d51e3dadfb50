"""Cardinality-capped tenant attribution: the port of
``batch_scheduler_tpu/utils/tenancy.py``'s process-wide label registry.

The one tenant identity every object already carries is its NAMESPACE (a
gang's full name is ``namespace/name``). :func:`tenant_label` makes it a
label with the cardinality discipline Prometheus requires: at most
``TENANT_LABEL_MAX`` distinct namespaces get their own label, first seen
first served, and everything beyond overflows into ``other``. First-seen
keeps a tenant's label stable for the process lifetime. The audit log
stamps each record's gangs per tenant label with it, and a remote scorer
announces its batch's dominant label on the wire (the TENANT frame).

:func:`set_batch_tenant` arms a thread's batch-tenant context: the
sidecar's device executor sets the tenant a connection announced around
each batch it collects, as the reference's does.

Still to come: the ``BST_TENANT_LABEL_MAX`` knob (with the CLI, ROADMAP
Queue 1 item 12; the cap is the reference's default until then), and the
per-batch ``batch_tenants`` mapping and the scan counters that read the
context (with the capacity observatory, item 9).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = [
    "OTHER_TENANT",
    "TENANT_LABEL_MAX",
    "tenant_label",
    "gang_namespace",
    "set_batch_tenant",
    "current_batch_tenant",
    "reset_registry",
]

OTHER_TENANT = "other"

# distinct tenant labels before overflow into OTHER_TENANT (the
# reference's default of BST_TENANT_LABEL_MAX)
TENANT_LABEL_MAX = 32

_registry_lock = threading.Lock()
# first-seen namespace -> its own label; beyond the cap, OTHER_TENANT
_registry: Dict[str, str] = {}  # guarded-by: _registry_lock

# the dominant tenant of the batch this thread is dispatching/collecting
_batch_ctx = threading.local()


def gang_namespace(full_name: str) -> str:
    """The namespace of a ``namespace/name`` gang key ("" when the key
    carries no namespace)."""
    ns, sep, _ = str(full_name).partition("/")
    return ns if sep else ""


def tenant_label(namespace: str) -> str:
    """The process-stable label for a namespace: itself while the
    registry has room, ``other`` beyond the cap. Empty namespaces (no
    tenant identity) answer "" so callers can skip the label."""
    ns = str(namespace)
    if not ns:
        return ""
    with _registry_lock:
        label = _registry.get(ns)
        if label is not None:
            return label
        label = ns if len(_registry) < TENANT_LABEL_MAX else OTHER_TENANT
        _registry[ns] = label
        return label


def set_batch_tenant(label: Optional[str]) -> None:
    """Arm (or clear, with None) this thread's dominant-tenant context for
    the batch it is about to run."""
    _batch_ctx.value = label


def current_batch_tenant() -> Optional[str]:
    return getattr(_batch_ctx, "value", None)


def reset_registry() -> None:
    """Forget every first-seen assignment (tests; a production process
    never resets — label stability is the point)."""
    with _registry_lock:
        _registry.clear()
