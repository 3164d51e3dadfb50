"""Cardinality-capped tenant attribution: the port of
``batch_scheduler_tpu/utils/tenancy.py``'s process-wide label registry.

The one tenant identity every object already carries is its NAMESPACE (a
gang's full name is ``namespace/name``). :func:`tenant_label` makes it a
label with the cardinality discipline Prometheus requires: at most
:func:`tenant_cap` distinct namespaces get their own label, first seen
first served, and everything beyond overflows into ``other``. First-seen
keeps a tenant's label stable for the process lifetime. The audit log
stamps each record's gangs per tenant label with it, and a remote scorer
announces its batch's dominant label on the wire (the TENANT frame).

:func:`batch_tenants` is the other mode, deliberately different: the
PER-BATCH deterministic mapping the capacity kernel (ops.capacity)
attributes shares with. Namespaces are ranked by (gang count desc, name
asc) within that one batch, the top :func:`tenant_cap` get indices and
the tail folds into ``other``. Determinism from the batch's own names is
what lets a recorded batch's capacity sample replay bit-identically, with
no process history involved.

:func:`set_batch_tenant` arms a thread's batch-tenant context: the
scorer sets its batch's dominant tenant around each batch, and the
sidecar's device executor sets the tenant a connection announced around
each batch it collects, as the reference's do; ``ops.oracle.collect_batch``
reads it into the scan counter's tenant label.

The cap is ``BST_TENANT_LABEL_MAX`` (default 32), read as the reference
reads it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "OTHER_TENANT",
    "tenant_cap",
    "tenant_label",
    "gang_namespace",
    "batch_tenants",
    "set_batch_tenant",
    "current_batch_tenant",
    "reset_registry",
]

OTHER_TENANT = "other"

_ENV = "BST_TENANT_LABEL_MAX"
_DEFAULT_CAP = 32

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


def tenant_cap() -> int:
    """Parse-guarded BST_TENANT_LABEL_MAX (the BST_SCAN_WAVE idiom): the
    maximum number of distinct tenant labels before overflow into
    ``other``. A typo'd knob keeps the default, never crashes."""
    raw = os.environ.get(_ENV, "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return _DEFAULT_CAP


def tenant_label(namespace: str) -> str:
    """The process-stable label for a namespace: itself while the
    registry has room, ``other`` beyond the cap. Empty namespaces (no
    tenant identity) answer "" so callers can skip the label."""
    ns = str(namespace)
    if not ns:
        return ""
    cap = tenant_cap()
    with _registry_lock:
        label = _registry.get(ns)
        if label is not None:
            return label
        label = ns if len(_registry) < cap else OTHER_TENANT
        _registry[ns] = label
        return label


def batch_tenants(
    group_names: Sequence[str], g_bucket: Optional[int] = None
) -> Tuple[np.ndarray, List[str]]:
    """Deterministic per-batch tenant mapping: ``(ids[g_bucket] int32,
    labels)`` where ``ids[g]`` indexes ``labels`` and ``labels[-1]`` is
    always ``other`` (the overflow bucket, also where padded rows and
    namespace-less gangs land — they carry zero demand, so the bucket
    stays honest). Ranking is (gang count desc, namespace asc) over THIS
    batch's names only, capped at :func:`tenant_cap` named tenants."""
    counts: Dict[str, int] = {}
    for name in group_names:
        ns = gang_namespace(name)
        if ns:
            counts[ns] = counts.get(ns, 0) + 1
    ranked = sorted(counts, key=lambda ns: (-counts[ns], ns))[: tenant_cap()]
    labels = ranked + [OTHER_TENANT]
    index = {ns: i for i, ns in enumerate(ranked)}
    other = len(labels) - 1
    g_bucket = len(group_names) if g_bucket is None else int(g_bucket)
    ids = np.full(g_bucket, other, dtype=np.int32)
    for g, name in enumerate(group_names[:g_bucket]):
        ids[g] = index.get(gang_namespace(name), other)
    return ids, labels


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
