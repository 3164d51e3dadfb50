"""JSON merge patch (RFC 7386) create/apply.

The reference persists every status transition to the API server as a merge
patch computed from (original, modified) object pairs
(reference pkg/util/k8s.go:34-48 and call sites core.go:346-351,
controller.go:293-301, batchscheduler.go:278-287). This module provides the
same create-from-diff plus the apply side used by the in-memory API server.
"""

from __future__ import annotations

from typing import Any

__all__ = ["create_merge_patch", "apply_merge_patch", "json_deepcopy"]


def json_deepcopy(o: Any) -> Any:
    """Deep-copy a JSON tree (dict/list/scalars) ~10x faster than
    ``copy.deepcopy``: no memo table, no reduce protocol — the API server's
    stores only ever hold ``to_dict`` output, so exact-type dispatch is
    sound. Tuples (possible in hand-built test fixtures) normalise to lists,
    matching what a JSON round-trip would do."""
    t = type(o)
    if t is dict:
        return {k: json_deepcopy(v) for k, v in o.items()}
    if t is list or t is tuple:
        return [json_deepcopy(v) for v in o]
    return o


def create_merge_patch(original: Any, modified: Any) -> dict:
    """Diff two JSON-able documents into an RFC 7386 merge patch.

    Keys removed in ``modified`` appear as ``None``; nested dicts diff
    recursively; any other changed value (including lists) is replaced
    wholesale, matching evanphx/json-patch's CreateMergePatch.
    """
    if not isinstance(original, dict) or not isinstance(modified, dict):
        raise TypeError("merge patch requires dict documents at the top level")
    patch: dict = {}
    for key, new_val in modified.items():
        if key not in original:
            patch[key] = new_val
            continue
        old_val = original[key]
        if isinstance(old_val, dict) and isinstance(new_val, dict):
            sub = create_merge_patch(old_val, new_val)
            if sub:
                patch[key] = sub
        elif old_val != new_val:
            patch[key] = new_val
    for key in original:
        if key not in modified:
            patch[key] = None
    return patch


def apply_merge_patch(doc: Any, patch: Any) -> Any:
    """Apply an RFC 7386 merge patch, returning a new document."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(doc, dict):
        doc = {}
    result = dict(doc)
    for key, val in patch.items():
        if val is None:
            result.pop(key, None)
        else:
            result[key] = apply_merge_patch(result.get(key), val)
    return result
