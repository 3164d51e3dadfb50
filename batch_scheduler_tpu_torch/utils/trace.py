"""Trace identifiers: the id minting of ``batch_scheduler_tpu/utils/trace.py``.

The audit log keys every record by an id of the trace-id kind (16
lowercase hex chars), so an audit record, its identity audit and, once
they are ported, its spans and flight-recorder decisions form one
evidence chain keyed by one kind of id.

Still to come (ROADMAP Queue 1 item 7b): the span ring, ``span`` and the
flight recorder. Until then no span is ever live, so ``current_context``
is always None and an audit record's ``trace_id`` is null, as it is in
the reference outside a span.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

__all__ = ["new_trace_id", "current_context"]


def new_trace_id() -> str:
    """16 lowercase hex chars (64 bits), collision-safe for a ring's
    lifetime. os.urandom avoids any seeded-PRNG correlation between
    processes."""
    return os.urandom(8).hex()


def current_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the innermost live span on this thread, or
    None. No span is live while the span ring is not ported."""
    return None
