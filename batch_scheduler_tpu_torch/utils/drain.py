"""Micro-batch queue draining shared by watch-stream consumers.

At tens of thousands of events per run the per-``get`` timeout machinery
is measurable; consumers take one blocking get, then drain
opportunistically up to a batch bound (which also caps how long a burst
keeps a consumer away from its stop-flag check).
"""

from __future__ import annotations

import queue as _queue
from typing import List, Optional

__all__ = ["drain_queue"]

DEFAULT_MAX_BATCH = 512


def drain_queue(
    q: "_queue.Queue",
    timeout: float,
    max_batch: int = DEFAULT_MAX_BATCH,
) -> Optional[List]:
    """One blocking get (``timeout`` seconds), then up to ``max_batch - 1``
    non-blocking gets. Returns None when the blocking get times out.

    A queue item that is itself a list (the API server's batched
    ``_notify_many`` fanout) is flattened transparently — consumers
    always see a flat event list. ``max_batch`` bounds the FLATTENED
    size: draining stops once the batch reaches it (the final item may
    overshoot by one producer chunk, ≤256 events), so a consumer's
    per-batch lock hold stays bounded under a 10k-event flood."""
    try:
        first = q.get(timeout=timeout)
    except _queue.Empty:
        return None
    batch = list(first) if isinstance(first, list) else [first]
    while len(batch) < max_batch:
        try:
            item = q.get_nowait()
        except _queue.Empty:
            break
        if isinstance(item, list):
            batch.extend(item)
        else:
            batch.append(item)
    return batch
