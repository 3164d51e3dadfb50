"""Interpreter-level deployment tuning for the scheduler runtime. The
port's copy of ``batch_scheduler_tpu/utils/runtime_tuning.py``.

The knobs the Go reference reaches through its runtime (GOMAXPROCS, the
GC's pacing) have CPython equivalents that matter at 10k-pod scale:

- GIL switch interval (set in cmd.main next to this module's callers):
  one compute-bound cycle thread beside ~25 mostly-idle service threads
  wastes measurable time on 5ms handoffs.
- Generational-GC thresholds (here): the drain allocates short-lived
  dicts/objects at ~10^6/s, and the default gen0 trigger (700
  allocations) fires ~1.3k collections across a 10k-pod arrival flood —
  ~0.25s of stop-every-thread pauses inside the measured second, and the
  dominant run-to-run variance source in ladder config 6. Raising the
  thresholds to 50k/100/100 cuts that to ~15 collections.
- gc.freeze() after warmup (here): startup objects (and the kernel
  libraries' loaders) are permanent for a long-running scheduler;
  freezing moves them out of every future generational scan (the
  standard CPython server recipe).

Shared by the CLI runtime (cmd.main ``sim``/``serve``) and
``chip_smoke.py``'s config 6 window, so the measured framework is the
deployed framework.
"""

from __future__ import annotations

import gc
import logging
import os

__all__ = ["apply_gc_tuning", "freeze_startup"]

_DEFAULT = (50000, 100, 100)


def apply_gc_tuning() -> None:
    """Set scheduler-runtime GC thresholds. ``BST_GC_THRESHOLD`` overrides
    as "gen0,gen1,gen2"; "0" keeps the interpreter defaults."""
    raw = os.environ.get("BST_GC_THRESHOLD", "")
    if raw.strip() == "0":
        return
    thresholds = _DEFAULT
    if raw:
        try:
            parts = tuple(int(p) for p in raw.split(","))
            if len(parts) != 3 or any(p <= 0 for p in parts):
                raise ValueError(raw)
            thresholds = parts
        except ValueError:
            logging.warning(
                "ignoring malformed BST_GC_THRESHOLD=%r; using %s",
                raw,
                _DEFAULT,
            )
    gc.set_threshold(*thresholds)


def freeze_startup() -> None:
    """Collect once, then freeze: everything alive at the end of startup
    (config, informers, loaded kernel libraries) leaves the GC's working
    set."""
    gc.collect()
    gc.freeze()
