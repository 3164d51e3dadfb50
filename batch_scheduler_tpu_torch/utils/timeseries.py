"""Bounded multi-resolution time series: hours of summaries, constant RAM.
The port of ``batch_scheduler_tpu/utils/timeseries.py``, copied whole (it
is pure Python).

The capacity observatory (ops.capacity) emits one summary dict per sampled
oracle batch. An operator question like "when did fragmentation start
climbing" needs HOURS of those, but an unbounded list is exactly the slow
leak the audit ring was built to avoid. This ring is the standard
multi-resolution answer (the RRDtool/Gorilla idea, reduced to stdlib): a
ladder of fixed-capacity levels where level 0 holds raw samples and each
overflow merges the two OLDEST level-``i`` entries into one level-``i+1``
entry spanning both. Recent history stays full-resolution; older history
degrades gracefully to averages; total memory is ``levels × capacity``
entries forever.

Coverage: with ``capacity=256, levels=6`` at one sample/second the ring
spans ``256 × (2^6 - 1) ≈ 4.5 hours``.

Merging is field-wise over the sample dicts: numeric fields average
(weighted by how many raw samples each entry already folded), ``*_max`` /
``*_min`` suffixed fields keep their extremum, equal-length numeric lists
merge elementwise, nested dicts recurse, and anything else keeps the
NEWER value. Downsampled entries carry ``merged`` (raw-sample count) and
``span_s`` so consumers can weight them correctly.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["DownsamplingRing"]

_DEFAULT_CAPACITY = 256
_DEFAULT_LEVELS = 6


def _merge_value(a, b, wa: int, wb: int, key: str = ""):
    """One field's merge (a older, b newer; wa/wb = raw-sample weights)."""
    num = (int, float)
    if isinstance(a, bool) or isinstance(b, bool):
        return b
    if isinstance(a, num) and isinstance(b, num):
        if key.endswith("_max"):
            return max(a, b)
        if key.endswith("_min"):
            return min(a, b)
        return (a * wa + b * wb) / (wa + wb)
    if isinstance(a, dict) and isinstance(b, dict):
        out = {}
        for k in set(a) | set(b):
            if k in a and k in b:
                out[k] = _merge_value(a[k], b[k], wa, wb, k)
            else:
                out[k] = b.get(k, a.get(k))
        return out
    if (
        isinstance(a, list)
        and isinstance(b, list)
        and len(a) == len(b)
        and all(isinstance(x, num) and not isinstance(x, bool) for x in a)
        and all(isinstance(x, num) and not isinstance(x, bool) for x in b)
    ):
        return [
            _merge_value(x, y, wa, wb, key) for x, y in zip(a, b)
        ]
    return b  # non-mergeable: the newer observation wins


class DownsamplingRing:
    """Thread-safe bounded multi-resolution ring of sample dicts.

    ``append(ts, sample)`` is O(1) amortized; ``series()`` returns the
    retained history oldest-first (coarse levels first, then raw), each
    entry ``{"ts", "span_s", "merged", "data"}``. Entries that overflow
    the TOP level are dropped oldest-first — the ring is bounded by
    construction, never by luck."""

    def __init__(
        self,
        capacity: int = _DEFAULT_CAPACITY,
        levels: int = _DEFAULT_LEVELS,
    ):
        self.capacity = max(2, int(capacity))
        self.levels = max(1, int(levels))
        self._lock = threading.Lock()
        # _levels[0] = raw samples, higher = coarser; each a list of
        # {"ts", "span_s", "merged", "data"} entries, oldest first
        self._levels: List[list] = [
            [] for _ in range(self.levels)
        ]  # guarded-by: _lock
        self.appended = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def append(self, ts: float, sample: Dict) -> None:
        entry = {
            "ts": float(ts), "span_s": 0.0, "merged": 1, "data": sample,
        }
        with self._lock:
            self.appended += 1
            self._levels[0].append(entry)
            for i in range(self.levels):
                if len(self._levels[i]) <= self.capacity:
                    break
                if i + 1 >= self.levels:
                    # top level full: drop the single oldest entry
                    self._levels[i].pop(0)
                    self.dropped += 1
                    break
                a = self._levels[i].pop(0)
                b = self._levels[i].pop(0)
                self._levels[i + 1].append(self._merge(a, b))

    @staticmethod
    def _merge(a: dict, b: dict) -> dict:
        wa, wb = a["merged"], b["merged"]
        return {
            "ts": a["ts"],  # an entry's ts is the span's START
            "span_s": round(
                (b["ts"] - a["ts"]) + b["span_s"], 6
            ),
            "merged": wa + wb,
            "data": _merge_value(a["data"], b["data"], wa, wb),
        }

    def series(self, max_points: Optional[int] = None) -> List[dict]:
        """Retained history, oldest-first (coarsest level leads). With
        ``max_points`` the OLDEST entries are trimmed — the recent
        full-resolution tail is what live debugging wants."""
        with self._lock:
            out: List[dict] = []
            for level in reversed(self._levels):
                out.extend(dict(e) for e in level)
        if max_points is not None and len(out) > max_points:
            out = out[-int(max_points):]
        return out

    def last(self) -> Optional[dict]:
        with self._lock:
            for level in self._levels:
                if level:
                    # the newest raw entry lives at level 0's tail; fall
                    # back to coarser tails if no raw samples survive
                    return dict(level[-1])
            return None

    def __len__(self) -> int:
        with self._lock:
            return sum(len(level) for level in self._levels)

    def stats(self) -> dict:
        with self._lock:
            return {
                "appended": self.appended,
                "dropped": self.dropped,
                "retained": sum(len(level) for level in self._levels),
                "capacity": self.capacity,
                "levels": self.levels,
            }

    def clear(self) -> None:
        with self._lock:
            for level in self._levels:
                level.clear()
            self.appended = 0
            self.dropped = 0
