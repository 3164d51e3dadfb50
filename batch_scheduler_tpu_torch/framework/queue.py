"""Priority scheduling queue with a pluggable queue-sort comparator.

The active queue orders by the QueueSort plugin's Less (the reference's
Compare chain: priority -> group creation time -> name -> pod timestamp,
batchscheduler.go:214-216); unschedulable pods re-enter after per-pod
exponential backoff, promoted by a flusher thread.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Callable, Optional

from .types import PodInfo

__all__ = ["SchedulingQueue"]

LessFn = Callable[[PodInfo, PodInfo], bool]


class _Entry:
    __slots__ = ("info", "less", "dead", "group", "key", "in_heap")

    def __init__(
        self,
        info: PodInfo,
        less: LessFn,
        group: Optional[str] = None,
        key=None,
    ):
        self.info = info
        self.less = less
        self.dead = False  # lazily-deleted (drained as part of its gang)
        self.group = group
        # precomputed total-order key (plugin sort_key): heap comparisons
        # become tuple compares instead of two Less() attribute walks
        self.key = key
        self.in_heap = False  # heap-resident vs parked in a gang FIFO

    def __lt__(self, other: "_Entry") -> bool:
        if self.key is not None and other.key is not None:
            return self.key < other.key
        if self.less(self.info, other.info):
            return True
        if self.less(other.info, self.info):
            return False
        return self.info.seq < other.info.seq  # stable total order


class SchedulingQueue:
    def __init__(
        self,
        less_fn: Optional[LessFn] = None,
        backoff_base: float = 1.0,
        backoff_cap: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        group_key_fn: Optional[Callable[[PodInfo], Optional[str]]] = None,
        sort_key_fn: Optional[Callable[[PodInfo], tuple]] = None,
    ):
        self._less = less_fn or (lambda a, b: a.timestamp < b.timestamp)
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap
        self._clock = clock
        self._group_key = group_key_fn
        # when provided, entries carry a precomputed total-order key (one
        # plugin call per push) instead of paying O(log n) Less() chains
        # per heap operation
        self._sort_key = sort_key_fn
        self._cond = threading.Condition()
        self._active: list = []  # guarded-by: _cond
        self._active_dead = 0  # guarded-by: _cond
        self._live_active = 0  # guarded-by: _cond
        # gang-unit admission index: group key -> live active entries, so a
        # batch-planned gang's queued members drain in one cycle instead of
        # one heap pop + full comparator churn each (pop_group)
        self._groups: dict = {}  # guarded-by: _cond
        # Two-level gang queueing: the heap holds ONE resident entry per
        # (group, priority) bucket; later same-bucket arrivals park in a
        # FIFO and are promoted when the resident pops. Same-bucket pods
        # are mutually adjacent under the Compare chain (identical
        # priority/creation/name — only the queue timestamp differs), so
        # bucket-FIFO order matches the heap order they would have had,
        # and the ~quorum-1 members per gang skip the heap entirely (at
        # 10k pods that was most of the push cost). One deviation: a
        # backoff RE-entry re-parks at its bucket's FIFO tail even though
        # its original timestamp may precede a queued sibling's.
        self._fifos: dict = {}  # guarded-by: _cond
        self._heads: dict = {}  # guarded-by: _cond
        self._backoff: list = []  # heap of (ready_at, seq, PodInfo)
        self._closed = False
        self._flusher = threading.Thread(
            target=self._flush_loop, name="queue-backoff-flusher", daemon=True
        )
        self._flusher.start()

    def _push_active_locked(self, info: PodInfo) -> None:  # lock-held: _cond
        group = self._group_key(info) if self._group_key else None
        entry = _Entry(info, self._less, group)
        self._live_active += 1
        if group is not None:
            self._groups.setdefault(group, set()).add(entry)
            bucket = (group, info.priority)
            if bucket in self._heads:
                # a sibling is heap-resident: park (no heap op, no key)
                self._fifos.setdefault(bucket, deque()).append(entry)
                return
            self._heads[bucket] = entry
        self._heap_insert_locked(entry)

    def _heap_insert_locked(self, entry: _Entry) -> None:  # lock-held: _cond
        if self._sort_key is not None:
            # seq appended for a stable total order
            entry.key = (*self._sort_key(entry.info), entry.info.seq)
        entry.in_heap = True
        heapq.heappush(self._active, entry)

    def _promote_bucket_locked(self, entry: _Entry) -> None:  # lock-held: _cond
        """A gang bucket's heap-resident entry was popped (live or dead):
        promote its next live FIFO member into the heap."""
        bucket = (entry.group, entry.info.priority)
        if self._heads.get(bucket) is not entry:
            return
        fifo = self._fifos.get(bucket)
        while fifo:
            nxt = fifo.popleft()
            if not nxt.dead:
                self._heads[bucket] = nxt
                self._heap_insert_locked(nxt)
                return
        self._heads.pop(bucket, None)
        self._fifos.pop(bucket, None)

    def _drop_from_group_locked(self, entry: "_Entry") -> None:  # lock-held: _cond
        if entry.group is not None:
            bucket = self._groups.get(entry.group)
            if bucket is not None:
                bucket.discard(entry)
                if not bucket:
                    del self._groups[entry.group]

    def push(self, info: PodInfo) -> None:
        if not info.timestamp:
            info.timestamp = self._clock()
        with self._cond:
            self._push_active_locked(info)
            self._cond.notify()

    def group_size(self, group: str) -> int:
        """Live queued members of ``group`` — the gang-transaction quorum
        check (popped entries leave their bucket, so len is exact)."""
        with self._cond:
            bucket = self._groups.get(group)
            return len(bucket) if bucket else 0

    def pop_group(self, group: str) -> list:
        """Remove and return every queued member of ``group`` (arbitrary
        order — the caller admits them against an already-priority-ordered
        batch plan). Heap-resident entries are lazily deleted; FIFO-parked
        entries never touch the heap at all."""
        with self._cond:
            bucket = self._groups.pop(group, None)
            if not bucket:
                return []
            out = []
            for entry in bucket:
                if not entry.dead:
                    entry.dead = True
                    self._live_active -= 1
                    if entry.in_heap:
                        self._active_dead += 1
                    out.append(entry.info)
            return out

    def push_backoff(self, info: PodInfo) -> None:
        """Re-queue an unschedulable pod after exponential backoff."""
        info.attempts += 1
        delay = min(
            self._backoff_base * (2 ** (info.attempts - 1)), self._backoff_cap
        )
        with self._cond:
            heapq.heappush(
                self._backoff, (self._clock() + delay, info.seq, info)
            )

    def pop(self, timeout: Optional[float] = None) -> Optional[PodInfo]:
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                while not self._active:
                    if self._closed:
                        return None
                    wait = None
                    if deadline is not None:
                        wait = deadline - self._clock()
                        if wait <= 0:
                            return None
                    if self._backoff:
                        due = self._backoff[0][0] - self._clock()
                        wait = due if wait is None else min(wait, due)
                    if wait is not None and wait <= 0:
                        self._promote_locked()
                        continue
                    self._cond.wait(wait if wait is None else max(wait, 0.01))
                    self._promote_locked()
                entry = heapq.heappop(self._active)
                entry.in_heap = False
                if entry.group is not None:
                    # live or dead, the popped resident hands its bucket's
                    # heap slot to the next parked sibling
                    self._promote_bucket_locked(entry)
                if entry.dead:
                    self._active_dead -= 1
                    continue  # lazily-deleted (drained via pop_group)
                self._drop_from_group_locked(entry)
                self._live_active -= 1
                return entry.info

    def _promote_locked(self) -> None:
        now = self._clock()
        moved = False
        while self._backoff and self._backoff[0][0] <= now:
            _, _, info = heapq.heappop(self._backoff)
            self._push_active_locked(info)
            moved = True
        if moved:
            self._cond.notify_all()

    def _flush_loop(self) -> None:
        while not self._closed:
            time.sleep(0.05)
            with self._cond:
                self._promote_locked()

    def __len__(self) -> int:
        with self._cond:
            return self._live_active + len(self._backoff)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
