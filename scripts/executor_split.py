"""Time the sidecar's device executor as built against a variant that
collects its batches on a second thread.

``service.server.DeviceExecutor`` (the reference's design) dispatches and
collects on one thread: with nothing queued it blocks in ``collect_batch``
on the oldest batch's event (outside the interpreter lock), so a request
that arrives meanwhile is dispatched only after that batch ends. The
variant here (``CollectorExecutor``) never blocks the issuing thread on
the card: it hands each dispatched batch to a collector thread, bounded by
the same window of 2. This script runs ``chip_smoke.py``'s ``sidecar`` and
``sidecar_wave`` phases (bench.py's deployment over the wire; their load
windows send 40 requests over one connection or over two at once, from
native clients, and profile the card's idle share) with each executor, in
turns (as built, variant, variant, as built).

Run on a machine with one CUDA card, from the repository root::

    python3 scripts/executor_split.py

It prints each phase's JSON line, then one summary line a run (the
executor, the phase, the median remote refresh on wire deltas and on full
snapshots, the local refresh, the server split, and each load window's
connections, requests a second and device idle share), then the card's
name and power limit; it exits non-zero if a phase fails.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from collections import deque
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
import batch_scheduler_tpu_torch.service.server as server_mod  # noqa: E402

BUILT = server_mod.DeviceExecutor


class CollectorExecutor(BUILT):
    """The executor with collection on its own thread: the issuing thread
    takes the next job as soon as a batch is dispatched (a semaphore keeps
    at most the executor's window of batches in flight); the collector
    finishes batches in dispatch order. Mirror updates and row gathers stay
    on the issuing thread's stream, as in the executor as built."""

    def __init__(self, device="cuda"):
        self._collect_q: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(server_mod._WINDOW)
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._collector.start()
        super().__init__(device)

    def _collect_loop(self) -> None:
        while True:
            item = self._collect_q.get()
            if item is None:
                return
            self._collect_oldest(deque([item]))
            self._slots.release()

    def _serve(self) -> None:
        while True:
            job = self._q.get()
            if job is server_mod._EXEC_STOP:
                self._collect_q.put(None)
                self._collector.join(60.0)
                while True:
                    try:
                        straggler = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if straggler is not server_mod._EXEC_STOP:
                        straggler.finish(error=RuntimeError("device executor stopped"))
            job.queue_wait = time.perf_counter() - job.enqueued
            if job.kind == "batch":
                self._slots.acquire()
                try:
                    pending = server_mod.dispatch_batch(
                        job.args, job.progress_args, device=self.device)
                except BaseException as e:  # noqa: BLE001 — to the waiter
                    self._slots.release()
                    job.finish(error=e)
                    continue
                self._collect_q.put((job, pending))
            else:
                t0 = time.perf_counter()
                try:
                    result = job.fn()
                except BaseException as e:  # noqa: BLE001 — to the waiter
                    job.finish(error=e)
                    continue
                job.run_seconds = time.perf_counter() - t0
                job.finish(result=result)


def main() -> int:
    if smoke.build() is None:
        return 1
    for variant in ("built", "collector", "collector", "built"):
        server_mod.DeviceExecutor = CollectorExecutor if variant == "collector" else BUILT
        for name in ("sidecar", "sidecar_wave"):
            results = {k: {"launches_by_path": {}} for k in smoke.KERNELS}
            rep = getattr(smoke, name)(results)
            if rep is None:
                return 1
            smoke.emit({
                "executor": variant, "phase": name,
                "remote_delta_refresh_ms_median": rep["remote_delta_refresh_ms_median"],
                "remote_full_refresh_ms_median": rep["remote_full_refresh_ms_median"],
                "local_refresh_ms_median": rep["local_refresh_ms_median"],
                "server_split_ms_median": rep["server_split_ms_median"],
                "load_windows": [
                    {k: w.get(k) for k in ("connections", "requests_per_s",
                                           "device_idle_share")}
                    for w in rep["load_windows"]
                ],
            })
    server_mod.DeviceExecutor = BUILT
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
