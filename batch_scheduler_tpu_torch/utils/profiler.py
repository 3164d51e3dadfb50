"""Continuous device profiler + perf ledger: where the nanoseconds and
the device bytes go. The port's copy of
``batch_scheduler_tpu/utils/profiler.py``, with the reference's XLA
surfaces replaced by their PyTorch and CUDA counterparts:

1. **On-demand ``torch.profiler`` capture** (``capture_profile``, served at
   ``/debug/profile?seconds=N`` on the metrics endpoint): a bounded
   capture of the CPU and, on a card, the CUDA activities (the kernels of
   every stream, whichever thread launched them), written as a Chrome
   trace into a capture directory, so "where did the batch spend its
   device time" is one curl away from a live sim or sidecar. One capture
   at a time (the profiler is process-global); old captures are pruned
   oldest-first. ``--profile-dir`` on ``sim``/``serve`` picks the
   directory (default: a per-process tmpdir).

2. **Device-memory telemetry** (``DeviceMemorySampler``): a daemon
   sampler reading the CUDA caching allocator (``torch.cuda.memory_stats``)
   and the card's capacity (``torch.cuda.mem_get_info``) into the
   ``bst_device_bytes_in_use`` / ``bst_device_peak_bytes`` /
   ``bst_device_bytes_limit`` gauges. A process asked for the CPU
   (``configure(device="cpu")``) has no device memory: the sampler finds
   nothing on its first pass and exits, the reference's CPU no-op.

3. **The compile ledger** (``CompileLedger``): the port compiles nothing
   per batch shape; its only compiles are the kernel libraries
   (``ops._build``), each built by ``nvcc`` or found in the build
   directory once per process. Each lands one entry (library, digest,
   seconds, built or cached), counted in ``bst_oracle_compiles_total`` and
   ``bst_compile_ledger_entries_total``, and is appended to a JSONL file
   in the build directory (``BST_COMPILE_LEDGER`` overrides the path;
   ``off`` disables persistence).

``perf_report()`` folds all three plus the live registry (rolling
p50/p95 per phase, scan-rung mix) and the device-resident state holders
into the ``/debug/perf`` payload (utils.metrics). Everything here is
telemetry: every failure degrades to "no data", never into a batch or a
request.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "configure",
    "capture_profile",
    "profile_state",
    "DeviceMemorySampler",
    "start_memory_sampler",
    "sample_device_memory",
    "CompileLedger",
    "COMPILE_LEDGER",
    "perf_report",
    "shutdown",
]

# Captures kept on disk before oldest-first pruning: each trace of a busy
# batch loop is megabytes, and the capture dir must stay bounded on a
# long-lived sidecar.
_KEEP_CAPTURES = 4

# Longest admissible /debug/profile capture: the handler thread blocks for
# the capture window, and an unbounded ?seconds= would let one curl wedge a
# handler (and the profiler) for hours.
_MAX_CAPTURE_S = 120.0

_state_lock = threading.Lock()
_profile_dir: List[Optional[str]] = [None]  # guarded-by: _state_lock
# the device this process was asked for: "cpu" makes the memory sampler a
# no-op and keeps the CUDA activities out of a capture
_device: List[Optional[str]] = [None]  # guarded-by: _state_lock
_capture_seq = [0]  # guarded-by: _state_lock
# the profiler is process-global: one capture at a time, and the busy
# flag must be readable without blocking behind a live capture
_capture_busy = [False]  # guarded-by: _state_lock
_last_capture: List[Optional[dict]] = [None]  # guarded-by: _state_lock
# set while NO capture is in flight: shutdown() waits on it
_capture_idle = threading.Event()
_capture_idle.set()
# set by shutdown(): refuses NEW captures (the daemon metrics server may
# outlive the CLI's teardown); configure() reopens
_closed = [False]  # guarded-by: _state_lock


def configure(profile_dir: Optional[str] = None, device: Optional[str] = None) -> None:
    """Set the capture directory (the ``--profile-dir`` flag; created lazily
    on first capture, None keeps the per-process tmpdir default) and the
    device the process runs on (the CLI's ``--device``)."""
    with _state_lock:
        _profile_dir[0] = profile_dir
        _device[0] = device
        _closed[0] = False


def _cuda_device():
    """The CUDA device this process runs on, or None: asked for the CPU,
    or no card."""
    import torch

    with _state_lock:
        want = _device[0]
    if want is not None and torch.device(want).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return torch.device(want or "cuda")


def _resolve_profile_dir() -> str:
    with _state_lock:
        d = _profile_dir[0]
    if not d:
        d = os.path.join(tempfile.gettempdir(), f"bst-profile-{os.getpid()}")
        with _state_lock:
            _profile_dir[0] = d
    os.makedirs(d, exist_ok=True)
    return d


def _prune_captures(base: str, keep: int = _KEEP_CAPTURES) -> None:
    """Oldest-first prune of capture subdirs so the dir stays bounded."""
    try:
        subdirs = sorted(
            e for e in os.listdir(base)
            if e.startswith("capture-") and os.path.isdir(os.path.join(base, e))
        )
        for name in subdirs[:-keep] if keep > 0 else subdirs:
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    except OSError:
        pass  # pruning is best-effort housekeeping


def profile_state() -> dict:
    """The /debug/profile GET-without-seconds view: capture dir, busy
    flag, and the last capture's summary."""
    with _state_lock:
        return {
            "profile_dir": _profile_dir[0],
            "busy": _capture_busy[0],
            "closed": _closed[0],
            "captures": _capture_seq[0],
            "last_capture": dict(_last_capture[0]) if _last_capture[0] else None,
        }


def capture_profile(seconds: float) -> dict:
    """Run one bounded ``torch.profiler`` capture and return its summary
    dict: ``{ok, trace_dir, trace, seconds, requested_seconds, files,
    events, cuda}`` or ``{ok: False, error}``. ``trace`` is the Chrome
    trace written into ``trace_dir``; ``cuda`` says whether the CUDA
    activities were traced.

    Blocks the calling thread for the capture window (the metrics endpoint
    serves each request on its own thread). A second concurrent request
    answers ``busy`` instead of corrupting the global profiler state."""
    seconds = float(seconds)
    if not math.isfinite(seconds):
        # NaN slips through min/max clamps and would reach time.sleep
        return {"ok": False, "error": f"invalid seconds={seconds!r}"}
    seconds = min(max(seconds, 0.05), _MAX_CAPTURE_S)
    with _state_lock:
        if _closed[0]:
            return {"ok": False, "error": "profiler shut down"}
        if _capture_busy[0]:
            return {"ok": False, "error": "capture already in progress"}
        _capture_busy[0] = True
        _capture_idle.clear()
        _capture_seq[0] += 1
        seq = _capture_seq[0]
    t0 = time.perf_counter()
    try:
        from torch.profiler import ProfilerActivity, profile

        cuda = _cuda_device() is not None
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        base = _resolve_profile_dir()
        trace_dir = os.path.join(base, f"capture-{seq:04d}")
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            time.sleep(seconds)
        trace = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(trace)
        events = len(prof.events())
        _prune_captures(base)
        n_files = sum(len(files) for _, _, files in os.walk(trace_dir))
        summary = {
            "ok": True,
            "trace_dir": trace_dir,
            "trace": trace,
            "seconds": round(time.perf_counter() - t0, 3),
            "requested_seconds": seconds,
            "files": n_files,
            "events": events,
            "cuda": cuda,
        }
    except Exception as e:  # noqa: BLE001 — telemetry, never a crash
        summary = {"ok": False, "error": repr(e)[:300]}
    finally:
        with _state_lock:
            _capture_busy[0] = False
            _last_capture[0] = summary
        _capture_idle.set()
    if summary.get("ok"):
        from .metrics import DEFAULT_REGISTRY

        DEFAULT_REGISTRY.counter(
            "bst_profile_captures_total",
            "On-demand torch.profiler captures served at /debug/profile",
        ).inc()
    return summary


# ---------------------------------------------------------------------------
# device-memory telemetry
# ---------------------------------------------------------------------------


def sample_device_memory() -> Optional[dict]:
    """One read of the CUDA caching allocator on this process's card:
    ``{bytes_in_use, peak_bytes_in_use, bytes_limit, free_bytes, devices}``,
    or None for a process asked for the CPU (or with no card). Costs two
    host calls, no device sync."""
    try:
        import torch

        dev = _cuda_device()
        if dev is None:
            return None
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "free_bytes": int(free),
            "devices": 1,
        }
    except Exception:  # noqa: BLE001 — telemetry only
        return None


class DeviceMemorySampler:
    """Daemon sampler feeding the device-memory gauges.

    Samples every ``interval_s`` (``BST_DEVICE_MEM_SAMPLE_S``, default 10).
    For a process asked for the CPU the first pass finds nothing and the
    thread exits (the documented no-op). ``stop()`` joins the thread."""

    def __init__(self, interval_s: Optional[float] = None, registry=None):
        if interval_s is None:
            try:
                interval_s = float(os.environ.get("BST_DEVICE_MEM_SAMPLE_S", "10"))
            except ValueError:
                interval_s = 10.0
        self.interval_s = max(interval_s, 0.5)
        self._registry = registry
        # gauges registered lazily on the first successful sample: a
        # registered-but-never-set gauge renders as 0, which would be
        # false telemetry for a CPU process ("absent on CPU")
        self._gauges = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="device-mem-sampler", daemon=True
        )
        self._thread.start()

    def sample_once(self) -> Optional[dict]:
        totals = sample_device_memory()
        if totals is None:
            return None
        if self._gauges is None:
            from .metrics import DEFAULT_REGISTRY

            reg = self._registry or DEFAULT_REGISTRY
            self._gauges = (
                reg.gauge(
                    "bst_device_bytes_in_use",
                    "Device bytes currently allocated by the CUDA caching "
                    "allocator (torch.cuda.memory_stats sampler; absent on "
                    "CPU)",
                ),
                reg.gauge(
                    "bst_device_peak_bytes",
                    "Peak device bytes allocated since process start",
                ),
                reg.gauge(
                    "bst_device_bytes_limit",
                    "Device memory capacity (torch.cuda.mem_get_info)",
                ),
            )
        in_use, peak, limit = self._gauges
        in_use.set(float(totals["bytes_in_use"]))
        peak.set(float(totals["peak_bytes_in_use"]))
        limit.set(float(totals["bytes_limit"]))
        return totals

    def _loop(self) -> None:
        if self.sample_once() is None:
            return  # CPU no-op: no stats now means no stats ever
        while not self._stop.wait(self.interval_s):
            if self.sample_once() is None:
                return

    def stop(self, timeout: float = 5.0) -> bool:
        self._stop.set()
        self._thread.join(timeout)
        return not self._thread.is_alive()


_sampler_lock = threading.Lock()
_sampler: List[Optional[DeviceMemorySampler]] = [None]  # guarded-by: _sampler_lock


def start_memory_sampler() -> DeviceMemorySampler:
    """Process-wide sampler singleton (sim and serve both call this at
    startup; the second call returns the live one)."""
    with _sampler_lock:
        if _sampler[0] is None:
            _sampler[0] = DeviceMemorySampler()
        return _sampler[0]


# ---------------------------------------------------------------------------
# the compile ledger
# ---------------------------------------------------------------------------


class CompileLedger:
    """Bounded in-memory ring + persistent JSONL of kernel-library builds
    and loads (``ops._build.library``): one entry per library a process
    gets, with its digest, the seconds it took and whether ``nvcc`` ran
    (``built``) or the build directory had it (cached). ``BST_COMPILE_LEDGER``
    overrides the JSONL path (``off``/``0`` disables persistence; the
    in-memory view and the counters keep working); the default is
    ``compile-ledger.jsonl`` in the build directory."""

    _MAX_ENTRIES = 512

    def __init__(self, path: Optional[str] = None, registry=None):
        self._lock = threading.Lock()
        self._entries: List[dict] = []  # guarded-by: _lock
        self._totals: Dict[str, dict] = {}  # guarded-by: _lock
        self._path = path
        self._path_resolved = False  # guarded-by: _lock
        self._registry = registry

    def _resolve_path(self) -> Optional[str]:
        """Env resolved lazily (tests swap it), once per ledger. Takes the
        lock itself — callers must NOT hold it."""
        with self._lock:
            if self._path_resolved:
                return self._path
            self._path_resolved = True
            if self._path is None:
                env = os.environ.get("BST_COMPILE_LEDGER", "").strip()
                if env.lower() in ("off", "0"):
                    self._path = None
                elif env:
                    self._path = env
                else:
                    from ..ops._build import BUILD_DIR

                    self._path = str(BUILD_DIR / "compile-ledger.jsonl")
            return self._path

    def record(self, library: str, digest: str, seconds: float, built: bool,
               **extra) -> dict:
        entry = {
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "library": str(library),
            "digest": str(digest),
            "built": bool(built),
            "seconds": round(float(seconds), 4),
        }
        entry.update(extra)
        path = self._resolve_path()
        with self._lock:
            self._entries.append(entry)
            del self._entries[:-self._MAX_ENTRIES]
            tot = self._totals.setdefault(
                entry["library"], {"builds": 0, "loads": 0, "seconds": 0.0}
            )
            tot["builds" if entry["built"] else "loads"] += 1
            tot["seconds"] = round(tot["seconds"] + entry["seconds"], 4)
        from .metrics import DEFAULT_REGISTRY

        reg = self._registry or DEFAULT_REGISTRY
        reg.counter(
            "bst_compile_ledger_entries_total",
            "Kernel-library builds and loads recorded by the compile "
            "ledger (one per library a process gets)",
        ).inc()
        reg.counter(
            "bst_oracle_compiles_total",
            "Kernel libraries a process built with nvcc or loaded from the "
            "build directory (the port compiles nothing per batch shape)",
        ).inc()
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
            except OSError:
                pass  # persistence is evidence, never the batch path
        return entry

    def report(self) -> dict:
        """Per-library totals + the recent entries — the /debug/perf
        payload."""
        with self._lock:
            totals = {k: dict(v) for k, v in sorted(self._totals.items())}
            recent = [dict(e) for e in self._entries[-16:]]
            path = self._path if self._path_resolved else None
        return {"totals": totals, "recent": recent, "jsonl": path}

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)


COMPILE_LEDGER = CompileLedger()


# ---------------------------------------------------------------------------
# /debug/perf
# ---------------------------------------------------------------------------

# The rolling-latency phases surfaced at /debug/perf: every histogram the
# serving paths observe into, client and sidecar side.
_PHASE_HISTOGRAMS = (
    "bst_oracle_pack_seconds",
    "bst_oracle_batch_seconds",
    "bst_oracle_device_seconds",
    "bst_oracle_server_batch_seconds",
    "bst_schedule_cycle_seconds",
)


def perf_report(registry=None) -> dict:
    """The /debug/perf payload: per-phase rolling p50/p95, the compile
    ledger, device-memory watermarks, the device-state holders, the audit
    rings and the scan-rung mix."""
    from .metrics import DEFAULT_REGISTRY, Histogram

    reg = registry or DEFAULT_REGISTRY
    phases: Dict[str, dict] = {}
    for name in _PHASE_HISTOGRAMS:
        h = reg.get(name)
        if not isinstance(h, Histogram):
            continue
        _, total, count = h.snapshot()
        if count == 0:
            continue
        phases[name] = {
            "count": count,
            "mean_s": round(total / count, 6),
            "p50_s": round(h.quantile(0.5), 6),
            "p95_s": round(h.quantile(0.95), 6),
        }
    scan_mix: Dict[str, float] = {}
    batches = reg.get("bst_scan_batches_total")
    values_fn = getattr(batches, "values", None)
    if callable(values_fn):
        # accumulate per path: the counter also carries a tenant label
        for key, v in values_fn().items():
            label = dict(key).get("path", "")
            if label:
                scan_mix[label] = scan_mix.get(label, 0.0) + v
    memory = sample_device_memory()
    try:
        from ..ops.device_state import device_state_report

        device_state = device_state_report()
    except Exception:  # noqa: BLE001 — reporting never fatal
        device_state = []
    try:
        from .audit import ring_stats

        audit_rings = ring_stats()
    except Exception:  # noqa: BLE001 — reporting never fatal
        audit_rings = []
    return {
        "phases": phases,
        "scan_rung_mix": scan_mix,
        "device_memory": memory,  # None for a CPU process
        "device_state": device_state,
        "audit": audit_rings,
        "compile_ledger": COMPILE_LEDGER.report(),
        "profiler": profile_state(),
    }


def shutdown(timeout: float = 30.0) -> bool:
    """Teardown hook: stop the memory sampler (if one was started) and wait
    out any in-flight /debug/profile capture. New captures are refused from
    here on; ``configure()`` reopens."""
    with _state_lock:
        _closed[0] = True
    ok = _capture_idle.wait(timeout)
    with _sampler_lock:
        sampler, _sampler[0] = _sampler[0], None
    if sampler is not None:
        ok = sampler.stop(min(timeout, 5.0)) and ok
    return ok
