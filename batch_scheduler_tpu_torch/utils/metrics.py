"""Metrics registry + Prometheus-text exposition: thread-safe counters,
gauges and histograms, each rendered in the Prometheus text format.

The port's copy of ``batch_scheduler_tpu/utils/metrics.py``'s registry
(``Counter``, ``Gauge``, ``Histogram``, ``Registry``,
``DEFAULT_REGISTRY`` and the rendering), so the same operations render
the same text in both packages. Components take a ``Registry`` or use the
process-wide ``DEFAULT_REGISTRY``: the audit log counts its records and
gauges its ring, the identity auditor counts its outcomes, and the
sidecar's server and clients (``service/``) count and time their
batches, retries and fallbacks under the reference's names.

``serve_metrics(registry)`` exposes ``/metrics`` and ``/healthz`` over a
small threaded HTTP endpoint, plus the reference's debug surfaces whose
modules the port has: ``/debug/trace`` (the span ring as Chrome-trace
JSON, utils.trace), ``/debug/decisions`` (the gang decision flight
recorder), ``/debug/gangs`` and ``/debug/events`` (the lifecycle ledger,
utils.lifecycle), ``/debug/health`` (the SLO health model, utils.health),
``/debug/policy`` (the active policy engine), ``/debug/explain`` and
``/debug/whatif`` (the gang observatory, core.explain) and
``/debug/capacity`` (the capacity observatory, ops.capacity),
``/debug/buckets`` (each bucket's kernel plans and bounds,
ops.oracle.bucket_cost_report, where the reference serves an XLA HLO
cost), ``/debug/perf`` (utils.profiler.perf_report), ``/debug/profile``
(a bounded ``torch.profiler`` capture) and ``/debug/drain`` (drains the
in-process sidecars). ``/debug/`` serves the index (``DEBUG_ENDPOINTS``).
Every reading handler reads a copy its owner takes under its own lock and
launches no device work; a ``/debug/explain`` or ``/debug/whatif`` query
runs its scans on the observatory's device, ``/debug/profile?seconds=N``
blocks its handler for the capture and ``/debug/drain?go=1`` drains.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_REGISTRY",
    "DEBUG_ENDPOINTS",
    "LONG_OP_BUCKETS",
    "serve_metrics",
]

# schedule-cycle / extension-point latencies live in the ms..s range
_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# for operations that can include a first build or a sidecar round-trip
# (seconds to minutes): the default buckets' 10 s ceiling would saturate
LONG_OP_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 20.0, 40.0, 80.0, 160.0, 320.0,
)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or a hostile/unlucky label value
    (a node name with a quote, a reason string with a newline) corrupts
    the whole exposition for every scraper."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    newline only (quotes are legal in HELP text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}  # guarded-by: _lock

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def values(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every labeled series, for readers that do not know the label
        values up front."""
        with self._lock:
            return dict(self._values)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
        for key, v in items:
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {v:g}")
        return "\n".join(lines)


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}  # guarded-by: _lock

    def set(self, v: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = float(v)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def values(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every labeled series, for readers that do not know the label
        values up front."""
        with self._lock:
            return dict(self._values)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
        for key, v in items:
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {v:g}")
        return "\n".join(lines)


class Histogram:
    def __init__(
        self, name: str, help_: str, buckets: Sequence[float] = _DEFAULT_BUCKETS
    ):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # label key -> (bucket counts, sum, count)
        self._series: Dict[Tuple[Tuple[str, str], ...], list] = {}  # guarded-by: _lock

    def observe(self, v: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = [[0] * len(self.buckets), 0.0, 0]
                self._series[key] = s
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[0][i] += 1
            s[1] += v
            s[2] += 1

    def snapshot(self, **labels: str) -> Tuple[list, float, int]:
        """(cumulative bucket counts, sum, count) — subtract two snapshots
        to scope quantiles/totals to a measurement window on the
        process-global registry (see quantile's ``since``)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return ([0] * len(self.buckets), 0.0, 0)
            return (list(s[0]), s[1], s[2])

    def snapshots(self) -> Dict[Tuple[Tuple[str, str], ...], Tuple[list, float, int]]:
        """Every labeled series' (bucket counts, sum, count) in one
        locked read, for readers that do not know the label values up
        front."""
        with self._lock:
            return {
                k: (list(s[0]), s[1], s[2]) for k, s in self._series.items()
            }

    def quantile(self, q: float, since=None, **labels: str) -> float:
        """Approximate quantile from the cumulative bucket counts (linear
        interpolation within the covering bucket — what Prometheus'
        histogram_quantile computes server-side). ``since`` (an earlier
        ``snapshot()``) restricts to observations after that point."""
        counts, _, total = self.snapshot(**labels)
        if since is not None:
            counts = [c - c0 for c, c0 in zip(counts, since[0])]
            total -= since[2]
        if total <= 0:
            return 0.0
        rank = q * total
        prev_count, prev_bound = 0, 0.0
        for i, b in enumerate(self.buckets):
            if counts[i] >= rank:
                span = counts[i] - prev_count
                frac = 1.0 if span <= 0 else (rank - prev_count) / span
                return prev_bound + (b - prev_bound) * frac
            prev_count, prev_bound = counts[i], b
        return self.buckets[-1]

    def time(self, **labels: str):
        """Context manager observing elapsed wall-clock seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()

    def count(self, **labels: str) -> int:
        with self._lock:
            s = self._series.get(tuple(sorted(labels.items())))
            return s[2] if s else 0

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(self._series.items())
        for key, (counts, total, n) in items:
            base = dict(key)
            for b, c in zip(self.buckets, counts):
                lines.append(
                    f"{self.name}_bucket{_fmt_labels({**base, 'le': f'{b:g}'})} {c}"
                )
            lines.append(
                f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} {n}"
            )
            lines.append(f"{self.name}_sum{_fmt_labels(base)} {total:g}")
            lines.append(f"{self.name}_count{_fmt_labels(base)} {n}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}  # guarded-by: _lock

    def _get_or_make(self, cls, name: str, help_: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m)}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help_)

    def histogram(
        self, name: str, help_: str = "", buckets: Sequence[float] = _DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_make(Histogram, name, help_, buckets=buckets)

    def get(self, name: str):
        """The registered metric under ``name`` (any kind), or None —
        read-only introspection that creates no series as a side
        effect."""
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return "\n".join(m.render() for m in metrics) + "\n"


DEFAULT_REGISTRY = Registry()


# The /debug/ index payload: one entry per surface this endpoint serves,
# in the reference's words. Kept as data so the index, the handler
# dispatch and the endpoint test cannot drift apart silently.
DEBUG_ENDPOINTS = {
    "/metrics": "Prometheus text exposition (every bst_* series)",
    "/healthz": "liveness",
    "/debug/": "this index",
    "/debug/trace": "the span ring as Chrome-trace JSON (utils.trace)",
    "/debug/decisions": "the gang decision flight recorder "
                        "(?gang=ns/name | ?tenant=T scope; ?limit=K caps "
                        "to the K most recently active gangs)",
    "/debug/gangs": "reconstructed gang lifecycle timelines "
                    "(utils.lifecycle): arrival->bind events with phase "
                    "decomposition and trace/audit cross-stamps; "
                    "?gang=ns/name | ?tenant=T | ?limit=K",
    "/debug/events": "the lifecycle event stream: ?since=CURSOR answers "
                     "occurrences newer than the monotonic cursor "
                     "(?limit=K, ?timeout_s=N long-polls) — push-shaped "
                     "gang events for external consumers",
    "/debug/health": "the live SLO health model (utils.health)",
    "/debug/buckets": "per-bucket kernel plans and bounds (ops.oracle)",
    "/debug/policy": "the active policy engine's terms/weights/counters",
    "/debug/perf": "rolling per-phase p50/p95, scan-rung mix, device "
                   "memory, device-resident state holders, compile "
                   "ledger (utils.profiler)",
    "/debug/profile": "?seconds=N runs a torch.profiler capture and "
                      "returns the trace dir; bare GET reports state",
    "/debug/explain": "?gang=NS/NAME structured denial breakdown for one "
                      "gang — deficits, binding lane, near-miss nodes, "
                      "preemption candidacy (core.explain)",
    "/debug/whatif": "score a counterfactual on a forked device-state "
                     "copy: ?drain=N | ?cordon=N | ?add_nodes=K | "
                     "?bump_gang=G&tier=T | ?remove_gang=G "
                     "(core.explain; docs/observability.md grammar)",
    "/debug/capacity": "the capacity observatory (ops.capacity): last "
                       "summary + the downsampled time series — per-lane "
                       "utilization/headroom spectra, fragmentation, "
                       "stranded capacity, seat tightness, tenant "
                       "shares; ?points=K trims the series",
    "/debug/drain": "?go=1 gracefully drains every in-process "
                    "OracleServer (stop admitting, finish the in-flight "
                    "window, flush ledgers; docs/resilience.md \"High "
                    "availability\") and answers the drain reports — the "
                    "HTTP face of SIGTERM, idempotent; bare GET reports "
                    "drain state only",
}


def _parse_limit(raw):
    """Shared ``?limit=K`` validation for the gang-scoped debug
    surfaces: None passes through (no cap); otherwise a non-negative
    int or a 400-able error string — a malformed limit must answer 400,
    never dump the unbounded payload."""
    if raw is None:
        return None, None
    try:
        limit = int(raw)
        if limit < 0:
            raise ValueError(raw)
    except (TypeError, ValueError):
        return None, f"malformed limit={raw!r}"
    return limit, None


def _profile_payload(raw) -> Tuple[dict, int]:
    """/debug/profile: without ``seconds`` the capture state; with a
    finite ``seconds`` one bounded capture; a malformed duration answers
    400 and runs nothing (it would block a handler and take the profiler)."""
    from . import profiler as profiler_mod

    if raw is None:
        return profiler_mod.profile_state(), 200
    try:
        seconds = float(raw)
        if not math.isfinite(seconds):
            raise ValueError(raw)
    except ValueError:
        return {"ok": False, "error": f"malformed seconds={raw!r}"}, 400
    return profiler_mod.capture_profile(seconds), 200


def _drain_payload(go) -> dict:
    """/debug/drain: ``?go=1`` drains every live in-process OracleServer
    and answers the reports (idempotent: a second call waits on the first
    drain and returns the same report); a bare GET only reports drain
    state. The process is not exited here."""
    from ..service.server import active_servers

    servers = active_servers()
    if go in ("1", "true", "yes"):
        return {"ok": True, "servers": len(servers),
                "reports": [srv.drain() for srv in servers]}
    return {"ok": True, "servers": len(servers),
            "draining": [srv.draining() for srv in servers]}


def _debug_payload(path: str, query: dict, registry=None) -> Tuple[object, int]:
    """(payload, HTTP status) of one JSON debug route — a JSON-able value,
    or bytes already encoded; (None, 404) for a path this endpoint does
    not serve. The owners' modules are imported here, on the first
    request: utils.metrics is imported by every layer below them."""
    first = {k: v[0] for k, v in query.items() if v}
    if path == "/debug/trace":
        from . import trace as trace_mod

        return trace_mod.DEFAULT_RECORDER.chrome_trace(), 200
    if path in ("/debug/decisions", "/debug/gangs"):
        limit, err = _parse_limit(first.get("limit"))
        if err is not None:
            return {"ok": False, "error": err}, 400
        gang, tenant = first.get("gang"), first.get("tenant")
        if path == "/debug/decisions":
            from . import trace as trace_mod

            return trace_mod.DEFAULT_FLIGHT_RECORDER.to_json(
                gang, tenant=tenant, limit=limit
            ), 200
        from . import lifecycle as lifecycle_mod

        return lifecycle_mod.DEFAULT_LEDGER.snapshot(
            gang=gang, tenant=tenant, limit=limit
        ), 200
    if path == "/debug/events":
        from . import lifecycle as lifecycle_mod

        try:
            since = int(first.get("since", "0"))
            limit = int(first.get("limit", "256"))
            timeout_s = float(first.get("timeout_s", "0"))
            if since < 0 or limit < 0 or not (timeout_s >= 0):
                raise ValueError("negative")
        except (TypeError, ValueError):
            return {
                "ok": False, "error": "malformed since=/limit=/timeout_s=",
            }, 400
        return lifecycle_mod.DEFAULT_LEDGER.events_since(
            since, limit=limit, timeout_s=timeout_s
        ), 200
    if path == "/debug/health":
        from . import health as health_mod

        return health_mod.DEFAULT_HEALTH.evaluate(), 200
    if path == "/debug/policy":
        from ..policy.engine import policy_debug_view

        return policy_debug_view(), 200
    if path == "/debug/explain":
        from ..core.explain import explain_debug_view

        return explain_debug_view(first.get("gang"))
    if path == "/debug/whatif":
        from ..core.explain import whatif_debug_view

        return whatif_debug_view(first)
    if path == "/debug/capacity":
        from ..ops.capacity import capacity_debug_view

        return capacity_debug_view(first)
    if path == "/debug/buckets":
        from ..ops.oracle import bucket_cost_report

        return bucket_cost_report(), 200
    if path == "/debug/perf":
        from . import profiler as profiler_mod

        return profiler_mod.perf_report(registry), 200
    if path == "/debug/profile":
        return _profile_payload(first.get("seconds"))
    if path == "/debug/drain":
        return _drain_payload(first.get("go", "0")), 200
    if path in ("/debug", "/debug/"):
        return {"endpoints": DEBUG_ENDPOINTS}, 200
    return None, 404


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: Registry = None

    def log_message(self, *args) -> None:
        pass

    def do_GET(self) -> None:
        url = urlparse(self.path)
        path = url.path
        if path == "/metrics":
            status = 200
            body = self.registry.render().encode()
            ctype = "text/plain; version=0.0.4"
        elif path == "/healthz":
            status, body, ctype = 200, b"ok\n", "text/plain"
        else:
            payload, status = _debug_payload(path, parse_qs(url.query), self.registry)
            if payload is None:
                self.send_response(404)
                self.end_headers()
                return
            body = (
                payload if isinstance(payload, bytes)
                else json.dumps(payload, default=str).encode()
            )
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve_metrics(
    registry: Optional[Registry] = None, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Expose /metrics, /healthz and the debug routes in a background
    thread; returns the server (``server.server_address`` has the bound
    port; stop it with ``shutdown()`` then ``server_close()``)."""
    handler = type(
        "BoundMetricsHandler",
        (_MetricsHandler,),
        {"registry": registry or DEFAULT_REGISTRY},
    )
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    threading.Thread(
        target=server.serve_forever, name="metrics-endpoint", daemon=True
    ).start()
    return server
