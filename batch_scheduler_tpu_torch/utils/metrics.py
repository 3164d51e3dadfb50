"""Metrics registry + Prometheus-text exposition: thread-safe counters,
gauges and histograms, each rendered in the Prometheus text format.

The port's copy of ``batch_scheduler_tpu/utils/metrics.py``'s registry
(``Counter``, ``Gauge``, ``Histogram``, ``Registry``,
``DEFAULT_REGISTRY`` and the rendering), so the same operations render
the same text in both packages. Components take a ``Registry`` or use the
process-wide ``DEFAULT_REGISTRY``: the audit log counts its records and
gauges its ring, the identity auditor counts its outcomes, and the
sidecar's server and clients (``service/``) count and time their
batches, retries and fallbacks under the reference's names. Still to come
(ROADMAP Queue 1 item 7b): ``serve_metrics`` with its HTTP handler and
``/debug`` surfaces.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_REGISTRY",
    "LONG_OP_BUCKETS",
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
