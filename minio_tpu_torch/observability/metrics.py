"""The metrics registry, the port's copy of minio_tpu/observability/
metrics.py: counters, gauges and histograms with label sets, and their
Prometheus text exposition (MinIO's typed metric descriptors behind
/minio/v2/metrics/{cluster,node}, cmd/metrics-v2.go and
cmd/metrics-router.go). Histograms take the log-spaced latency buckets
of HISTOGRAM_BUCKETS.
"""

from __future__ import annotations

import threading
import time


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Metrics:
    """Thread-safe registry. Metric names follow prometheus conventions
    with the `mtpu_` namespace."""

    HISTOGRAM_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
    )

    def __init__(self, namespace: str = "mtpu"):
        self.namespace = namespace
        self._mu = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._hists: dict[str, dict[tuple, list]] = {}
        self._help: dict[str, str] = {}
        self.started = time.time()

    def describe(self, name: str, help_text: str):
        self._help[name] = help_text

    def inc(self, name: str, value: float = 1.0, **labels):
        with self._mu:
            series = self._counters.setdefault(name, {})
            key = _label_key(labels)
            series[key] = series.get(key, 0.0) + value

    def set_counter(self, name: str, value: float, **labels):
        """Absolute counter mirror: scrape-time collectors publish a
        subsystem's own monotonic totals (byte-flow ledger, pool
        stats) without double-counting across scrapes, and the series
        still renders with TYPE counter so rate() works."""
        with self._mu:
            self._counters.setdefault(name, {})[_label_key(labels)] = value

    def replace_counter_series(self, name: str, entries) -> None:
        """Atomically replace ALL label-sets of an absolute counter
        (`entries` = iterable of (labels dict, value)). Scrape-time
        mirrors of bounded sketches (the hot-bucket top-K) use this so
        evicted series DISAPPEAR from the exposition — Prometheus
        staleness handles the gap — instead of exporting frozen values
        forever and growing label cardinality past the sketch's bound."""
        with self._mu:
            self._counters[name] = {
                _label_key(labels): v for labels, v in entries
            }

    def replace_gauge_series(self, name: str, entries) -> None:
        """Gauge twin of replace_counter_series: scrape-time mirrors of
        rebuilt-from-scratch state (per-bucket histograms) drop series
        whose label-set vanished (bin emptied, bucket deleted) instead
        of exporting the last value forever."""
        with self._mu:
            self._gauges[name] = {
                _label_key(labels): v for labels, v in entries
            }

    def set_gauge(self, name: str, value: float, **labels):
        with self._mu:
            self._gauges.setdefault(name, {})[_label_key(labels)] = value

    def inc_gauge(self, name: str, delta: float = 1.0, **labels):
        """Additive gauge update (in-flight style up/down counters)."""
        with self._mu:
            series = self._gauges.setdefault(name, {})
            key = _label_key(labels)
            series[key] = series.get(key, 0.0) + delta

    def gauge(self, name: str, **labels) -> float:
        """Current gauge value (0.0 when the series never fired) — the
        read side the heal IO gate samples for in-flight requests."""
        with self._mu:
            return self._gauges.get(name, {}).get(_label_key(labels), 0.0)

    def observe(self, name: str, value: float, **labels):
        with self._mu:
            series = self._hists.setdefault(name, {})
            key = _label_key(labels)
            if key not in series:
                series[key] = [0] * (len(self.HISTOGRAM_BUCKETS) + 1) + [0.0, 0]
            h = series[key]
            for i, b in enumerate(self.HISTOGRAM_BUCKETS):
                if value <= b:
                    h[i] += 1
                    break
            else:
                h[len(self.HISTOGRAM_BUCKETS)] += 1
            h[-2] += value  # sum
            h[-1] += 1      # count

    def time(self, name: str, **labels):
        """Context manager observing elapsed seconds into a histogram."""
        metrics = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metrics.observe(
                    name, time.perf_counter() - self.t0, **labels
                )
                return False

        return _Timer()

    # --- snapshot / exposition ---

    def counter_value(self, name: str, **labels) -> float:
        with self._mu:
            return self._counters.get(name, {}).get(_label_key(labels), 0.0)

    def render_prometheus(self) -> str:
        """Prometheus text format v0.0.4."""
        ns = self.namespace
        out: list[str] = []

        def fmt_labels(key: tuple, extra: dict | None = None) -> str:
            items = list(key) + sorted((extra or {}).items())
            if not items:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in items)
            return "{" + inner + "}"

        with self._mu:
            for name, series in sorted(self._counters.items()):
                full = f"{ns}_{name}"
                if name in self._help:
                    out.append(f"# HELP {full} {self._help[name]}")
                out.append(f"# TYPE {full} counter")
                for key, v in sorted(series.items()):
                    out.append(f"{full}{fmt_labels(key)} {v}")
            for name, series in sorted(self._gauges.items()):
                full = f"{ns}_{name}"
                if name in self._help:
                    out.append(f"# HELP {full} {self._help[name]}")
                out.append(f"# TYPE {full} gauge")
                for key, v in sorted(series.items()):
                    out.append(f"{full}{fmt_labels(key)} {v}")
            for name, series in sorted(self._hists.items()):
                full = f"{ns}_{name}"
                out.append(f"# TYPE {full} histogram")
                for key, h in sorted(series.items()):
                    cum = 0
                    for i, b in enumerate(self.HISTOGRAM_BUCKETS):
                        cum += h[i]
                        out.append(
                            f"{full}_bucket{fmt_labels(key, {'le': b})} {cum}"
                        )
                    cum += h[len(self.HISTOGRAM_BUCKETS)]
                    out.append(
                        f"{full}_bucket{fmt_labels(key, {'le': '+Inf'})} {cum}"
                    )
                    out.append(f"{full}_sum{fmt_labels(key)} {h[-2]}")
                    out.append(f"{full}_count{fmt_labels(key)} {h[-1]}")
            out.append(f"# TYPE {ns}_uptime_seconds gauge")
            out.append(f"{ns}_uptime_seconds {time.time() - self.started}")
        return "\n".join(out) + "\n"
